"""Host-side helpers: config parsing, seeding, run-directory lifecycle.

Copied from disvae_tpu/utils/helpers.py (numpy/stdlib only; importing it
from the JAX package would load JAX through disvae_tpu/__init__.py).
`set_seed` seeds numpy and `random` as the JAX package does and returns a
seeded `torch.Generator` in place of a JAX PRNG key; `derive_seeds` stands
in for splitting a key.
"""

import argparse
import ast
import configparser
import os
import random
import shutil

import numpy as np
import torch


def get_config_section(filenames, section):
    """Return a dict for one section of layered ``.ini`` files.

    Uses ``ExtendedInterpolation`` so values may cross-reference other
    sections (``${factor_dsprites:factor_G}``) and ``ast.literal_eval`` so
    values carry real Python types (ints, floats, strings, bools, lists).
    """
    parser = configparser.ConfigParser(
        interpolation=configparser.ExtendedInterpolation())
    parser.optionxform = str  # preserve case of keys
    read_ok = parser.read(filenames)
    if not read_ok:
        raise ValueError("Config files not found: {}".format(filenames))
    return {k: ast.literal_eval(v) for k, v in dict(parser[section]).items()}


def update_namespace_(namespace, dictionary):
    """In-place update of an argparse namespace from a dict."""
    vars(namespace).update(dictionary)


def create_safe_directory(directory, logger=None):
    """Create `directory`; if it exists, archive it to ``<directory>.zip``
    first."""
    if os.path.exists(directory):
        if logger is not None:
            logger.warning("Directory {} already exists. Archiving it to "
                           "{}.zip".format(directory, directory))
        shutil.make_archive(directory, "zip", directory)
        shutil.rmtree(directory)
    os.makedirs(directory)


def derive_seeds(seed, n):
    """`n` independent seeds derived from `seed` (fresh entropy when it is
    None): the port's counterpart of splitting a JAX PRNG key."""
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint64)
            >> np.uint64(1)]


def get_n_param(model):
    """Number of trainable parameters of an nn.Module."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def set_seed(seed, device="cpu"):
    """Seed host-side RNGs and return a seeded `torch.Generator` on
    `device` (None for an unseeded, stochastic run)."""
    if seed is None:
        return None
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


class FormatterNoDuplicate(argparse.ArgumentDefaultsHelpFormatter):
    """Help formatter that prints ``-e, --epoch EPOCH`` instead of repeating
    the metavar for every alias."""

    def _format_action_invocation(self, action):
        if not action.option_strings:
            default = self._get_default_metavar_for_positional(action)
            metavar, = self._metavar_formatter(action, default)(1)
            return metavar
        if action.nargs == 0:
            return ", ".join(action.option_strings)
        default = self._get_default_metavar_for_optional(action)
        args_string = self._format_args(action, default)
        return ", ".join(action.option_strings) + " " + args_string
