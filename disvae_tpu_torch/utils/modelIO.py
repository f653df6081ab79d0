"""Model persistence: `model.pt` (reference state-dict layout) + `specs.json`.

Counterpart of disvae_tpu/utils/modelIO.py:46-128. Checkpoints are
metadata-driven (img_size / latent_dim / model_type are read back from
specs.json). `load_model` also reads the JAX package's `model.npz` through
utils/torch_compat.py, and the JAX package reads this `model.pt` through its
own converter, so checkpoints cross both ways.
"""

import json
import os
import re

import numpy as np
import torch

from disvae_tpu_torch.utils.torch_compat import from_jax_params

MODEL_FILENAME = "model.pt"
JAX_MODEL_FILENAME = "model.npz"
META_FILENAME = "specs.json"


def save_model(model, directory, metadata=None, filename=MODEL_FILENAME):
    """Save the state dict + metadata. Without metadata, store the minimum
    needed to rebuild (img_size, latent_dim, model_type) MERGED into any
    existing specs.json, so a mid-training checkpoint never erases the full
    resolved config a later eval needs (disvae_tpu modelIO.py:54-63)."""
    if metadata is None:
        metadata = dict(img_size=list(model.img_size),
                        latent_dim=model.latent_dim,
                        model_type=model.model_type)
        if os.path.exists(os.path.join(directory, META_FILENAME)):
            full = load_metadata(directory)
            full.update(metadata)
            metadata = full
        save_metadata(metadata, directory)
    elif filename == MODEL_FILENAME:
        save_metadata(metadata, directory)
    state_dict = {k: v.detach().cpu().contiguous()
                  for k, v in model.state_dict().items()}
    path = os.path.join(directory, filename)
    tmp = path + ".tmp"
    torch.save(state_dict, tmp)
    os.replace(tmp, path)


def save_metadata(metadata, directory, filename=META_FILENAME, **kwargs):
    path = os.path.join(directory, filename)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(metadata, f, indent=4, sort_keys=True, **kwargs)
    os.replace(tmp, path)


def load_metadata(directory, filename=META_FILENAME):
    with open(os.path.join(directory, filename)) as f:
        return json.load(f)


def _unflatten(flat):
    """`path/to/leaf` npz keys -> nested dict (disvae_tpu modelIO.py:35)."""
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_model(directory, filename=MODEL_FILENAME, device=None):
    """Rebuild the VAE (eval mode) from a results directory.

    Falls back to the JAX package's `model.npz` when `model.pt` is absent,
    and accepts an explicit .npz filename."""
    from disvae_tpu_torch.models.vae import init_specific_model

    metadata = load_metadata(directory)
    model = init_specific_model(metadata["model_type"],
                                tuple(metadata["img_size"]),
                                metadata["latent_dim"])
    path = os.path.join(directory, filename)
    if not os.path.exists(path) and filename == MODEL_FILENAME:
        alt = os.path.join(directory, JAX_MODEL_FILENAME)
        if os.path.exists(alt):
            path = alt
    if path.endswith(".npz"):
        with np.load(path) as data:
            state_dict = from_jax_params(
                _unflatten({k: data[k] for k in data.files}))
    else:
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state_dict)
    model.eval()
    return model.to(device) if device is not None else model


def load_checkpoints(directory, device=None):
    """Load every `model-<epoch>.{pt,npz}` checkpoint in a directory tree:
    [(epoch, model), ...] (disvae_tpu modelIO.py:115-128)."""
    checkpoints = []
    for root, _, filenames in os.walk(directory):
        for filename in filenames:
            # digits-only anchor: leftover temp files never match
            m = re.search(r"-(\d+)\.(npz|pt)$", filename)
            if m is not None:
                checkpoints.append((int(m.group(1)), load_model(
                    root, filename=filename, device=device)))
    return checkpoints
