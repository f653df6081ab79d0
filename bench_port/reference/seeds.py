"""Seed derivation, a frozen copy of the program's `derive_seeds`
(`disvae_tpu_torch/utils/helpers.py`): the Trainer draws its training
noise from the first seed this gives, so the reference draws the same."""

import numpy as np


def derive_seeds(seed, n):
    """`n` independent non-negative seeds derived from `seed`."""
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint64)
            >> np.uint64(1)]
