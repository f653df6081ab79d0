"""Inputs of K3 (`log_qz`), made from a numpy seed: one generator for its
CPU tests (tests/test_torch_log_qz.py), its tests on the card
(tests/test_torch_gpu.py) and chip_smoke.py's checks on the card. Imports
only numpy."""

import numpy as np

# name: (kind, (L, M, D, S), seed) of the edge inputs held on the card.
# "ragged": M and S of no tile's size, S over three sample tiles, L * D
# over one wave's segments.
CARD_EDGE_CASES = {
    "tight": ("tight", (2, 4000, 3, 1500), 5),
    "ragged": ("unit", (7, 3001, 10, 2049), 6),
    "far": ("far", (2, 3000, 4, 500), 7),
}


def log_qz_inputs(seed, L, M, D, S, kind="unit"):
    """(values (L, D, S), mu (L, M, D), logvar (L, M, D)), float32.

    "unit": unit-scale means and samples, logvar 0.3 N(0, 1). "tight":
    besides, logvar -20 in dimension 0 and -20 mixed with 0 in dimension 1
    (D >= 2), samples drawn from the mixture. "far": every sample 50 sigma
    from every component, so every term of its sum underflows a fixed
    per-(l, d) reference and the kernel recomputes every entry."""
    rng = np.random.RandomState(seed)
    mu = rng.randn(L, M, D).astype(np.float32)
    logvar = (0.3 * rng.randn(L, M, D)).astype(np.float32)
    values = rng.randn(L, D, S).astype(np.float32)
    if kind == "tight":
        logvar[:, :, 0] = -20 + 0.1 * rng.randn(L, M)
        logvar[:, ::2, 1] = -20
        pick = rng.randint(0, M, (L, S))
        mu_s = np.stack([mu[l, pick[l]].T for l in range(L)])
        sd_s = np.exp(0.5 * np.stack([logvar[l, pick[l]].T
                                      for l in range(L)]))
        values = (mu_s + sd_s * rng.randn(L, D, S)).astype(np.float32)
    elif kind == "far":
        reach = np.abs(mu).max() + 50 * np.exp(0.5 * logvar.max())
        values = (np.where(rng.rand(L, D, S) < 0.5, -1, 1)
                  * (reach + rng.rand(L, D, S))).astype(np.float32)
    elif kind != "unit":
        raise ValueError("log_qz_inputs: unknown kind {!r}".format(kind))
    return values, mu, logvar
