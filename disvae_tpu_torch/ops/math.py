"""Gaussian log-density helpers and the MSS importance-weight matrix.

PyTorch counterparts of disvae_tpu/ops/math.py:16-78 (reference
disvae/utils/math.py:8-73), including the `_masked` weights of a padded
batch.
"""

import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def log_density_gaussian(x, mu, logvar):
    """Elementwise diagonal-Gaussian log density; broadcasts like torch."""
    inv_var = torch.exp(-logvar)
    return -0.5 * (_LOG_2PI + logvar + (x - mu) ** 2 * inv_var)


def matrix_log_density_gaussian(x, mu, logvar):
    """All-pairs log densities: (B, D) inputs -> (B, B, D) where entry
    [i, j, d] = log N(x[i, d]; mu[j, d], var[j, d])."""
    return log_density_gaussian(x[:, None, :], mu[None, :, :],
                                logvar[None, :, :])


def log_importance_weight_matrix(batch_size, dataset_size,
                                 dtype=torch.float32, device=None):
    """Log weights for minibatch stratified sampling (Chen et al. 2018, eq.
    S6), with the reference's strided fill that writes COLUMNS, not the
    diagonal (disvae_tpu/ops/math.py:29-47 documents the layout):
    everything 1/M; column 0 = 1/N; column 1 = (N-M)/(N*M);
    corner [M-1, 0] = (N-M)/(N*M), with N = dataset_size, M = batch_size-1.
    """
    N = dataset_size
    M = batch_size - 1
    strat_weight = (N - M) / (N * M)
    W = torch.full((batch_size, batch_size), 1.0 / M, dtype=dtype,
                   device=device)
    W[:, 0] = 1.0 / N
    W[:, 1] = strat_weight
    W[M - 1, 0] = strat_weight
    return torch.log(W)


def log_importance_weight_matrix_masked(padded_size, n_valid, dataset_size,
                                        dtype=torch.float32, device=None):
    """MSS log-weights for a batch PADDED to `padded_size` whose first
    `n_valid` rows are real (disvae_tpu/ops/math.py:50-78, computed in
    `dtype` as there).

    Entries inside the valid block equal log_importance_weight_matrix
    built for batch_size == n_valid, including the reference's column fill
    quirk, while padded columns are -inf so the phantom mixture components
    vanish under the downstream logsumexp. Padded ROWS still produce
    values; callers exclude them from batch means.

    n_valid == 1 is UNDEFINED (M = 0 makes 1/M and strat_weight inf, and
    the (i == n_valid-2) corner never fires) and diverges from the
    unpadded path, which raises on a batch of one like the reference. The
    Trainer never feeds such a tail (Trainer._skip_tiny_tail); library
    callers must do the same.
    """
    N = torch.tensor(float(dataset_size), dtype=dtype, device=device)
    M = torch.tensor(float(n_valid), dtype=dtype, device=device) - 1.0
    strat_weight = (N - M) / (N * M)
    i = torch.arange(padded_size, device=device)[:, None]
    j = torch.arange(padded_size, device=device)[None, :]
    W = torch.full((padded_size, padded_size), 1.0, dtype=dtype,
                   device=device) / M
    W = torch.where(j == 0, 1.0 / N, W)
    W = torch.where(j == 1, strat_weight, W)
    W = torch.where((i == n_valid - 2) & (j == 0), strat_weight, W)
    return torch.where(j < n_valid, torch.log(W),
                       torch.tensor(-math.inf, dtype=dtype, device=device))
