"""Gaussian log-density helpers and the MSS importance-weight matrix.

PyTorch counterparts of disvae_tpu/ops/math.py:16-47 (reference
disvae/utils/math.py:8-73). The padded-batch `_masked` variant waits for the
data-parallel slice.
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
