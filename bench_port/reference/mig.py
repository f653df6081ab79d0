"""MIG and AAM over a full factor lattice, as the reference repository's
evaluator estimates them (disvae/evaluate.py), in float64.

q(z) is the mixture of the N posteriors of the encoded lattice. Its
entropy per latent is estimated from S = 10,000 of the posterior means,
drawn by `np.random.RandomState(seed)`: first the marginal sample, then
for each factor k each of its L_k slices in turn (the slices of factor k
hold the images whose k-th factor takes one value). The drawn (S, D)
samples are read as (D, S) by a row-major reshape, not a transpose, as
the reference does. H[z_d] = mean_s (log M - log sum_m N(v_s; mu_m,d,
var_m,d)); H[z_d | v_k] is the mean over the slices of the slices'
entropies; MIG and AAM follow from I = H[z] - H[z | v] on the host.
"""

import math

import numpy as np
import torch

N_SAMPLES = 10000
_LOG_2PI = math.log(2 * math.pi)
# elements of one (rows, samples, components) block of log-densities
_BLOCK = 1 << 26


def draws(seed, lat_sizes, n_samples=N_SAMPLES):
    """The sample indices: (the marginal's (S,), [each factor's (L, S)])."""
    n = int(np.prod(lat_sizes))
    rng = np.random.RandomState(seed)
    marginal = rng.permutation(n)[:min(n_samples, n)]
    factors = []
    for size in lat_sizes:
        m = n // int(size)
        factors.append(np.stack([rng.permutation(m)[:min(n_samples, m)]
                                 for _ in range(int(size))]))
    return marginal, factors


def log_mixture(values, mu, logvar):
    """log sum_m N(values[l, d, s]; mu[l, m, d], exp(logvar[l, m, d])) in
    float64, with the log-density written as a + b v + c v^2 per component
    and summed over blocks of components by logsumexp."""
    L, D, S = values.shape
    M = mu.shape[1]
    v = values.double().reshape(L * D, S)
    mu = mu.double().permute(0, 2, 1).reshape(L * D, M)
    lv = logvar.double().permute(0, 2, 1).reshape(L * D, M)
    inv = torch.exp(-lv)
    coef = torch.stack([-0.5 * (_LOG_2PI + lv + mu * mu * inv),
                        mu * inv, -0.5 * inv], 1)          # (LD, 3, M)
    powers = torch.stack([torch.ones_like(v), v, v * v], 2)  # (LD, S, 3)
    rows = max(1, min(L * D, _BLOCK // (S * min(M, 4096))))
    s_blk = max(1, min(S, _BLOCK // (rows * min(M, 4096))))
    m_blk = max(1, _BLOCK // (rows * s_blk))
    out = torch.empty((L * D, S), dtype=torch.float64, device=v.device)
    for r0 in range(0, L * D, rows):
        for s0 in range(0, S, s_blk):
            p = powers[r0:r0 + rows, s0:s0 + s_blk]
            acc = None
            for m0 in range(0, M, m_blk):
                ld = torch.bmm(p, coef[r0:r0 + rows, :, m0:m0 + m_blk])
                part = torch.logsumexp(ld, dim=2)
                acc = part if acc is None else torch.logaddexp(acc, part)
            out[r0:r0 + rows, s0:s0 + s_blk] = acc
    return out.reshape(L, D, S)


def _entropy(values, mu, logvar):
    """(L, D) entropies of L mixtures from their (L, D, S) sample values."""
    m = mu.shape[1]
    lq = log_mixture(values, mu, logvar)
    return (math.log(m) - lq).mean(dim=2).cpu().numpy()


def entropies(mu, logvar, lat_sizes, seed, n_samples=N_SAMPLES):
    """(H[z] (D,), H[z | v] (K, D)) of the encoded lattice, float64."""
    n, d = mu.shape
    marginal, factors = draws(seed, lat_sizes, n_samples)
    dev = mu.device
    sel = mu[torch.from_numpy(marginal).to(dev)]
    h_z = _entropy(sel.reshape(1, d, -1), mu[None], logvar[None])[0]
    lattice = np.arange(n).reshape([int(s) for s in lat_sizes])
    h_zv = np.zeros((len(lat_sizes), d))
    for k, size in enumerate(lat_sizes):
        flat = torch.from_numpy(np.moveaxis(lattice, k, 0)
                                .reshape(int(size), -1)).to(dev)
        idx = torch.from_numpy(factors[k]).to(dev)
        slices_mu, slices_lv = mu[flat], logvar[flat]      # (L, M, D)
        sel = torch.gather(slices_mu, 1,
                           idx[:, :, None].expand(-1, -1, d))
        h_zv[k] = _entropy(sel.reshape(int(size), d, -1), slices_mu,
                           slices_lv).mean(axis=0)
    return h_z, h_zv
