"""The port's log_qz (plain PyTorch version + CUDA-kernel wrapper) against
the JAX package's streaming logsumexp and its Pallas kernel.

Tolerance: 1e-4 absolute on log densities of magnitude ~1-10, the bound
tests/test_metrics.py holds JAX's own Pallas kernel to against its scan.
The implementations sum the M exponentials in different orders and chunk
sizes in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.ops.pallas_kernels import log_qz as jax_log_qz_pallas
from disvae_tpu.train.evaluate import _streaming_log_qz

from disvae_tpu_torch.ops import log_qz as port

ATOL = 1e-4


def _inputs(seed, L, M, D, S):
    rng = np.random.RandomState(seed)
    mu = rng.randn(L, M, D).astype(np.float32)
    logvar = (0.3 * rng.randn(L, M, D)).astype(np.float32)
    values = rng.randn(L, D, S).astype(np.float32)
    return values, mu, logvar


def _port(values, mu, logvar):
    return port.log_qz(torch.from_numpy(values), torch.from_numpy(mu),
                       torch.from_numpy(logvar)).numpy()


def test_plain_matches_jax_streaming_and_pallas():
    """M=700, D=3, S=300: no size is a multiple of any block, so the ragged
    component chunk and the Pallas padding/masking are all exercised."""
    values, mu, logvar = _inputs(0, 1, 700, 3, 300)
    before = port.log_qz.launches
    got = _port(values, mu, logvar)[0]
    assert port.log_qz.launches == before  # CPU tensors launch nothing
    scan = np.asarray(_streaming_log_qz(jnp.asarray(values[0]),
                                        jnp.asarray(mu[0]),
                                        jnp.asarray(logvar[0])))
    pallas = np.asarray(jax_log_qz_pallas(jnp.asarray(values[0]),
                                          jnp.asarray(mu[0]),
                                          jnp.asarray(logvar[0]),
                                          interpret=True))
    assert got.shape == (3, 300)
    np.testing.assert_allclose(got, scan, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_batched_matches_vmapped_streaming():
    """The L-batched form (conditional sweeps) against jax.vmap of the
    scan with the evaluator's component chunk for that L."""
    L = 3
    values, mu, logvar = _inputs(1, L, 700, 3, 300)
    got = _port(values, mu, logvar)
    comp_chunk = max(256, 2048 // L)
    ref = np.asarray(jax.vmap(functools.partial(
        _streaming_log_qz, comp_chunk=comp_chunk))(
            jnp.asarray(values), jnp.asarray(mu), jnp.asarray(logvar)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("comp_chunk", [64, 700, 4096])
def test_plain_chunking_matches_direct_logsumexp(comp_chunk):
    """The online (max, sum) carry gives the one-shot logsumexp whatever
    the chunk: one ragged tail, one exact chunk, one chunk larger than M."""
    values, mu, logvar = _inputs(2, 2, 700, 3, 50)
    v, m, lv = (torch.from_numpy(a) for a in (values, mu, logvar))
    got = port.log_qz_plain(v, m, lv, comp_chunk=comp_chunk)
    ld = -0.5 * (np.log(2 * np.pi) + lv[:, :, :, None]
                 + (v[:, None] - m[:, :, :, None]) ** 2
                 * torch.exp(-lv[:, :, :, None]))        # (L, M, D, S)
    ref = torch.logsumexp(ld.double(), dim=1).float()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_refuses_operands_the_kernel_does_not_take(bad):
    values, mu, logvar = (torch.from_numpy(a)
                          for a in _inputs(3, 1, 40, 3, 20))
    if bad == "dtype":
        values = values.double()
    elif bad == "shape":
        mu = mu[:, :, :2].contiguous()
    elif bad == "contiguity":
        values = torch.from_numpy(np.ascontiguousarray(
            values.numpy().transpose(0, 2, 1))).transpose(1, 2)
    else:  # no kernel and no plain fallback for a non-CPU, non-CUDA device
        values, mu, logvar = (t.to("meta") for t in (values, mu, logvar))
    with pytest.raises((TypeError, ValueError)):
        port.log_qz(values, mu, logvar)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means no kernel: the build raises, it never falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        port._nvcc()
