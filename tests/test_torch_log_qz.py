"""The port's log_qz (plain PyTorch version + CUDA-kernel wrapper) against
the JAX package's streaming logsumexp and its Pallas kernel.

Tolerance: 1e-4 absolute on log densities of magnitude ~1-10, the bound
tests/test_metrics.py holds JAX's own Pallas kernel to against its scan.
The implementations sum the M exponentials in different orders and chunk
sizes in float32.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.ops.pallas_kernels import log_qz as jax_log_qz_pallas
from disvae_tpu.train.evaluate import _streaming_log_qz

from disvae_tpu_torch.ops import log_qz as port
from log_qz_cases import log_qz_inputs as _inputs

ATOL = 1e-4


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
        port.build()


# ----------------------------------------------------------------------
# The CUDA kernel's algorithm (csrc/log_qz.cu), re-enacted in torch
# ----------------------------------------------------------------------

_LOG2PI = float(np.log(2 * np.pi))
_LOG2E = float(np.log2(np.e))
_FLAG_LOG2 = -100  # kFlagLog2


# name: (kind, (L, M, D, S), seed) of the inputs where a fixed per-(l, d)
# reference loses to an online max, at the CPU's size (kinds:
# tests/log_qz_cases.py). "benign": unit-scale posteriors. "ragged": M and
# S of no tile's size, S over two sample tiles.
EDGE_CASES = {"benign": ("unit", (1, 700, 3, 300), 0),
              "tight": ("tight", (2, 600, 3, 400), 5),
              "ragged": ("unit", (3, 1031, 2, 1100), 6),
              "far": ("far", (1, 500, 2, 64), 7)}


def _edge_inputs(name):
    kind, shape, seed = EDGE_CASES[name]
    return _inputs(seed, *shape, kind=kind)


def _tol(ref):
    """ATOL, plus two float32 roundings of the result (one ulp is 1.2e-4
    at |log q| ~ 1,250, the "far" case's scale; 2.4e-6 at ~10)."""
    return ATOL + 2 * np.finfo(np.float32).eps * np.abs(ref)


_CEPHES_EXP2 = (1.535336188319500e-4, 1.339887440266574e-3,
                9.618437357674640e-3, 5.550332471162809e-2,
                2.402264791363012e-1, 6.931472028550421e-1, 1.0)


def _ex2_fma(x):
    """The kernel's FMA-pipe 2^x (`ex2_fma`) in float32 torch, each fma as
    a multiply and an add: x clamped at -125, j = rint(x) by the 1.5 * 2^23
    trick, the polynomial in r = x - j, j added to the exponent bits."""
    x = torch.clamp(x, min=-125.0)
    t = x + 12582912.0
    r = x - (t - 12582912.0)
    p = torch.full_like(x, _CEPHES_EXP2[0])
    for c in _CEPHES_EXP2[1:]:
        p = p * r + c
    bits = (p.view(torch.int32).long()
            + (t.view(torch.int32).long() << 23)) & 0xFFFFFFFF
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).int().view(
        torch.float32)


def test_fma_exp2_matches_exp2():
    """ex2_fma against exp2 over [-125, 0]: relative error under 1e-6."""
    x = torch.linspace(-125, 0, 100001, dtype=torch.float32)
    ref = torch.exp2(x.double())
    rel = ((_ex2_fma(x).double() - ref) / ref).abs().max().item()
    assert rel <= 1e-6
    assert _ex2_fma(torch.tensor([-1e30, -float("inf")])).tolist() == [
        2.0 ** -125] * 2


def _reenact(values, mu, logvar, n_blocks):
    """csrc/log_qz.cu's arithmetic in float32 torch: G per (l, d); log2
    constants a, c; block b's chunk of the line of (segment, component)
    steps, one partial sum per segment piece (the first FMA_SAMPLES of each
    segment's samples through ex2_fma, the rest through exp2 with results
    under 2^-126 flushed to 0, as ftz does); the pieces summed in block
    order; sums under M * 2^-100 flagged and redone with an exact max.
    The scratch starts as NaN, so a piece no block wrote would reach the
    result. Returns (out, flagged flat indices)."""
    L, D, S = values.shape
    M = mu.shape[1]
    T = port.TILE_S
    n_stiles, chunk, pieces = port._plan(L, M, D, S, n_blocks)
    n_seg = L * D * n_stiles
    peak = -0.5 * (logvar + _LOG2PI)
    G = peak.amax(dim=1)                                    # (L, D)
    a = (-0.5 * _LOG2E) * torch.exp(-logvar)
    c = (peak - G[:, None]) * _LOG2E
    v_pad = torch.zeros((L, D, n_stiles * T))
    v_pad[..., :S] = values
    part = torch.full((n_seg, pieces, T), float("nan"))
    for b in range(n_blocks):
        q, q_end = b * chunk, min(n_seg * M, (b + 1) * chunk)
        while q < q_end:
            seg, m0 = divmod(q, M)
            m1 = min(M, m0 + q_end - q)
            row, st = divmod(seg, n_stiles)
            l, d = divmod(row, D)
            diff = v_pad[l, d, st * T:(st + 1) * T] - mu[l, m0:m1, d, None]
            x = diff * diff * a[l, m0:m1, d, None] + c[l, m0:m1, d, None]
            p = torch.exp2(x)
            p = torch.where(p < 2.0 ** -126, 0.0, p)
            p[:, :port.FMA_SAMPLES] = _ex2_fma(x[:, :port.FMA_SAMPLES])
            part[seg, b - seg * M // chunk] = p.sum(dim=0)
            q = seg * M + m1
    sums = torch.empty((n_seg, T))
    for seg in range(n_seg):
        n = (seg * M + M - 1) // chunk - seg * M // chunk + 1
        acc = torch.zeros(T)
        for j in range(n):
            acc = acc + part[seg, j]
        sums[seg] = acc
    sums = sums.reshape(L, D, n_stiles * T)[..., :S]
    out = torch.log(sums) + G[..., None]
    flagged = torch.nonzero((sums < M * 2.0 ** _FLAG_LOG2).flatten())[:, 0]
    flat = out.flatten()
    for i in flagged.tolist():
        l, rem = divmod(i, D * S)
        d, s = divmod(rem, S)
        diff = values[l, d, s] - mu[l, :, d]
        ld = -0.5 * ((_LOG2PI + logvar[l, :, d])
                     + diff * diff * torch.exp(-logvar[l, :, d]))
        mx = ld.max()
        flat[i] = torch.log(torch.exp(ld - mx).sum()) + mx
    return flat.reshape(L, D, S), flagged


@pytest.mark.parametrize("name", ["benign", "tight", "ragged", "far"])
@pytest.mark.parametrize("n_blocks", [1, 7])
def test_kernel_algorithm_matches_plain_and_pallas(name, n_blocks):
    """The re-enacted kernel against log_qz_plain and JAX's Pallas kernel
    (interpret mode, per L slice) within 1e-4 (+ two float32 roundings of
    the result); the far samples take the recompute path, every other
    case's sums stay above the flag threshold."""
    values, mu, logvar = _edge_inputs(name)
    v, m, lv = (torch.from_numpy(x) for x in (values, mu, logvar))
    got, flagged = _reenact(v, m, lv, n_blocks)
    assert flagged.numel() == (got.numel() if name == "far" else 0)
    plain = port.log_qz_plain(v, m, lv).numpy()
    assert np.all(np.abs(got.numpy() - plain) <= _tol(plain))
    pallas = np.stack([np.asarray(jax_log_qz_pallas(
        jnp.asarray(values[l]), jnp.asarray(mu[l]), jnp.asarray(logvar[l]),
        interpret=True)) for l in range(values.shape[0])])
    assert np.all(np.abs(got.numpy() - pallas) <= _tol(pallas))


@pytest.mark.parametrize("L, M, D, S, n_blocks", [
    (1, 737280, 10, 2000, 2112), (40, 18432, 10, 2000, 2112),
    (32, 23040, 10, 2000, 1188), (3, 5003, 10, 2001, 7),
    (2, 5, 3, 3000, 64), (1, 1, 1, 1, 2112)])
def test_kernel_plan_covers_each_step_once(L, M, D, S, n_blocks):
    """The persistent grid's split: each segment's M components are taken
    once, by consecutive blocks whose pieces are 0..n-1 (the merge's n),
    n <= pieces; no block takes more than `chunk` steps, so the one wave
    is balanced to one component."""
    n_stiles, chunk, pieces = port._plan(L, M, D, S, n_blocks)
    n_seg = L * D * n_stiles
    assert n_stiles == -(-S // port.TILE_S) and chunk * n_blocks >= n_seg * M
    seen = {}
    for b in range(n_blocks):
        q, q_end = b * chunk, min(n_seg * M, (b + 1) * chunk)
        while q < q_end:
            seg, m0 = divmod(q, M)
            m1 = min(M, m0 + q_end - q)
            seen.setdefault(seg, []).append((b - seg * M // chunk, m0, m1))
            q = seg * M + m1
    assert sorted(seen) == list(range(n_seg))
    for seg, got in seen.items():
        n = (seg * M + M - 1) // chunk - seg * M // chunk + 1
        assert [j for j, _, _ in got] == list(range(n)) and n <= pieces
        assert got[0][1] == 0 and got[-1][2] == M
        assert all(p[2] == q[1] for p, q in zip(got, got[1:]))


def test_kernel_algorithm_partials_cover_the_scratch_it_merges():
    """Every piece the merge reads was written (the scratch starts as NaN,
    so a piece no block wrote would reach the result)."""
    values, mu, logvar = _edge_inputs("ragged")
    got, _ = _reenact(*(torch.from_numpy(x)
                        for x in (values, mu, logvar)), 5)
    assert torch.isfinite(got).all()
