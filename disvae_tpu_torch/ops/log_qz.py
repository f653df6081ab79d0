"""Gaussian-mixture log density of the MIG/AAM entropy sweep.

    log_qz(values, mu, logvar)[l, d, s]
        = logsumexp_m log N(values[l, d, s]; mu[l, m, d], exp(logvar[l, m, d]))

values (L, D, S), mu/logvar (L, M, D), all float32; the -log M mixture
normalisation is the caller's. The marginal sweep is L = 1; the conditional
sweeps batch the L slices of one factor.

Counterpart of the Pallas kernel disvae_tpu/ops/pallas_kernels.py
(`_log_qz_kernel`, launched by `log_qz`) and of its XLA sibling
disvae_tpu/train/evaluate.py `_streaming_log_qz`. Three pieces live here:

* `log_qz_plain` — plain PyTorch: `_streaming_log_qz` with the L axis written
  out, an online logsumexp over component chunks as the JAX scan does;
* the hand-written CUDA kernel in `disvae_tpu_torch/csrc/log_qz.cu` (its
  header says what bounds it on Hopper and what the design does about it),
  built with nvcc into a plain-C shared library at first use and loaded with
  ctypes (ops/cuda_build.py);
* `log_qz` — the wrapper. It takes the plain version only for CPU tensors.
  For CUDA tensors it launches the kernel or raises; nothing falls back.
  `log_qz.launches` counts its kernel launches.

`log_qz_fast` is the `--fast-metrics` estimator, the counterpart of
disvae_tpu/ops/pallas_kernels.py `log_qz_mxu` (XLA ops there, stock
PyTorch ops here, no kernel of its own).
"""

import ctypes
import math

import torch

from disvae_tpu_torch.ops import cuda_build
from disvae_tpu_torch.ops.math import log_density_gaussian

# Component chunk of the plain version's (L, chunk, D, S) density brick, as
# in the JAX evaluator (evaluate.py _COMP_CHUNK, scaled down with L).
_COMP_CHUNK = 2048

_NAME = "log_qz"
_LOG2PI = math.log(2 * math.pi)


def log_qz_plain(values, mu, logvar, comp_chunk=None):
    """Plain PyTorch log_qz: online logsumexp over component chunks.
    Same contract as `log_qz`; ragged chunks need no padding here."""
    L, D, S = values.shape
    M = mu.shape[1]
    if comp_chunk is None:
        comp_chunk = max(256, _COMP_CHUNK // L)
    run_max = torch.full((L, D, S), -math.inf, dtype=values.dtype,
                         device=values.device)
    run_sum = torch.zeros_like(run_max)
    v = values[:, None, :, :]                          # (L, 1, D, S)
    for m0 in range(0, M, comp_chunk):
        cmu = mu[:, m0:m0 + comp_chunk, :, None]       # (L, C, D, 1)
        clv = logvar[:, m0:m0 + comp_chunk, :, None]
        ld = log_density_gaussian(v, cmu, clv)         # (L, C, D, S)
        new_max = torch.maximum(run_max, ld.amax(dim=1))
        run_sum = (run_sum * torch.exp(run_max - new_max)
                   + torch.exp(ld - new_max[:, None]).sum(dim=1))
        run_max = new_max
    return torch.log(run_sum) + run_max


def log_qz_fast(values, mu, logvar, chunk=None):
    """Approximate log_qz with bf16 products, for exploratory sweeps.

    The Gaussian log density is quadratic in the value: ld[l, m, d, s] =
    A[l, m, d, :] . [v^2, v, 1][l, d, :, s], a batched (chunk, 3) @ (3, S)
    product per component chunk. Both operands are rounded to bf16 and
    upcast, and the product is taken in float32 (the products of bf16
    values are exact in float32, so this is a bf16 matmul with float32
    accumulation, on every device and precision policy). The exp-sum runs
    in float32 without an online max: each slice's log densities are
    bounded by G = max -0.5 * (logvar + log 2pi), so exp(ld - G) <= 1.
    M is padded to a multiple of `chunk` (by default the JAX evaluator's:
    8192 for L = 1, else max(256, 2048 // L)); padded components get a
    constant term of -inf.

    Error: rounding both operands to bf16 (unit roundoff u = 2^-8) moves
    each component's log density by at most (2u + u^2) sum_k |A_k F_k|,
    and a logsumexp by at most the largest such move, so at (l, d, s) the
    error is below (2^-7 + 2^-16) max_m sum_k |A[l, m, d, k] F[l, d, k, s]|
    plus float32 rounding. That is about 2e-2 at unit-scale inputs (the
    JAX docstring's figure) and grows with v^2 / var: tight posteriors
    make the terms large while their sum stays small. A value whose every
    component underflows exp (ld - G < -87) gives -inf. The exact
    `log_qz` is what parity gates use.
    """
    L, D, S = values.shape
    M = mu.shape[1]
    if chunk is None:
        chunk = 8192 if L == 1 else max(256, _COMP_CHUNK // L)
    invvar = torch.exp(-logvar)
    peak = -0.5 * (logvar + _LOG2PI)
    G = peak.amax(dim=(1, 2))                                   # (L,)
    c0 = peak - 0.5 * mu ** 2 * invvar - G[:, None, None]
    A = torch.stack([-0.5 * invvar, mu * invvar, c0], dim=-1)   # (L, M, D, 3)
    pad = (-M) % chunk
    if pad:
        fill = torch.zeros((L, pad, D, 3), dtype=A.dtype, device=A.device)
        fill[..., 2] = -math.inf
        A = torch.cat([A, fill], dim=1)
    # (L*D, M', 3) and (L*D, 3, S): batch over (l, d)
    A = A.permute(0, 2, 1, 3).reshape(L * D, M + pad, 3)
    F = torch.stack([values ** 2, values, torch.ones_like(values)], dim=2)
    A = A.to(torch.bfloat16).float()
    F = F.reshape(L * D, 3, S).to(torch.bfloat16).float()
    acc = torch.zeros((L * D, S), dtype=torch.float32, device=values.device)
    for m0 in range(0, M + pad, chunk):
        ld = torch.bmm(A[:, m0:m0 + chunk], F)                  # (L*D, C, S)
        acc += torch.exp(ld).sum(dim=1)
    return (torch.log(acc) + G.repeat_interleave(D)[:, None]).reshape(L, D, S)


def build():
    """Compile csrc/log_qz.cu (ops/cuda_build.py). Returns (path, compiler
    output); the output is empty when nothing was compiled."""
    return cuda_build.build(_NAME)


def _declare(lib):
    lib.disvae_log_qz_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.disvae_log_qz_f32.restype = ctypes.c_int
    lib.disvae_log_qz_n_split.argtypes = [ctypes.c_int] * 5
    lib.disvae_log_qz_n_split.restype = ctypes.c_int


def _check(values, mu, logvar):
    for name, t in (("values", values), ("mu", mu), ("logvar", logvar)):
        if t.device != values.device:
            raise ValueError("log_qz: {} is on {}, values on {}".format(
                name, t.device, values.device))
        if t.dtype != torch.float32:
            raise TypeError("log_qz: {} must be float32, got {}".format(
                name, t.dtype))
        if t.dim() != 3:
            raise ValueError("log_qz: {} must be 3-d, got shape {}".format(
                name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("log_qz: {} must be contiguous".format(name))
    L, D, S = values.shape
    if mu.shape != logvar.shape or mu.shape[0] != L or mu.shape[2] != D:
        raise ValueError(
            "log_qz: shapes values {}, mu {}, logvar {} do not fit "
            "(L, D, S), (L, M, D), (L, M, D)".format(
                tuple(values.shape), tuple(mu.shape), tuple(logvar.shape)))
    M = mu.shape[1]
    if min(L, D, S, M) < 1:
        raise ValueError("log_qz: empty operand")
    return L, M, D, S


def log_qz(values, mu, logvar):
    """(L, D, S) logsumexp over the M components of mu/logvar (L, M, D).
    CPU tensors take `log_qz_plain`; CUDA tensors launch the kernel."""
    L, M, D, S = _check(values, mu, logvar)
    if values.device.type == "cpu":
        return log_qz_plain(values, mu, logvar)
    if values.device.type != "cuda":
        raise ValueError("log_qz: no kernel for device {}".format(
            values.device))
    if L * D > 65535 or L * D * S >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError("log_qz: (L, M, D, S) = {} exceeds the launch "
                         "geometry".format((L, M, D, S)))
    lib = cuda_build.library(_NAME, _declare)
    with torch.cuda.device(values.device):
        sm_count = torch.cuda.get_device_properties(
            values.device).multi_processor_count
        n_split = lib.disvae_log_qz_n_split(L, M, D, S, sm_count)
        out = torch.empty((L, D, S), dtype=torch.float32,
                          device=values.device)
        part = torch.empty((2, n_split, L, D, S), dtype=torch.float32,
                           device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.disvae_log_qz_f32(
            values.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            out.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            L, M, D, S, n_split, stream)
    cuda_build.check(lib, err, "log_qz")
    log_qz.launches += 1
    return out


log_qz.launches = 0
