"""GroupNorm -> SiLU -> bf16 rounding, forward and backward, as one
hand-written kernel K5 (`disvae_tpu_torch/csrc/group_norm_silu.cu`; its
header says what bounds it on Hopper and what the design does about it).

It computes y = round_bf16(silu(group_norm(x, groups, weight, bias, eps)))
for NCHW float32 x: what AutoencoderKL's ResnetBlocks and `conv_norm_out`s
feed their next conv under the ``default`` numerics, already rounded to
the bf16 values the conv multiplies (ops/precision.py `conv2d(...,
rounded=True)` takes it as it is). The cotangent passes straight through
the rounding, as the conv's own backward passes it through its operand's.
It replaces no TPU kernel: PyTorch spends some 16 float32 passes over the
input on these three operations, K5 eight.

* `group_norm_silu(x, weight, bias, groups, eps)` — the autograd entry:
  CPU tensors take the plain version; CUDA tensors launch K5 or raise
  (float32, contiguous after `.contiguous()`, C divisible by groups).
  Autograd keeps x and each group's mean and rstd, not the pre-SiLU value.
* `group_norm_silu_fwd` / `group_norm_silu_bwd` — K5's two launches:
  (y, mean, rstd) from x, and (dx, dweight, dbias) from dy and what the
  forward kept. Each counts its calls in `.launches`, and in `.captured`
  those made while the stream captures a CUDA graph (they run once per
  replay of the graph, not at the call).
* `group_norm_silu_plain`, `group_norm_silu_fwd_plain`,
  `group_norm_silu_bwd_plain` — the plain PyTorch versions of the same
  arithmetic: the forward is PyTorch's own group norm, SiLU and rounding
  (bit for bit `round_bf16(F.silu(F.group_norm(...)))`); the backward
  sums da = dy silu'(a) and da x^ per (n, c), then folds them into
  dweight, dbias and dx as the kernel does.
"""

import ctypes

import torch
import torch.nn.functional as F

from disvae_tpu_torch.ops import cuda_build
from disvae_tpu_torch.ops.precision import round_bf16

_NAME = "group_norm_silu"
# kl-f8's GroupNorm eps (models/autoencoder_kl.py NORM_EPS)
EPS = 1e-6


def build():
    """Compile csrc/group_norm_silu.cu (ops/cuda_build.py). Returns (path,
    compiler output); the output is empty when nothing was compiled."""
    return cuda_build.build(_NAME)


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.disvae_group_norm_silu_chunks.argtypes = [i]
    lib.disvae_group_norm_silu_chunks.restype = i
    lib.disvae_group_norm_silu_fwd.argtypes = [p] * 7 + [i] * 4 + [f, p]
    lib.disvae_group_norm_silu_fwd.restype = i
    lib.disvae_group_norm_silu_bwd.argtypes = [p] * 11 + [i] * 4 + [p]
    lib.disvae_group_norm_silu_bwd.restype = i


def _check(x, weight, bias, groups):
    """(N, C, H * W) of NCHW x with per-channel weight and bias."""
    if x.dim() != 4:
        raise ValueError("group_norm_silu: x must be (N, C, H, W), got "
                         "{}".format(tuple(x.shape)))
    n, c, h, w = x.shape
    if groups < 1 or c % groups:
        raise ValueError("group_norm_silu: {} channels do not split into {} "
                         "groups".format(c, groups))
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError("group_norm_silu: weight and bias must be ({},), "
                         "got {} and {}".format(c, tuple(weight.shape),
                                                tuple(bias.shape)))
    return n, c, h * w


def _check_kernel(x, weight, bias, groups):
    n, c, hw = _check(x, weight, bias, groups)
    if x.device.type != "cuda":
        raise ValueError("group_norm_silu: no kernel for device {}".format(
            x.device))
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError("group_norm_silu: {} must be float32, got "
                            "{}".format(name, t.dtype))
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("group_norm_silu: {} must be contiguous on "
                             "x's device".format(name))
    # int offsets of the launch; a group's count exact in float32
    if x.numel() >= 2 ** 31 or c // groups * hw > 2 ** 24 or x.numel() == 0:
        raise ValueError("group_norm_silu: (N, C, H * W) = {} exceeds the "
                         "launch geometry".format((n, c, hw)))
    return n, c, hw


def _lib():
    return cuda_build.library(_NAME, _declare)


def group_norm_silu_fwd(x, weight, bias, groups, eps=EPS):
    """K5's forward on CUDA float32 x (N, C, H, W), contiguous: y (N, C, H,
    W) float32 holding bf16 values, and mean and rstd (N, groups)."""
    n, c, hw = _check_kernel(x, weight, bias, groups)
    lib = _lib()
    with torch.cuda.device(x.device):
        chunks = lib.disvae_group_norm_silu_chunks(hw)
        part = torch.empty(3 * n * c * chunks, dtype=torch.float32,
                           device=x.device)
        y = torch.empty_like(x)
        mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.disvae_group_norm_silu_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            part.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            n, c, hw, c // groups, eps, stream)
    cuda_build.check(lib, err, "group_norm_silu_fwd")
    group_norm_silu_fwd.launches += 1
    group_norm_silu_fwd.captured += torch.cuda.is_current_stream_capturing()
    return y, mean, rstd


def group_norm_silu_bwd(dy, x, weight, bias, mean, rstd):
    """K5's backward: (dx, dweight, dbias) float32 from the cotangent dy of
    y and the forward's x, mean and rstd, all contiguous on the card."""
    n, c, hw = _check_kernel(x, weight, bias, mean.shape[1])
    for name, t in (("dy", dy), ("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError("group_norm_silu_bwd: {} must be contiguous "
                             "float32 on x's device".format(name))
    if dy.shape != x.shape or mean.shape != rstd.shape \
            or mean.shape[0] != n:
        raise ValueError("group_norm_silu_bwd: dy {}, mean {}, rstd {} do "
                         "not fit x {}".format(
                             tuple(dy.shape), tuple(mean.shape),
                             tuple(rstd.shape), tuple(x.shape)))
    groups = mean.shape[1]
    lib = _lib()
    with torch.cuda.device(x.device):
        chunks = lib.disvae_group_norm_silu_chunks(hw)
        part = torch.empty(2 * n * c * chunks, dtype=torch.float32,
                           device=x.device)
        coef = torch.empty(2 * n * groups, dtype=torch.float32,
                           device=x.device)
        dx = torch.empty_like(x)
        dweight = torch.empty_like(weight)
        dbias = torch.empty_like(bias)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.disvae_group_norm_silu_bwd(
            dy.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
            coef.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), n, c, hw, c // groups, stream)
    cuda_build.check(lib, err, "group_norm_silu_bwd")
    group_norm_silu_bwd.launches += 1
    group_norm_silu_bwd.captured += torch.cuda.is_current_stream_capturing()
    return dx, dweight, dbias


group_norm_silu_fwd.launches = group_norm_silu_fwd.captured = 0
group_norm_silu_bwd.launches = group_norm_silu_bwd.captured = 0


def group_norm_silu_fwd_plain(x, weight, bias, groups, eps=EPS):
    """Plain K5 forward: PyTorch's group norm (its mean and rstd kept),
    SiLU and the rounding to bf16 values."""
    n, c, hw = _check(x, weight, bias, groups)
    a, mean, rstd = torch.ops.aten.native_group_norm(
        x, weight, bias, n, c, hw, groups, eps)
    return round_bf16(F.silu(a)), mean, rstd


def group_norm_silu_bwd_plain(dy, x, weight, bias, mean, rstd):
    """Plain K5 backward: the pre-SiLU a = x scale + shift again, da = dy
    silu'(a), its sums and those of da x^ per (n, c), and from them
    dbias, dweight and dx = rstd (weight da - (A + x^ B) / L) with A and B
    each group's weight-weighted sums and L its element count."""
    n, c, hw = _check(x, weight, bias, mean.shape[1])
    groups = mean.shape[1]

    def per_c(t):  # (n, groups) -> (n, c, 1, 1)
        return t.repeat_interleave(c // groups, dim=1).view(n, c, 1, 1)
    mu, rs = per_c(mean), per_c(rstd)
    scale = weight.view(1, c, 1, 1) * rs
    a = x * scale + (bias.view(1, c, 1, 1) - mu * scale)
    sig = torch.sigmoid(a)
    da = dy * (sig * (1 + a * (1 - sig)))
    xhat = (x - mu) * rs
    sums = da.sum((2, 3))
    sums_x = (da * xhat).sum((2, 3))
    coef_a = (sums * weight).view(n, groups, -1).sum(-1)
    coef_b = (sums_x * weight).view(n, groups, -1).sum(-1)
    inv_l = 1.0 / (c // groups * hw)
    dx = rs * (weight.view(1, c, 1, 1) * da
               - (per_c(coef_a) + xhat * per_c(coef_b)) * inv_l)
    return dx, sums_x.sum(0), sums.sum(0)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, kernel):
        x = x.contiguous()
        fwd = group_norm_silu_fwd if kernel else group_norm_silu_fwd_plain
        y, mean, rstd = fwd(x, weight, bias, groups, eps)
        ctx.kernel = kernel
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        bwd = group_norm_silu_bwd if ctx.kernel else group_norm_silu_bwd_plain
        dx, dweight, dbias = bwd(dy.contiguous(), *ctx.saved_tensors)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None, None)


def group_norm_silu(x, weight, bias, groups, eps=EPS):
    """round_bf16(silu(group_norm(x))) with a straight-through rounding:
    K5 on CUDA tensors, the plain version on the CPU."""
    return _GroupNormSiLU.apply(x, weight, bias, groups, eps,
                                x.device.type == "cuda")


def group_norm_silu_plain(x, weight, bias, groups, eps=EPS):
    """The plain version of `group_norm_silu` on any device."""
    return _GroupNormSiLU.apply(x, weight, bias, groups, eps, False)
