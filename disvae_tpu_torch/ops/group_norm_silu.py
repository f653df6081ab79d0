"""GroupNorm -> SiLU -> bf16 rounding, forward and backward, as one
hand-written kernel K5 (`disvae_tpu_torch/csrc/group_norm_silu.cu`; its
header says what bounds it on Hopper and what the design does about it).

It computes y = round_bf16(silu(group_norm(x, groups, weight, bias, eps)))
for float32 x (N, C, H, W), NCHW or channels-last: what AutoencoderKL's
ResnetBlocks and `conv_norm_out`s feed their next conv under the
``default`` numerics, already rounded to the bf16 values the conv
multiplies (ops/precision.py `conv2d(..., rounded=True)` takes it as it
is). The cotangent passes straight through the rounding, as the conv's
own backward passes it through its operand's. It replaces no TPU kernel:
PyTorch spends some 16 float32 passes over the input on these three
operations, K5 eight, and five are compulsory.

K5 reads and writes the layout x comes in (`layout`): contiguous NCHW x
runs its NCHW kernels, channels-last x its NHWC kernels (a block owns a
run of pixels and all channels; a group's 4-16 contiguous channels are
one to four float4s), and y and dx come out in x's layout, so a
channels-last model stays so through K5 and cuDNN's NHWC convs take its
output with no transform. Any other x takes one copy to NCHW, counted
as `norm.k5_copy`, as is a backward whose dy needs one to reach the
forward's layout; `norm.k5_nhwc` counts the calls that ran channels-last
(both once a call, `utils/trace.py`).

* `group_norm_silu(x, weight, bias, groups, eps)` — the autograd entry:
  CPU tensors take the plain version; CUDA tensors launch K5 or raise
  (float32, C divisible by groups). Autograd keeps x itself (the copy
  where one was made) and each group's mean and rstd, not the pre-SiLU
  value.
* `group_norm_silu_fwd` / `group_norm_silu_bwd` — K5's two launches, in
  x's layout (NCHW, or channels-last where `layout` says the NHWC
  kernels take it): (y, mean, rstd) from x, and (dx, dweight, dbias) from
  dy and what the forward kept. Each counts its calls in `.launches`, and
  in `.captured` those made while the stream captures a CUDA graph (they
  run once per replay of the graph, not at the call).
* `group_norm_silu_plain`, `group_norm_silu_fwd_plain`,
  `group_norm_silu_bwd_plain` — the plain PyTorch versions of the same
  arithmetic, on an NCHW copy and returned in x's layout, so a
  channels-last call gives the NCHW call's values bit for bit: the
  forward is PyTorch's own group norm, SiLU and rounding (bit for bit
  `round_bf16(F.silu(F.group_norm(...)))`); the backward sums da = dy
  silu'(a) and da x^ per (n, c), then folds them into dweight, dbias and
  dx as the kernels do.
"""

import ctypes

import torch
import torch.nn.functional as F

from disvae_tpu_torch.ops import cuda_build
from disvae_tpu_torch.ops.precision import round_bf16
from disvae_tpu_torch.utils.trace import count

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
    lib.disvae_group_norm_silu_nhwc_slices.argtypes = [i] * 4
    lib.disvae_group_norm_silu_nhwc_slices.restype = i
    lib.disvae_group_norm_silu_nhwc_fwd.argtypes = [p] * 7 + [i] * 4 + [f, p]
    lib.disvae_group_norm_silu_nhwc_fwd.restype = i
    lib.disvae_group_norm_silu_nhwc_bwd.argtypes = [p] * 12 + [i] * 4 + [p]
    lib.disvae_group_norm_silu_nhwc_bwd.restype = i


def nhwc_fits(channels, groups):
    """Whether K5's NHWC kernels take `channels` in `groups`: each group
    whole float4s (4, 8, ... 128 channels, a power of two times 4) and at
    most 1,024 channels (csrc/group_norm_silu.cu `nhwc_fits`)."""
    cpg = channels // groups
    return (channels % groups == 0 and cpg % 4 == 0 and cpg <= 128
            and (cpg // 4) & (cpg // 4 - 1) == 0 and channels <= 1024)


def layout(x, groups):
    """The layout K5 runs x (N, C, H, W) in as it lies: "nchw" for
    contiguous x, "nhwc" for channels-last x whose channels the NHWC
    kernels take (`nhwc_fits`, 16-byte aligned), None where x needs a copy
    first."""
    if x.is_contiguous():
        return "nchw"
    if x.dim() == 4 and _lies_in(x, "nhwc") and nhwc_fits(x.shape[1],
                                                          groups):
        return "nhwc"
    return None


def _lies_in(t, fmt):
    """Whether t lies as layout `fmt` needs (channels-last on 16 bytes for
    "nhwc")."""
    if fmt == "nhwc":
        return (t.is_contiguous(memory_format=torch.channels_last)
                and t.data_ptr() % 16 == 0)
    return t.is_contiguous()


def _laid_as(t, x):
    """t, an NCHW result, laid out as x: channels-last where x is so and
    not contiguous."""
    if x.is_contiguous() or not x.is_contiguous(
            memory_format=torch.channels_last):
        return t
    return t.contiguous(memory_format=torch.channels_last)


def _check(x, weight, bias, groups):
    """(N, C, H * W) of x (N, C, H, W) with per-channel weight and
    bias."""
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
    """(N, C, H * W) and K5's layout of x on the card."""
    n, c, hw = _check(x, weight, bias, groups)
    if x.device.type != "cuda":
        raise ValueError("group_norm_silu: no kernel for device {}".format(
            x.device))
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError("group_norm_silu: {} must be float32, got "
                            "{}".format(name, t.dtype))
        if t.device != x.device or (t is not x and not t.is_contiguous()):
            raise ValueError("group_norm_silu: {} must be contiguous on "
                             "x's device".format(name))
    fmt = layout(x, groups)
    if fmt is None:
        raise ValueError("group_norm_silu: x {} strided {} is neither "
                         "contiguous nor channels-last in groups the NHWC "
                         "kernels take".format(tuple(x.shape), x.stride()))
    # int offsets of the launch; a group's count exact in float32
    if x.numel() >= 2 ** 31 or c // groups * hw > 2 ** 24 or x.numel() == 0:
        raise ValueError("group_norm_silu: (N, C, H * W) = {} exceeds the "
                         "launch geometry".format((n, c, hw)))
    return n, c, hw, fmt


def _lib():
    return cuda_build.library(_NAME, _declare)


def group_norm_silu_fwd(x, weight, bias, groups, eps=EPS):
    """K5's forward on CUDA float32 x (N, C, H, W), contiguous or
    channels-last (`layout`): y float32 holding bf16 values in x's layout,
    and mean and rstd (N, groups)."""
    n, c, hw, fmt = _check_kernel(x, weight, bias, groups)
    lib = _lib()
    with torch.cuda.device(x.device):
        if fmt == "nhwc":
            slices = lib.disvae_group_norm_silu_nhwc_slices(n, c, hw,
                                                            c // groups)
            part, entry = 3 * n * slices * groups, \
                lib.disvae_group_norm_silu_nhwc_fwd
        else:
            part, entry = 3 * n * c * lib.disvae_group_norm_silu_chunks(hw), \
                lib.disvae_group_norm_silu_fwd
        part = torch.empty(part, dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            part.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            n, c, hw, c // groups, eps, stream)
    cuda_build.check(lib, err, "group_norm_silu_fwd")
    group_norm_silu_fwd.launches += 1
    group_norm_silu_fwd.captured += torch.cuda.is_current_stream_capturing()
    return y, mean, rstd


def group_norm_silu_bwd(dy, x, weight, bias, mean, rstd):
    """K5's backward: (dx, dweight, dbias) float32 from the cotangent dy of
    y and the forward's x, mean and rstd on the card; dy in x's layout
    (`layout`), dx returned in it."""
    n, c, hw, fmt = _check_kernel(x, weight, bias, mean.shape[1])
    for name, t in (("dy", dy), ("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("group_norm_silu_bwd: {} must be float32 on "
                             "x's device".format(name))
    if dy.shape != x.shape or mean.shape != rstd.shape \
            or mean.shape[0] != n:
        raise ValueError("group_norm_silu_bwd: dy {}, mean {}, rstd {} do "
                         "not fit x {}".format(
                             tuple(dy.shape), tuple(mean.shape),
                             tuple(rstd.shape), tuple(x.shape)))
    groups = mean.shape[1]
    if not (mean.is_contiguous() and rstd.is_contiguous()
            and _lies_in(dy, fmt)):
        raise ValueError("group_norm_silu_bwd: dy must lie as x does "
                         "({}), mean and rstd contiguous".format(fmt))
    lib = _lib()
    with torch.cuda.device(x.device):
        coef = torch.empty(2 * n * groups, dtype=torch.float32,
                           device=x.device)
        dx = torch.empty_like(x)
        dweight = torch.empty_like(weight)
        dbias = torch.empty_like(bias)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fmt == "nhwc":
            slices = lib.disvae_group_norm_silu_nhwc_slices(n, c, hw,
                                                            c // groups)
            part = torch.empty(2 * n * slices * c, dtype=torch.float32,
                               device=x.device)
            sums = torch.empty(2 * n * c, dtype=torch.float32,
                               device=x.device)
            err = lib.disvae_group_norm_silu_nhwc_bwd(
                dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                part.data_ptr(), sums.data_ptr(), coef.data_ptr(),
                dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), n, c,
                hw, c // groups, stream)
        else:
            chunks = lib.disvae_group_norm_silu_chunks(hw)
            part = torch.empty(2 * n * c * chunks, dtype=torch.float32,
                               device=x.device)
            err = lib.disvae_group_norm_silu_bwd(
                dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                part.data_ptr(), coef.data_ptr(), dx.data_ptr(),
                dweight.data_ptr(), dbias.data_ptr(), n, c, hw, c // groups,
                stream)
    cuda_build.check(lib, err, "group_norm_silu_bwd")
    group_norm_silu_bwd.launches += 1
    group_norm_silu_bwd.captured += torch.cuda.is_current_stream_capturing()
    return dx, dweight, dbias


group_norm_silu_fwd.launches = group_norm_silu_fwd.captured = 0
group_norm_silu_bwd.launches = group_norm_silu_bwd.captured = 0


def group_norm_silu_fwd_plain(x, weight, bias, groups, eps=EPS):
    """Plain K5 forward: PyTorch's group norm (its mean and rstd kept),
    SiLU and the rounding to bf16 values, on x's NCHW copy; y in x's
    layout."""
    n, c, hw = _check(x, weight, bias, groups)
    a, mean, rstd = torch.ops.aten.native_group_norm(
        x.contiguous(), weight, bias, n, c, hw, groups, eps)
    return _laid_as(round_bf16(F.silu(a)), x), mean, rstd


def group_norm_silu_bwd_plain(dy, x, weight, bias, mean, rstd):
    """Plain K5 backward: the pre-SiLU a = x scale + shift again, da = dy
    silu'(a), its sums and those of da x^ per (n, c), and from them
    dbias, dweight and dx = rstd (weight da - (A + x^ B) / L) with A and B
    each group's weight-weighted sums and L its element count."""
    n, c, hw = _check(x, weight, bias, mean.shape[1])
    groups = mean.shape[1]
    x_in, x, dy = x, x.contiguous(), dy.contiguous()

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
    return _laid_as(dx, x_in), sums_x.sum(0), sums.sum(0)


def _to_layout(t, fmt):
    """t as it lies where that is layout `fmt`, else its copy in `fmt`,
    counted as `norm.k5_copy`."""
    if _lies_in(t, fmt):
        return t
    count("norm.k5_copy")
    return t.clone(memory_format=torch.channels_last if fmt == "nhwc"
                   else torch.contiguous_format)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, kernel):
        fmt = layout(x, groups) or "nchw"
        x = _to_layout(x, fmt)
        if fmt == "nhwc":
            count("norm.k5_nhwc")
        fwd = group_norm_silu_fwd if kernel else group_norm_silu_fwd_plain
        y, mean, rstd = fwd(x, weight, bias, groups, eps)
        ctx.kernel, ctx.layout = kernel, fmt
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        bwd = group_norm_silu_bwd if ctx.kernel else group_norm_silu_bwd_plain
        dx, dweight, dbias = bwd(_to_layout(dy, ctx.layout),
                                 *ctx.saved_tensors)
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
