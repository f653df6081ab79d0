"""Backward of the decoder's final transposed conv (k4, s2, p1).

Counterpart of disvae_tpu/ops/pallas_convt_bwd.py (`convt3_bwd_pl`, its
Pallas kernels `_dw_kernel` / `_dx_kernel`, and the custom_vjp
`conv2d_transpose_pl`) and of disvae_tpu/ops/convs.py `aligned_phase_s2d`.
Layouts are PyTorch's: x (N, Cin, H, W), dy (N, Cout, 2H, 2W), and the
ConvTranspose2d weight w (Cin, Cout, 4, 4), which is the JAX HWIO kernel
transposed and flipped in space (utils/torch_compat.py).

* `convt3_bwd_plain(x, w, dy, cdt)` — plain PyTorch, the JAX function's
  aligned-polyphase formulation: `cdt` operands, float32 sums; its halves
  `convt3_dw_plain` / `convt3_dx_plain` are the plain versions of K1 / K2.
* `convt3_dw` / `convt3_dx` — the hand-written CUDA kernels K1 / K2 in
  `disvae_tpu_torch/csrc/convt3_bwd.cu` (its header says what bounds them
  on Hopper and what the design does about it). Each counts its launches
  in `.launches`, and in `.captured` those made while the stream captures
  a CUDA graph (they run once per replay of the graph, not at the call).
* `convt3_bwd(x, w, dy)` -> (dx, dw, db): the plain version for CPU
  tensors, the kernels for CUDA tensors (or it raises; nothing falls back).
  `.calls` counts its calls on either device.
  The operand dtype is x's (float32 or bfloat16, dy the same); dw and db
  come back in w's dtype, dx in x's.
* `ConvTranspose3Final` / `conv_transpose2d_pl` — the autograd wrapper:
  the forward is `F.conv_transpose2d`, bit-identical to the module's; the
  backward runs `convt3_bwd` under the ``default`` precision policy and
  autograd's exact convolution backward under ``highest``/``high``.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from disvae_tpu_torch.ops import cuda_build, precision

_NAME = "convt3_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def aligned_phase_s2d(dy, cdt):
    """Aligned polyphase decomposition of a stride-2 output gradient:
    NHWC (N, 2H, 2W, C) -> (N, H+1, W+1, 4C) with
    out[n, i, j, (pi*2 + pj)*C + c] = dy[n, 2i - pi, 2j - pj, c] (zero out
    of range), in dtype `cdt` (disvae_tpu/ops/convs.py:288-308)."""
    n, h2, w2, cout = dy.shape
    h, wd = h2 // 2, w2 // 2
    ph = dy.to(cdt).reshape(n, h, 2, wd, 2, cout)
    # even rows padded at the end (dy[2h] = 0), odd rows at the start
    # (dy[-1] = 0); then the same along the columns
    p0 = F.pad(ph[:, :, 0], (0, 0, 0, 0, 0, 0, 0, 1))
    p1 = F.pad(ph[:, :, 1], (0, 0, 0, 0, 0, 0, 1, 0))
    ph = torch.stack([p0, p1], dim=2)          # (n, h+1, 2, wd, 2, cout)
    q0 = F.pad(ph[..., 0, :], (0, 0, 0, 1))
    q1 = F.pad(ph[..., 1, :], (0, 0, 1, 0))
    ph = torch.stack([q0, q1], dim=4)          # (n, h+1, 2, wd+1, 2, cout)
    return ph.permute(0, 1, 3, 2, 4, 5).reshape(n, h + 1, wd + 1, 4 * cout)


def _hwio(w):
    """torch (Cin, Cout, 4, 4) -> the JAX package's HWIO (4, 4, Cin, Cout)."""
    return w.flip(2, 3).permute(2, 3, 0, 1)


def convt3_dw_plain(x, dy, cdt=torch.float32):
    """Plain K1: dW (Cin, Cout, 4, 4) float32 as `convt3_bwd_pl` computes
    it (disvae_tpu/ops/pallas_convt_bwd.py:150-176): four products of the
    shifted x against the aligned phases Q of dy, on `cdt`-rounded
    operands, summed in float32."""
    n, cin, h, wd = x.shape
    cout = dy.shape[1]
    rhs = aligned_phase_s2d(dy.permute(0, 2, 3, 1), cdt).float().reshape(
        -1, 4 * cout)
    # x[i + du - 1, j + dv - 1] aligned against Q[i, j], zero out of range
    xp = F.pad(x.permute(0, 2, 3, 1).to(cdt).float(), (0, 0, 1, 1, 1, 1))
    dk = torch.cat([
        xp[:, du:du + h + 1, dv:dv + wd + 1, :].reshape(-1, cin).t() @ rhs
        for du in (0, 1) for dv in (0, 1)])    # rows (du, dv, ci)
    # rows (du, dv, ci), cols (pi, pj, co) -> HWIO w[2du+pi, 2dv+pj, ci, co]
    dw_hwio = (dk.reshape(2, 2, cin, 2, 2, cout)
                 .permute(0, 3, 1, 4, 2, 5)
                 .reshape(4, 4, cin, cout))
    return dw_hwio.permute(2, 3, 0, 1).flip(2, 3).contiguous()


def convt3_dx_plain(dy, w, cdt=torch.float32):
    """Plain K2: dx (N, Cin, H, W) float32 as `convt3_bwd_pl` computes it
    (pallas_convt_bwd.py:178-195): four products of shifted Q against the
    weight blocks W2, on `cdt`-rounded operands, summed in float32."""
    n, cout, h2, w2 = dy.shape
    h, wd, cin = h2 // 2, w2 // 2, w.shape[0]
    q = aligned_phase_s2d(dy.permute(0, 2, 3, 1), cdt).float()
    # W2[(du, dv), (pi, pj, co), ci] = w_hwio[2du+pi, 2dv+pj, ci, co]
    w2 = (_hwio(w).to(cdt).float()
          .reshape(2, 2, 2, 2, cin, cout)        # (du, pi, dv, pj, ci, co)
          .permute(0, 2, 1, 3, 5, 4)
          .reshape(4, 4 * cout, cin))
    dx = sum(q[:, 1 - du:1 - du + h, 1 - dv:1 - dv + wd, :]
             .reshape(-1, 4 * cout) @ w2[du * 2 + dv]
             for du in (0, 1) for dv in (0, 1))
    return dx.reshape(n, h, wd, cin).permute(0, 3, 1, 2).contiguous()


def convt3_bwd_plain(x, w, dy, cdt=torch.float32):
    """(dx, dw, db) of the k4 s2 p1 transposed conv, plain PyTorch
    (`convt3_bwd_pl`, :137-198): dx in x's dtype, dw and db in w's."""
    db = dy.sum(dim=(0, 2, 3), dtype=torch.float32).to(w.dtype)
    return (convt3_dx_plain(dy, w, cdt).to(x.dtype),
            convt3_dw_plain(x, dy, cdt).to(w.dtype), db)


def build():
    """Compile csrc/convt3_bwd.cu (ops/cuda_build.py). Returns (path,
    compiler output); the output is empty when nothing was compiled."""
    return cuda_build.build(_NAME)


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.disvae_convt3_dw_n_blocks.argtypes = [i] * 7
    lib.disvae_convt3_dw_n_blocks.restype = i
    lib.disvae_convt3_dw.argtypes = [i, p, p, p, p] + [i] * 6 + [p]
    lib.disvae_convt3_dw.restype = i
    lib.disvae_convt3_dx_n_blocks.argtypes = [i] * 7
    lib.disvae_convt3_dx_n_blocks.restype = i
    lib.disvae_convt3_dx.argtypes = [i, i, p, p, p] + [i] * 6 + [p]
    lib.disvae_convt3_dx.restype = i


def _check(x, w, dy):
    """Shapes (N, Cin, H, W), (Cin, Cout, 4, 4), (N, Cout, 2H, 2W); x and
    dy of one dtype, on one device."""
    if x.dim() != 4 or w.dim() != 4 or dy.dim() != 4:
        raise ValueError("convt3_bwd: x, w and dy must be 4-d")
    n, cin, h, wd = x.shape
    cout = w.shape[1]
    if tuple(w.shape) != (cin, cout, 4, 4) \
            or tuple(dy.shape) != (n, cout, 2 * h, 2 * wd):
        raise ValueError(
            "convt3_bwd: shapes x {}, w {}, dy {} do not fit (N, Cin, H, W), "
            "(Cin, Cout, 4, 4), (N, Cout, 2H, 2W)".format(
                tuple(x.shape), tuple(w.shape), tuple(dy.shape)))
    if x.dtype != dy.dtype:
        raise TypeError("convt3_bwd: x is {}, dy {}".format(x.dtype,
                                                           dy.dtype))
    if w.device != x.device or dy.device != x.device:
        raise ValueError("convt3_bwd: x, w and dy must share a device")
    return n, cin, h, wd, cout


def _check_kernel(x, w, dy):
    n, cin, h, wd, cout = _check(x, w, dy)
    if x.device.type != "cuda":
        raise ValueError("convt3 kernels: no kernel for device {}".format(
            x.device))
    if x.dtype not in _DTYPES:
        raise TypeError("convt3 kernels: operands must be float32 or "
                        "bfloat16, got {}".format(x.dtype))
    if w.dtype != torch.float32:
        raise TypeError("convt3 kernels: w must be float32, got {}".format(
            w.dtype))
    for name, t in (("x", x), ("w", w), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError("convt3 kernels: {} must be contiguous".format(
                name))
    # K1's register tiles (4 channels x 8 taps) must fit one block
    if cout > 16 or (cin + 3) // 4 * 2 * cout > 256 \
            or n * cout * 4 * h * wd >= 2 ** 31:
        raise ValueError("convt3 kernels: (N, Cin, H, W, Cout) = {} exceeds "
                         "the launch geometry".format((n, cin, h, wd, cout)))
    return n, cin, h, wd, cout


@functools.lru_cache(maxsize=None)
def _blocks(query, dtype, n, cin, h, wd, cout, device_index):
    """Blocks of a launch on one card from the library's `query`
    (disvae_convt3_dw_n_blocks: K1's first pass, rows of its scratch;
    disvae_convt3_dx_n_blocks: the bf16 K2 by its output dtype). The bf16
    kernels ask the occupancy calculator. 0 if the shape exceeds the
    launch geometry. Cached: the train step asks for one shape at every
    step."""
    lib = cuda_build.library(_NAME, _declare)
    with torch.cuda.device(device_index):
        sm_count = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        return getattr(lib, query)(dtype, n, cin, h, wd, cout, sm_count)


def convt3_dw(x, dy):
    """K1: dW (Cin, Cout, 4, 4) float32 of the transposed conv, from CUDA
    x (N, Cin, H, W) and dy (N, Cout, 2H, 2W) of one dtype. In bf16 the
    kernel works in row bands on the tensor cores: Cin <= 32, Cout <= 8,
    and a band of one row must fit shared memory."""
    n, cin, h, wd = x.shape
    cout = dy.shape[1]
    dw = torch.empty((cin, cout, 4, 4), dtype=torch.float32, device=x.device)
    _check_kernel(x, dw, dy)
    n_blocks = _blocks("disvae_convt3_dw_n_blocks", _DTYPES[x.dtype], n, cin,
                       h, wd, cout, x.device.index)
    if n_blocks < 1:
        raise ValueError("convt3_dw: (N, Cin, H, W, Cout) = {} exceeds the "
                         "launch geometry (bf16: Cin <= 32, Cout <= 8 and a "
                         "one-row band in shared memory)".format(
                             (n, cin, h, wd, cout)))
    lib = cuda_build.library(_NAME, _declare)
    with torch.cuda.device(x.device):
        part = torch.empty((n_blocks, cin * 16 * cout), dtype=torch.float32,
                           device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.disvae_convt3_dw(_DTYPES[x.dtype], x.data_ptr(),
                                   dy.data_ptr(), part.data_ptr(),
                                   dw.data_ptr(), n, cin, h, wd, cout,
                                   n_blocks, stream)
    cuda_build.check(lib, err, "convt3_dw")
    convt3_dw.launches += 1
    convt3_dw.captured += torch.cuda.is_current_stream_capturing()
    return dw


def convt3_dx(dy, w, out_dtype=None):
    """K2: dx (N, Cin, H, W) from CUDA dy (N, Cout, 2H, 2W) and the float32
    weight w (Cin, Cout, 4, 4). dx is in dy's dtype, or in float32 with
    `out_dtype=torch.float32` (the sums before their rounding to bf16). In
    bf16 the kernel works in row bands on the tensor cores, with either
    output dtype: Cin <= 32, Cout <= 8, and a band of one row must fit
    shared memory."""
    n, cout, h2, w2 = dy.shape
    cin, h, wd = w.shape[0], h2 // 2, w2 // 2
    out_dtype = dy.dtype if out_dtype is None else out_dtype
    if out_dtype not in (dy.dtype, torch.float32):
        raise TypeError("convt3_dx: out_dtype must be dy's dtype or float32")
    dx = torch.empty((n, cin, h, wd), dtype=out_dtype, device=dy.device)
    _check_kernel(torch.empty_like(dx, dtype=dy.dtype), w, dy)
    n_blocks = 0  # the float32 kernel's grid follows the shape
    if dy.dtype == torch.bfloat16:
        n_blocks = _blocks("disvae_convt3_dx_n_blocks", _DTYPES[out_dtype], n,
                           cin, h, wd, cout, dy.device.index)
        if n_blocks < 1:
            raise ValueError("convt3_dx: (N, Cin, H, W, Cout) = {} exceeds "
                             "the launch geometry (bf16: Cin <= 32, Cout <= "
                             "8 and a one-row band in shared memory)".format(
                                 (n, cin, h, wd, cout)))
    lib = cuda_build.library(_NAME, _declare)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        err = lib.disvae_convt3_dx(_DTYPES[dy.dtype], _DTYPES[out_dtype],
                                   dy.data_ptr(), w.data_ptr(),
                                   dx.data_ptr(), n, cin, h, wd, cout,
                                   n_blocks, stream)
    cuda_build.check(lib, err, "convt3_dx")
    convt3_dx.launches += 1
    convt3_dx.captured += torch.cuda.is_current_stream_capturing()
    return dx


convt3_dw.launches = convt3_dw.captured = 0
convt3_dx.launches = convt3_dx.captured = 0


def convt3_bwd(x, w, dy):
    """(dx, dw, db) of the k4 s2 p1 transposed conv. CPU tensors take
    `convt3_bwd_plain` with x's dtype as the operand dtype; CUDA tensors
    launch K1 and K2. dx comes back in x's dtype, dw and db in w's."""
    _check(x, w, dy)
    convt3_bwd.calls += 1
    if x.device.type == "cpu":
        return convt3_bwd_plain(x, w, dy, cdt=x.dtype)
    dw = convt3_dw(x, dy).to(w.dtype)
    dx = convt3_dx(dy, w)
    db = dy.sum(dim=(0, 2, 3), dtype=torch.float32).to(w.dtype)
    return dx, dw, db


convt3_bwd.calls = 0


class ConvTranspose3Final(torch.autograd.Function):
    """F.conv_transpose2d(x, w, b, stride=2, padding=1) whose backward is
    `convt3_bwd` under the ``default`` policy (disvae_tpu/ops/
    pallas_convt_bwd.py `conv2d_transpose_pl`, :215-239). Under
    ``highest``/``high`` the backward is autograd's own convolution
    backward on the same arguments, so the grads are bitwise those of the
    plain transposed conv."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias_shape = None if b is None else tuple(b.shape)
        return F.conv_transpose2d(x, w, b, stride=2, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if precision.current() != "default":
            mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                    ctx.bias_shape is not None and ctx.needs_input_grad[2]]
            return torch.ops.aten.convolution_backward(
                dy, x, w, ctx.bias_shape, [2, 2], [1, 1], [1, 1], True,
                [0, 0], 1, mask)
        # under autocast the forward ran in bf16: x and dy are bf16, w is
        # the float32 master weight
        dx, dw, db = convt3_bwd(x.contiguous(), w.contiguous(),
                                dy.to(x.dtype).contiguous())
        return dx, dw, (db if ctx.bias_shape is not None else None)


def conv_transpose2d_pl(x, w, b):
    """The final decoder transposed conv with the K1/K2 backward; hand it
    to `models.burgess.set_final_convt_impl`."""
    return ConvTranspose3Final.apply(x, w, b)
