"""Numeric precision policy (counterpart of disvae_tpu/ops/precision.py).

* ``highest`` — float32 throughout: TF32 off for matmuls AND for cuDNN
  convolutions (cuDNN convs default to TF32 on Ampere and later), and
  deterministic cuDNN algorithms (the default ones for the transposed
  convs add with atomics, so two decodes of one latent differed in the
  last bit on an H100). Parity comparisons and the evaluation CLI run
  here, reproducible run to run as the JAX package is.
* ``high`` — TF32 tensor-core passes for float32 matmuls and convs,
  cuDNN's own algorithm choice.
* ``default`` — what the JAX CLI's ``--precision default`` computes on a
  TPU, where a float32 conv or dot is one bf16 MXU pass: every conv,
  transposed conv and linear of the model (`conv2d`, `conv_transpose2d`,
  `linear` below, and the modules `Conv2d`, `ConvTranspose2d`, `Linear`
  that call them) rounds its activation and weight to bf16 values, sums
  the products in float32 and adds the bias in float32; its backward
  rounds the incoming cotangent to bf16 as the operand of dgrad and wgrad
  and sums db from the float32 cotangent. Every tensor stays float32, and
  everything else (ReLU, reparameterisation, sigmoid, losses, Adam) runs
  in float32. The layers run with TF32 allowed: a bf16 value is exact in
  TF32, so the tensor cores multiply the rounded operands exactly and sum
  in float32, as an MXU pass does. cuDNN's algorithms are deterministic
  as under ``highest`` (otherwise its TF32 dgrad for a 1- or 3-channel
  input is not repeatable on an H100), so a CUDA graph of the step
  replays the eager step bit for bit. On the card the weight gradient of
  the encoder's first conv comes from the hand-written kernel K4
  (`takes_thin_conv_dw`), which multiplies the same bf16 values exactly
  and sums in float32. A product of two activations (`matmul`: an
  attention's scores and its weighted sum) rounds both operands to bf16
  values, sums in float32 and rounds its cotangent in the backward, as
  JAX's default dot of two float32 arrays does. On the card a GroupNorm
  -> SiLU that feeds a conv (AutoencoderKL's) is the hand-written kernel
  K5 (`takes_group_norm_silu`, ops/group_norm_silu.py), which writes the
  bf16 values the conv multiplies; the conv takes them as they are
  (`conv2d(..., rounded=True)`).

JAX's other bf16 mode, ``compute_dtype="bfloat16"`` (bf16 activations,
weights and outputs), is `models.vae.VAE(compute_dtype="bfloat16")`,
which runs the model in bf16 autocast under any policy; inside autocast
the helpers below are the plain calls.

The CLI exposes the policy as ``--precision``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from disvae_tpu_torch.utils import trace

PRECISIONS = ["highest", "high", "default"]
# what each policy computes in a conv, transposed conv or linear of the
# model (evidence.py records it beside a run)
NUMERICS = {
    "highest": "float32 operands and sums",
    "high": "TF32 operands, float32 sums",
    "default": "bf16-rounded operands, float32 sums, outputs and "
               "activations (JAX's default on a TPU)"}

_policy = "highest"


def configure(precision="highest"):
    """Set the process-wide float32 matmul/conv precision."""
    global _policy
    if precision not in PRECISIONS:
        raise ValueError("Unknown precision: {} (choose from {})".format(
            precision, PRECISIONS))
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = precision != "high"
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    _policy = precision


def current():
    """The policy `configure` last set (``highest`` before any call)."""
    return _policy


def round_bf16(t):
    """`t`'s values rounded to the nearest bf16, in `t`'s dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


# A conv or transposed conv with at most this many input or output
# channels takes its weight gradient with TF32 off when cuDNN computes
# it: on the H100 cuDNN's TF32 wgrad for conv1 / the final transposed
# conv (Cin or Cout 1 or 3) sums its N*H*W products in one long float32
# chain, 1.1e-5 to 6.4e-5 of scale off float64 at b64, against 1.5e-7 to
# 3.2e-7 for its float32 kernel (chip_smoke.py phase 19). Products of
# bf16 values are exact in either, so the function is the same. The
# 32-channel layers keep TF32, 0.026 ms against 0.50 ms for the float32
# kernel. On the card conv1's wgrad goes to K4 instead
# (`takes_thin_conv_dw`: k4 s2 p1 only); the thin wgrads left to cuDNN's
# float32 kernels are the final transposed conv's without the K1/K2
# hook, a thin conv on the CPU, one outside K4's geometry, and every thin
# k3 s1 and 1x1 conv (AutoencoderKL's encoder conv_in, post_quant_conv,
# decoder conv_in and conv_out).
THIN_CHANNELS = 4


def takes_thin_conv_dw(kind, x_shape, w_shape, stride, padding, device_type,
                       weight_grad=True):
    """Whether a layer under the ``default`` numerics asks K4
    (ops/convt_bwd.py `thin_conv_dw`) for its weight gradient rather than
    cuDNN: a k4 s2 p1 conv on the card with at most THIN_CHANNELS input
    channels whose weight gradient is wanted. A pure function of what the
    layer gets; the backward then takes K4 where the kernel's own
    geometry holds the shape (`convt_bwd.thin_conv_dw_fits`)."""
    return (kind == "conv" and weight_grad and device_type == "cuda"
            and stride == 2 and padding == 1
            and tuple(w_shape[2:]) == (4, 4)
            and x_shape[1] == w_shape[1] <= THIN_CHANNELS)


def _is_thin(w):
    return min(w.shape[0], w.shape[1]) <= THIN_CHANNELS


def _conv_backward(dy, x, w, kind, stride, padding, mask):
    thin = _is_thin(w)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32 and not (thin and mask[1])
    try:
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, [stride] * 2, [padding] * 2, [1, 1],
            kind == "convT", [0, 0], 1, mask + [False])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return dx, dw


def takes_group_norm_silu(dtype, device_type):
    """Whether silu(group_norm(x)) before a conv goes to K5
    (ops/group_norm_silu.py), which also rounds it to the bf16 values the
    conv takes: the ``default`` numerics (float32 x outside autocast) on
    the card. A pure function of what the call gets; everywhere else the
    layers run PyTorch's group norm and SiLU and the conv rounds."""
    return device_type == "cuda" and _default_numerics(dtype, device_type)


class _Bf16Layer(torch.autograd.Function):
    """A conv, transposed conv or linear (`kind`) without bias on bf16-
    rounded operands: x and w rounded to bf16 values (x taken as it is
    when `rounded` says it holds bf16 values already), float32 sums and
    output. The backward rounds the incoming cotangent to bf16 values as
    the operand of dgrad and wgrad and returns float32 dx and dw for x and
    w (straight through their rounding)."""

    @staticmethod
    def forward(ctx, x, w, kind, stride, padding, rounded):
        # K4 takes bf16 x: keep the rounding's bf16 copy for it
        ctx.k4 = takes_thin_conv_dw(kind, x.shape, w.shape, stride,
                                    padding, x.device.type,
                                    ctx.needs_input_grad[1])
        xb = x.to(torch.bfloat16) if ctx.k4 or not rounded else None
        x, w = (x if rounded else xb.to(x.dtype)), round_bf16(w)
        ctx.save_for_backward(xb.contiguous() if ctx.k4 else x, w)
        ctx.layer = (kind, stride, padding)
        if kind == "linear":
            return F.linear(x, w)
        op = F.conv2d if kind == "conv" else F.conv_transpose2d
        return op(x, w, None, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kind, stride, padding = ctx.layer
        mask = list(ctx.needs_input_grad[:2])
        if ctx.k4:  # x is the forward's bf16 copy
            from disvae_tpu_torch.ops import convt_bwd  # imports this module
            if convt_bwd.thin_conv_dw_fits(x, w):
                trace.count("wgrad.k4")
                # dy rounds to bf16 exactly as below
                dyb = dy.to(torch.bfloat16).contiguous()
                dw = convt_bwd.thin_conv_dw(x, dyb)
                dx = None
                if mask[0]:
                    dx, _ = _conv_backward(dyb.float(), x.float(), w, kind,
                                           stride, padding, [True, False])
                return dx, dw, None, None, None, None
            x = x.float()
        if mask[1]:  # the route counters: K4's above, TF32 or float32
            trace.count("wgrad.f32" if kind != "linear" and _is_thin(w)
                        else "wgrad.tf32")
        dy = round_bf16(dy)
        if kind != "linear":
            dx, dw = _conv_backward(dy, x, w, kind, stride, padding, mask)
            return dx, dw, None, None, None, None
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dy @ w if mask[0] else None
        dw = dy2.t() @ x.reshape(-1, x.shape[-1]) if mask[1] else None
        return dx, dw, None, None, None, None


def _default_numerics(dtype, device_type):
    return (_policy == "default" and dtype == torch.float32
            and not torch.is_autocast_enabled(device_type))


def _rounds(x):
    """Whether a layer on `x` runs the ``default`` numerics: float32
    operands outside autocast, under the ``default`` policy."""
    return _default_numerics(x.dtype, x.device.type)


def _layer(kind, x, w, b, stride=1, padding=0, rounded=False):
    """The bias is added in float32 after the sums, so autograd sums db
    from the float32 cotangent."""
    y = _Bf16Layer.apply(x, w, kind, stride, padding, rounded)
    if b is None:
        return y
    return y + (b if kind == "linear" else b.view(-1, 1, 1))


def conv2d(x, w, b, stride=2, padding=1, rounded=False):
    """F.conv2d under the policy (NCHW; torch's weight layout). Under
    ``default``, `rounded` says that x holds bf16 values already (K5's
    output): the layer multiplies and keeps x itself, no rounded copy."""
    if not _rounds(x):
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    return _layer("conv", x, w, b, stride, padding, rounded)


def conv_transpose2d(x, w, b, stride=2, padding=1):
    """F.conv_transpose2d under the policy."""
    if not _rounds(x):
        return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)
    return _layer("convT", x, w, b, stride, padding)


def linear(x, w, b):
    """F.linear under the policy (w is (out, in), as nn.Linear's)."""
    if not _rounds(x):
        return F.linear(x, w, b)
    return _layer("linear", x, w, b)


class _Bf16Matmul(torch.autograd.Function):
    """a @ b on bf16-rounded operands with float32 sums and output; the
    backward rounds the cotangent to bf16 values as the operand of both
    gradients, which pass the operands' rounding straight through."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = round_bf16(dy)
        da = dy @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a.transpose(-1, -2) @ dy if ctx.needs_input_grad[1] else None
        return da, db


def matmul(a, b):
    """torch.matmul of two activations under the policy (batched, as
    torch's): under ``default`` both operands round to bf16 values and the
    products sum in float32 (TF32 allowed, exact on bf16 values)."""
    if not _rounds(a):
        return torch.matmul(a, b)
    return _Bf16Matmul.apply(a, b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose forward is `conv2d` (same parameters and names)."""

    def forward(self, x, rounded=False):
        return conv2d(x, self.weight, self.bias, self.stride[0],
                      self.padding[0], rounded)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (no output padding) whose forward is
    `conv_transpose2d`."""

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride[0],
                                self.padding[0])


class Linear(nn.Linear):
    """nn.Linear whose forward is `linear`."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)
