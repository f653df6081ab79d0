"""The Burgess et al. (2018) VAE as plain functions of a parameter dict.

Encoder: 3 (4 for 64x64) k4 s2 p1 convs of 32 channels with ReLU, two
256-unit linears with ReLU, a linear head of 2 * latent outputs read as
interleaved (mu, logvar) pairs. Decoder: three linears (256, 256, 512)
with ReLU, reshaped to (32, 4, 4), then k4 s2 p1 transposed convs with
ReLU between them and a sigmoid at the end. Images are NHWC in [0, 1];
the layers run NCHW, flattened in NCHW order. Parameter names and
layouts are the reference repository's (conv (out, in, k, k), transposed
conv (in, out, k, k), linear (out, in)).

Numerics:
* "float32": every product and sum in float32 (TF32 off);
* "bf16_operands": each conv, transposed conv and linear multiplies its
  input and weight rounded to bf16 values and sums in float32, then adds
  its bias in float32; in the backward pass the cotangent is rounded to
  bf16 values as the operand of the input and weight gradients, the bias
  gradient is summed from the float32 cotangent, and the gradients pass
  the operands' rounding straight through. This is what a float32 conv or
  dot computes under JAX's `default` precision on a TPU, the numerics the
  flagship configuration states.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

HID, KERNEL, HIDDEN, BOTTLENECK = 32, 4, 256, 4


def param_spec(img_size, latent_dim):
    """[(name, shape, fan_in)] of every parameter, in the order the
    reference repository's modules register them. fan_in is torch's:
    size(1) times the kernel area (for a transposed conv, its OUT
    channels)."""
    c, h, _ = img_size
    spec = []

    def add(name, wshape, bias):
        fan_in = wshape[1] * math.prod(wshape[2:])
        spec.append((name + ".weight", tuple(wshape), fan_in))
        spec.append((name + ".bias", (bias,), fan_in))

    cin = c
    for name in ["conv1", "conv2", "conv3"] + (["conv_64"] if h == 64
                                               else []):
        add("encoder." + name, (HID, cin, KERNEL, KERNEL), HID)
        cin = HID
    flat = HID * BOTTLENECK * BOTTLENECK
    add("encoder.lin1", (HIDDEN, flat), HIDDEN)
    add("encoder.lin2", (HIDDEN, HIDDEN), HIDDEN)
    add("encoder.mu_logvar_gen", (2 * latent_dim, HIDDEN), 2 * latent_dim)
    add("decoder.lin1", (HIDDEN, latent_dim), HIDDEN)
    add("decoder.lin2", (HIDDEN, HIDDEN), HIDDEN)
    add("decoder.lin3", (flat, HIDDEN), flat)
    names = (["convT_64"] if h == 64 else []) + ["convT1", "convT2",
                                                 "convT3"]
    for i, name in enumerate(names):
        cout = c if i == len(names) - 1 else HID
        add("decoder." + name, (HID, cout, KERNEL, KERNEL), cout)
    return spec


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _round(t):
    """t's values rounded to bf16's."""
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundOperand(torch.autograd.Function):
    """Forward: the value rounded; backward: straight through."""

    @staticmethod
    def forward(ctx, t):
        return _round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Forward: the identity; backward: the cotangent rounded."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def _layer(op, x, w, b, numerics, bias_shape):
    if numerics == "float32":
        y = op(x, w)
    elif numerics == "bf16_operands":
        y = _RoundCotangent.apply(op(_RoundOperand.apply(x),
                                     _RoundOperand.apply(w)))
    else:
        raise ValueError("numerics: {!r}".format(numerics))
    return y + b.view(bias_shape)


def _conv(p, name, x, numerics):
    return _layer(lambda a, w: F.conv2d(a, w, stride=2, padding=1), x,
                  p[name + ".weight"], p[name + ".bias"], numerics,
                  (1, -1, 1, 1))


def _convT(p, name, x, numerics):
    return _layer(lambda a, w: F.conv_transpose2d(a, w, stride=2,
                                                  padding=1), x,
                  p[name + ".weight"], p[name + ".bias"], numerics,
                  (1, -1, 1, 1))


def _linear(p, name, x, numerics):
    return _layer(lambda a, w: a @ w.t(), x, p[name + ".weight"],
                  p[name + ".bias"], numerics, (1, -1))


def encode(p, x, numerics="float32"):
    """Images (N, H, W, C) -> (mu, logvar), each (N, latent)."""
    h = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2", "conv3", "conv_64"):
        if "encoder." + name + ".weight" in p:
            h = torch.relu(_conv(p, "encoder." + name, h, numerics))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(_linear(p, "encoder.lin1", h, numerics))
    h = torch.relu(_linear(p, "encoder.lin2", h, numerics))
    out = _linear(p, "encoder.mu_logvar_gen", h, numerics)
    pairs = out.view(out.shape[0], -1, 2)
    return pairs[..., 0], pairs[..., 1]


def decode(p, z, numerics="float32"):
    """Latents (N, latent) -> images (N, H, W, C) in (0, 1)."""
    h = torch.relu(_linear(p, "decoder.lin1", z, numerics))
    h = torch.relu(_linear(p, "decoder.lin2", h, numerics))
    h = torch.relu(_linear(p, "decoder.lin3", h, numerics))
    h = h.view(-1, HID, BOTTLENECK, BOTTLENECK)
    names = [n for n in ("convT_64", "convT1", "convT2", "convT3")
             if "decoder." + n + ".weight" in p]
    for i, name in enumerate(names):
        h = _convT(p, "decoder." + name, h, numerics)
        if i < len(names) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h).permute(0, 2, 3, 1)
