"""Stable Diffusion's KL-regularised autoencoder "kl-f8" (Rombach et al.
2022) and its training step, as plain functions of a parameter dict.

Written from the published layer equations (diffusers' `AutoencoderKL`,
LDM's `ldm/modules/diffusionmodules/model.py`), with diffusers' parameter
names and torch's layouts (conv (out, in, k, k), linear (out, in)):

* ResnetBlock: GroupNorm(32, eps 1e-6), SiLU, conv3x3, GroupNorm, SiLU,
  conv3x3; a 1x1 `conv_shortcut` of the input where the width changes;
  the residual add;
* Encoder: `conv_in`; per level two ResnetBlocks and, but at the last
  level, a Downsample (zero pad right and bottom by 1, a stride-2 3x3
  conv); the mid block (ResnetBlock, single-head attention, ResnetBlock);
  `conv_norm_out`, SiLU, `conv_out` to 2 x latent channels; `quant_conv`
  1x1; the first half of the channels is the mean, the second the
  log-variance, clamped to [-30, 20];
* attention over the H/f x W/f positions: GroupNorm, q, k, v linears,
  softmax(q k^T / sqrt(C)) v, the output linear, the residual;
* Decoder: `post_quant_conv` 1x1, `conv_in`, the mid block, per level of
  the reversed widths three ResnetBlocks and, but at the last level, an
  Upsample (nearest x2, a 3x3 conv); `conv_norm_out`, SiLU, `conv_out`.

Images are NHWC in [0, 1], mapped to 2x - 1 on entry and (y + 1) / 2 on
exit; the latent is flattened in NCHW order.

The loss: LDM's `LPIPSWithDiscriminator` without its LPIPS and PatchGAN
terms and with its learned output log-variance at its initial 0, on
[0, 1] pixels: 3 * sum |x - x_hat| over an image's pixels, averaged over
the batch, plus beta times the KL of each image's posterior to N(0, I)
averaged over the batch (`betaH_B` of the configuration), with Adam
(betas 0.9, 0.999, eps 1e-8) written out.

Numerics, as `model.py` defines them:
* "float32": every product and sum in float32 (TF32 off);
* "bf16_operands": each conv, linear and product of two activations
  multiplies its operands rounded to bf16 values and sums in float32
  (then adds its bias in float32); the backward rounds the cotangent to
  bf16 values as the operand of both gradients, the bias gradient sums
  the float32 one, and the gradients pass the operands' rounding straight
  through. GroupNorm, SiLU, the softmax and the reparameterisation stay
  float32.

Self-contained (torch alone); the program's tests hold a byte-identical
copy (tests/plain_autoencoder_kl.py).
"""

import contextlib
import math

import torch
import torch.nn.functional as F

# https://huggingface.co/stabilityai/sd-vae-ft-mse/blob/main/config.json
PUBLISHED = {"block_out_channels": (128, 256, 512, 512),
             "layers_per_block": 2, "latent_channels": 4,
             "norm_num_groups": 32}
NORM_EPS = 1e-6
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


def architecture(cfg=None):
    """The widths a configuration states, the published ones where it
    states none."""
    cfg = cfg or {}
    return {k: tuple(cfg.get(k, v)) if isinstance(v, tuple)
            else int(cfg.get(k, v)) for k, v in PUBLISHED.items()}


def latent_shape(img_size, arch):
    f = 2 ** (len(arch["block_out_channels"]) - 1)
    return (arch["latent_channels"], img_size[1] // f, img_size[2] // f)


def param_spec(img_size, arch):
    """[(name, shape, fan_in)] of every parameter in diffusers' order;
    fan_in is None for GroupNorm's scale and shift."""
    spec = []
    widths, nl = arch["block_out_channels"], arch["layers_per_block"]
    lc = arch["latent_channels"]

    def conv(name, cin, cout, k=3):
        spec.append((name + ".weight", (cout, cin, k, k), cin * k * k))
        spec.append((name + ".bias", (cout,), cin * k * k))

    def norm(name, c):
        spec.append((name + ".weight", (c,), None))
        spec.append((name + ".bias", (c,), None))

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, 1)

    def mid(name, c):
        norm(name + ".attentions.0.group_norm", c)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            spec.append((name + ".attentions.0." + proj + ".weight", (c, c),
                         c))
            spec.append((name + ".attentions.0." + proj + ".bias", (c,), c))
        resnet(name + ".resnets.0", c, c)
        resnet(name + ".resnets.1", c, c)

    conv("encoder.conv_in", img_size[0], widths[0])
    for i, c in enumerate(widths):
        for j in range(nl):
            resnet("encoder.down_blocks.{}.resnets.{}".format(i, j),
                   widths[max(i - 1, 0)] if j == 0 else c, c)
        if i < len(widths) - 1:
            conv("encoder.down_blocks.{}.downsamplers.0.conv".format(i), c, c)
    mid("encoder.mid_block", widths[-1])
    norm("encoder.conv_norm_out", widths[-1])
    conv("encoder.conv_out", widths[-1], 2 * lc)
    rev = widths[::-1]
    conv("decoder.conv_in", lc, rev[0])
    for i, c in enumerate(rev):
        for j in range(nl + 1):
            resnet("decoder.up_blocks.{}.resnets.{}".format(i, j),
                   rev[max(i - 1, 0)] if j == 0 else c, c)
        if i < len(rev) - 1:
            conv("decoder.up_blocks.{}.upsamplers.0.conv".format(i), c, c)
    mid("decoder.mid_block", rev[0])
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], img_size[0])
    conv("quant_conv", 2 * lc, 2 * lc, 1)
    conv("post_quant_conv", lc, lc, 1)
    return spec


def init_params(img_size, seed, device, arch):
    """The parameters as PyTorch's default initialisation draws them, and
    LDM keeps them: conv and linear weights and biases U(+-1 /
    sqrt(fan_in)), from one uniform draw over all of them seeded with
    `seed` on `device`; GroupNorm's scale 1, shift 0. {name: float32
    tensor}."""
    spec = param_spec(img_size, arch)
    total = sum(math.prod(s) for _, s, fan in spec if fan is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, i = {}, 0
    for name, shape, fan_in in spec:
        if fan_in is None:
            out[name] = (torch.ones(shape, device=device)
                         if name.endswith(".weight")
                         else torch.zeros(shape, device=device))
            continue
        n = math.prod(shape)
        out[name] = (flat[i:i + n] / math.sqrt(fan_in)).view(shape)
        i += n
    return out


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
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundOperand(torch.autograd.Function):
    """Forward: the value rounded to bf16's; backward: straight through."""

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


def _product(op, a, b, numerics):
    if numerics == "float32":
        return op(a, b)
    if numerics == "bf16_operands":
        return _RoundCotangent.apply(op(_RoundOperand.apply(a),
                                        _RoundOperand.apply(b)))
    raise ValueError("numerics: {!r}".format(numerics))


def _conv(p, name, x, numerics, stride=1, padding=1):
    y = _product(lambda a, w: F.conv2d(a, w, stride=stride, padding=padding),
                 x, p[name + ".weight"], numerics)
    return y + p[name + ".bias"].view(1, -1, 1, 1)


def _linear(p, name, x, numerics):
    y = _product(lambda a, w: a @ w.t(), x, p[name + ".weight"], numerics)
    return y + p[name + ".bias"]


def _norm(p, name, x, arch):
    return F.group_norm(x, arch["norm_num_groups"], p[name + ".weight"],
                        p[name + ".bias"], NORM_EPS)


def _resnet(p, name, x, numerics, arch):
    h = _conv(p, name + ".conv1", F.silu(_norm(p, name + ".norm1", x, arch)),
              numerics)
    h = _conv(p, name + ".conv2", F.silu(_norm(p, name + ".norm2", h, arch)),
              numerics)
    if name + ".conv_shortcut.weight" in p:
        x = _conv(p, name + ".conv_shortcut", x, numerics, padding=0)
    return x + h


def _attention(p, name, x, numerics, arch):
    n, c, h, w = x.shape
    hs = _norm(p, name + ".group_norm", x, arch).reshape(n, c, h * w)
    hs = hs.transpose(1, 2)
    q, k, v = (_linear(p, name + "." + proj, hs, numerics)
               for proj in ("to_q", "to_k", "to_v"))
    scores = _product(torch.matmul, q, k.transpose(1, 2), numerics)
    probs = torch.softmax(scores / math.sqrt(c), dim=-1)
    out = _linear(p, name + ".to_out.0",
                  _product(torch.matmul, probs, v, numerics), numerics)
    return out.transpose(1, 2).reshape(n, c, h, w) + x


def _mid(p, name, x, numerics, arch):
    x = _resnet(p, name + ".resnets.0", x, numerics, arch)
    x = _attention(p, name + ".attentions.0", x, numerics, arch)
    return _resnet(p, name + ".resnets.1", x, numerics, arch)


def encode(p, x, numerics="float32", arch=None):
    """Images (N, H, W, C) in [0, 1] -> (mean, clamped logvar), each (N,
    latent_dim)."""
    arch = arch or architecture()
    widths = arch["block_out_channels"]
    h = _conv(p, "encoder.conv_in", x.permute(0, 3, 1, 2) * 2 - 1, numerics)
    for i in range(len(widths)):
        for j in range(arch["layers_per_block"]):
            h = _resnet(p, "encoder.down_blocks.{}.resnets.{}".format(i, j),
                        h, numerics, arch)
        if i < len(widths) - 1:
            h = _conv(p, "encoder.down_blocks.{}.downsamplers.0.conv"
                      .format(i), F.pad(h, (0, 1, 0, 1)), numerics,
                      stride=2, padding=0)
    h = _mid(p, "encoder.mid_block", h, numerics, arch)
    h = F.silu(_norm(p, "encoder.conv_norm_out", h, arch))
    h = _conv(p, "encoder.conv_out", h, numerics)
    moments = _conv(p, "quant_conv", h, numerics, padding=0)
    mean, logvar = moments.chunk(2, dim=1)
    logvar = torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX)
    return mean.reshape(x.shape[0], -1), logvar.reshape(x.shape[0], -1)


def decode(p, z, img_size, numerics="float32", arch=None):
    """Latents (N, latent_dim) -> images (N, H, W, C)."""
    arch = arch or architecture()
    widths = arch["block_out_channels"]
    h = z.view(z.shape[0], *latent_shape(img_size, arch))
    h = _conv(p, "post_quant_conv", h, numerics, padding=0)
    h = _conv(p, "decoder.conv_in", h, numerics)
    h = _mid(p, "decoder.mid_block", h, numerics, arch)
    for i in range(len(widths)):
        for j in range(arch["layers_per_block"] + 1):
            h = _resnet(p, "decoder.up_blocks.{}.resnets.{}".format(i, j),
                        h, numerics, arch)
        if i < len(widths) - 1:
            h = _conv(p, "decoder.up_blocks.{}.upsamplers.0.conv".format(i),
                      F.interpolate(h, scale_factor=2.0, mode="nearest"),
                      numerics)
    h = F.silu(_norm(p, "decoder.conv_norm_out", h, arch))
    h = _conv(p, "decoder.conv_out", h, numerics)
    return ((h + 1) / 2).permute(0, 2, 3, 1)


def loss(p, x, eps, cfg, numerics):
    """The loss of one batch (x NHWC float32 in [0, 1], eps the
    reparameterisation noise (N, latent_dim)) and its KL term, the sum
    over the latents of each latent's KL averaged over the batch."""
    arch = architecture(cfg)
    mu, logvar = encode(p, x, numerics, arch)
    z = mu + torch.exp(0.5 * logvar) * eps
    recon = decode(p, z, tuple(cfg["img_size"]), numerics, arch)
    rec = 3 * torch.abs(recon - x).sum() / x.shape[0]
    kl = (0.5 * (-1 - logvar + mu ** 2 + torch.exp(logvar))).mean(0).sum()
    return rec + cfg["betaH_B"] * kl, kl


class Adam:
    """torch's Adam (Kingma & Ba), betas (0.9, 0.999), eps 1e-8, written
    out: m and v are the first and second moments, bias-corrected by the
    step count."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads):
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def gradients(params, x, eps, cfg, numerics):
    """The loss's gradient at `params` on one batch and its noise, {name:
    float32 tensor}."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with exact_float32():
        value, _ = loss(params, x, eps, cfg, numerics)
        grads = torch.autograd.grad(value, list(params.values()))
    return {k: g.detach() for k, g in zip(params, grads)}


def train_steps(weights, batches, noises, cfg, numerics):
    """Follow the program's first steps from the same weights, batches and
    noise. Returns {"losses", "kls": each step's loss and KL term,
    "first_grads": the first step's gradients, "params": the parameters
    after the last step}, tensors float32 on the weights' device."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, cfg["lr"])
    losses, kls, first_grads = [], [], None
    with exact_float32():
        for x, eps in zip(batches, noises):
            value, kl = loss(params, x, eps, cfg, numerics)
            grads = dict(zip(params, torch.autograd.grad(
                value, list(params.values()))))
            if first_grads is None:
                first_grads = {k: g.detach().clone()
                               for k, g in grads.items()}
            opt.step(grads)
            losses.append(float(value.detach()))
            kls.append(float(kl.detach()))
            del value, kl, grads
    return {"losses": losses, "kls": kls, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}}
