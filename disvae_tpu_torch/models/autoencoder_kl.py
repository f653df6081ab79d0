"""Stable Diffusion's KL-regularised autoencoder "kl-f8" (Rombach et al.
2022, High-Resolution Image Synthesis with Latent Diffusion Models) as
nn.Modules, with diffusers' `AutoencoderKL` parameter names, so that the
published `stabilityai/sd-vae-ft-mse` weights load by name.

Layers (diffusers' and LDM's equations):

* ResnetBlock: GroupNorm(32, eps 1e-6) -> SiLU -> conv3x3 -> GroupNorm ->
  SiLU -> conv3x3, plus a 1x1 `conv_shortcut` of the input when the
  channel count changes, then the residual add;
* Encoder: `conv_in` C -> 128; per level of `block_out_channels` (128,
  256, 512, 512) two ResnetBlocks, each level but the last ending in a
  Downsample (pad (0, 1, 0, 1), then a stride-2 3x3 conv); the mid block
  (ResnetBlock, single-head self-attention over the H/8 x W/8 positions
  at width 512, ResnetBlock); `conv_norm_out`, SiLU, `conv_out` 512 -> 8;
* `quant_conv` 1x1, split into the mean and the log-variance of a 4 x
  H/8 x W/8 latent, the log-variance clamped to [-30, 20] as
  `DiagonalGaussianDistribution` does;
* Decoder: `post_quant_conv` 1x1, `conv_in` 4 -> 512, the same mid block,
  per level of the reversed widths three ResnetBlocks, each level but the
  last ending in an Upsample (nearest x2, then a 3x3 conv);
  `conv_norm_out`, SiLU, `conv_out` 128 -> C.

The attention: GroupNorm, q/k/v projections, softmax(q k^T / sqrt(512))
v, the output projection, the residual. Every conv and linear is an
ops/precision.py module and the attention's two products go through
`precision.matmul`, so the precision policy decides their numerics;
GroupNorm, SiLU, the softmax and the reparameterisation run in float32.
Under the ``default`` numerics on the card each GroupNorm -> SiLU that
feeds a conv (50 at the published widths) is the hand-written kernel K5
(ops/group_norm_silu.py), whose output the conv takes as its bf16-rounded
operand (`precision.takes_group_norm_silu`, counted as `norm.k5`).

Where K5 takes the GroupNorms (`channels_last`) the maps are
channels-last throughout: `encode`'s NHWC images are a channels-last view
of NCHW, `decode` turns the latent channels-last once before
`post_quant_conv`, and every layer keeps the layout it is given (convs,
bias and residual adds, padding, nearest upsampling, K5's NHWC kernels),
so cuDNN's NHWC convs take their operands with no transform and every
add is of one layout. Only the weights stay NCHW, and the attention's
PyTorch GroupNorm makes its own NCHW copy.

The VAE container (models/vae.py) keeps its contract: images NHWC in [0,
1] are mapped to [-1, 1] on entry and back on exit (no sigmoid), and the
latent is flattened in NCHW order, `latent_dim` = 4 * H/8 * W/8. The
widths are sd-vae-ft-mse's `config.json` unless a caller passes others
(`block_out_channels`, `layers_per_block`, `latent_channels`,
`norm_num_groups`; the tests' small model).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from disvae_tpu_torch.ops import precision
from disvae_tpu_torch.ops.group_norm_silu import group_norm_silu
from disvae_tpu_torch.utils.trace import count, span

# https://huggingface.co/stabilityai/sd-vae-ft-mse/blob/main/config.json
BLOCK_OUT_CHANNELS = (128, 256, 512, 512)
LAYERS_PER_BLOCK = 2
LATENT_CHANNELS = 4
NORM_NUM_GROUPS = 32
NORM_EPS = 1e-6
# DiagonalGaussianDistribution's clamp of the log-variance
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


def architecture(block_out_channels=None, layers_per_block=None,
                 latent_channels=None, norm_num_groups=None):
    """The widths, the published ones where not given."""
    return dict(
        block_out_channels=tuple(block_out_channels or BLOCK_OUT_CHANNELS),
        layers_per_block=int(layers_per_block or LAYERS_PER_BLOCK),
        latent_channels=int(latent_channels or LATENT_CHANNELS),
        norm_num_groups=int(norm_num_groups or NORM_NUM_GROUPS))


def latent_shape(img_size, **arch):
    """(C, H / f, W / f) of the latent of (C, H, W) images, f = 2 per
    Downsample (8 at the published widths)."""
    arch = architecture(**arch)
    f = 2 ** (len(arch["block_out_channels"]) - 1)
    return (arch["latent_channels"], img_size[1] // f, img_size[2] // f)


def latent_dim(img_size, **arch):
    """The flattened latent's size: 4 * H/8 * W/8 at the published widths."""
    return math.prod(latent_shape(img_size, **arch))


def check_img_size(img_size, **arch):
    f = 2 ** (len(architecture(**arch)["block_out_channels"]) - 1)
    if len(img_size) != 3 or img_size[1] % f or img_size[2] % f \
            or min(img_size[1:]) < f:
        raise RuntimeError(
            "{} sized images not supported by AutoencoderKL: H and W must "
            "be multiples of {}.".format(img_size, f))


def _norm(channels, groups):
    return nn.GroupNorm(groups, channels, eps=NORM_EPS)


def _conv3(cin, cout, stride=1, padding=1):
    return precision.Conv2d(cin, cout, 3, stride=stride, padding=padding)


def _norm_silu_conv(norm, conv, x):
    """conv(silu(norm(x))); K5 computes silu(norm(x)) already rounded for
    the conv where `precision.takes_group_norm_silu` routes it there."""
    if precision.takes_group_norm_silu(x.dtype, x.device.type):
        count("norm.k5")
        return conv(group_norm_silu(x, norm.weight, norm.bias,
                                    norm.num_groups, norm.eps), rounded=True)
    return conv(F.silu(norm(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = _norm(cin, groups)
        self.conv1 = _conv3(cin, cout)
        self.norm2 = _norm(cout, groups)
        self.conv2 = _conv3(cout, cout)
        self.conv_shortcut = (precision.Conv2d(cin, cout, 1, padding=0)
                              if cin != cout else None)

    def forward(self, x):
        h = _norm_silu_conv(self.norm1, self.conv1, x)
        h = _norm_silu_conv(self.norm2, self.conv2, h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = _conv3(channels, channels, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attention(nn.Module):
    """Single-head self-attention over the positions of a (N, C, H, W)
    map, with its residual."""

    def __init__(self, channels, groups):
        super().__init__()
        self.group_norm = _norm(channels, groups)
        self.to_q = precision.Linear(channels, channels)
        self.to_k = precision.Linear(channels, channels)
        self.to_v = precision.Linear(channels, channels)
        self.to_out = nn.ModuleList([precision.Linear(channels, channels)])

    def forward(self, x):
        with span("vae.mid_attn"):
            n, c, h, w = x.shape
            hs = self.group_norm(x).view(n, c, h * w).transpose(1, 2)
            q, k, v = self.to_q(hs), self.to_k(hs), self.to_v(hs)
            scores = precision.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
            probs = torch.softmax(scores.float(), dim=-1)
            out = self.to_out[0](precision.matmul(probs, v))
            return out.transpose(1, 2).reshape(n, c, h, w) + x


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels, groups):
        super().__init__()
        self.attentions = nn.ModuleList([Attention(channels, groups)])
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels,
                                                    groups)
                                      for _ in range(2)])

    def forward(self, x):
        x = self.resnets[0](x)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x))
        return x


class _Level(nn.Module):
    """DownEncoderBlock2D / UpDecoderBlock2D: resnets, then the level's
    resampler (`downsamplers` or `upsamplers`, None at the last level)."""

    def __init__(self, cin, cout, n_resnets, groups, resampler, name):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, groups)
            for i in range(n_resnets)])
        self._resampler = name
        setattr(self, name, (nn.ModuleList([resampler(cout)])
                             if resampler is not None else None))

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        resamplers = getattr(self, self._resampler)
        if resamplers is not None:
            x = resamplers[0](x)
        return x


class Encoder(nn.Module):
    """x (N, C, H, W) in [-1, 1] -> moments (N, 2 * latent_channels, H/f,
    W/f)."""

    def __init__(self, in_channels, block_out_channels, layers_per_block,
                 latent_channels, norm_num_groups):
        super().__init__()
        widths, g = block_out_channels, norm_num_groups
        self.conv_in = _conv3(in_channels, widths[0])
        self.down_blocks = nn.ModuleList([
            _Level(widths[max(i - 1, 0)], c, layers_per_block, g,
                   Downsample2D if i < len(widths) - 1 else None,
                   "downsamplers")
            for i, c in enumerate(widths)])
        self.mid_block = UNetMidBlock2D(widths[-1], g)
        self.conv_norm_out = _norm(widths[-1], g)
        self.conv_out = _conv3(widths[-1], 2 * latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, h)


class Decoder(nn.Module):
    """z (N, latent_channels, H/f, W/f) -> (N, C, H, W) in about [-1, 1]."""

    def __init__(self, out_channels, block_out_channels, layers_per_block,
                 latent_channels, norm_num_groups):
        super().__init__()
        widths, g = tuple(reversed(block_out_channels)), norm_num_groups
        self.conv_in = _conv3(latent_channels, widths[0])
        self.mid_block = UNetMidBlock2D(widths[0], g)
        self.up_blocks = nn.ModuleList([
            _Level(widths[max(i - 1, 0)], c, layers_per_block + 1, g,
                   Upsample2D if i < len(widths) - 1 else None,
                   "upsamplers")
            for i, c in enumerate(widths)])
        self.conv_norm_out = _norm(widths[-1], g)
        self.conv_out = _conv3(widths[-1], out_channels)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, h)


def parts(img_size, latent_dim_, **arch):
    """The VAE container's submodules, in diffusers' registration order."""
    arch = architecture(**arch)
    check_img_size(img_size, **arch)
    if latent_dim_ != latent_dim(img_size, **arch):
        raise ValueError(
            "AutoencoderKL's latent_dim is 4 * H/8 * W/8 = {} for {} "
            "images, not {}".format(latent_dim(img_size, **arch), img_size,
                                    latent_dim_))
    lc = arch["latent_channels"]
    return {"encoder": Encoder(img_size[0], **arch),
            "decoder": Decoder(img_size[0], **arch),
            "quant_conv": precision.Conv2d(2 * lc, 2 * lc, 1, padding=0),
            "post_quant_conv": precision.Conv2d(lc, lc, 1, padding=0)}


def channels_last(x):
    """Whether the model turns its maps channels-last: where K5 takes the
    GroupNorms on the card (`precision.takes_group_norm_silu`), since K5
    and cuDNN's NHWC convs then keep that layout through every layer.
    Elsewhere the maps keep the layout they come in, as the plain
    reference's do: PyTorch's CUDA GroupNorm copies a channels-last map to
    NCHW, and on the CPU its convs and group norm sum a channels-last map
    in another order than an NCHW one."""
    return x.device.type == "cuda" and precision.takes_group_norm_silu(
        x.dtype, x.device.type)


def _maps(h):
    """h channels-last where `channels_last` says so (a copy only where h
    is not already), else as it is."""
    return h.contiguous(memory_format=torch.channels_last) \
        if channels_last(h) else h


def encode(vae, x):
    """(N, H, W, C) in [0, 1] -> (mean, clamped logvar), each (N,
    latent_dim) in the latent's NCHW order."""
    # contiguous NHWC images are a channels-last view already
    h = _maps(x.permute(0, 3, 1, 2) * 2 - 1)
    # a no-op but under the bf16 compute dtype (models/vae.py)
    moments = vae.quant_conv(vae.encoder(h)).float()
    mean, logvar = moments.chunk(2, dim=1)
    logvar = torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX)
    n = x.shape[0]
    return mean.reshape(n, -1), logvar.reshape(n, -1)


def decode(vae, z):
    """(N, latent_dim) -> (N, H, W, C), [-1, 1] mapped back to [0, 1]."""
    f = 2 ** (len(vae.decoder.up_blocks) - 1)
    h = z.view(z.shape[0], vae.post_quant_conv.in_channels,
               vae.img_size[1] // f, vae.img_size[2] // f)
    y = vae.decoder(vae.post_quant_conv(_maps(h))).float()
    return ((y + 1) / 2).permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(module, generator=None):
    """PyTorch's default initialisation, as LDM keeps it, drawn from
    `generator`: every conv and linear weight and bias U(+-1 /
    sqrt(fan_in)) (kaiming-uniform with a = sqrt(5)), GroupNorm's scale 1
    and shift 0."""
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(layer.weight[0].numel())
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(layer, nn.GroupNorm):
            layer.weight.fill_(1.0)
            layer.bias.zero_()
