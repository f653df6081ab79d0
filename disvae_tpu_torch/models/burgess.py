"""Burgess et al. (2018) convolutional encoder and decoder as nn.Modules.

Counterpart of disvae_tpu/models/burgess.py (`apply_encoder` :62-87,
`apply_decoder` :128-150; reference disvae/models/encoders.py:16-89,
decoders.py:16-84): 3 (or 4 for 64x64) stride-2 k4 convs with 32 channels
and ReLU, two 256-unit linear layers, a 2 * latent_dim head split into
interleaved (mu, logvar) pairs; the decoder mirrors it with a final sigmoid.
Every layer is an ops/precision.py module, so the precision policy decides
its numerics, as it does for `disvae_tpu.ops.convs` in JAX.

The public layout is the JAX package's: images NHWC float32 in [0, 1].
Inside, the convolutions run NCHW with the reference's parameter names
(`conv1` ... `convT3`), so state dicts are the reference's.
"""

import torch
import torch.nn.functional as F
from torch import nn

from disvae_tpu_torch.models.initialization import weights_init
from disvae_tpu_torch.ops import precision

HID_CHANNELS = 32
KERNEL = 4
HIDDEN_DIM = 256
BOTTLENECK_HW = 4
BOTTLENECK_FLAT = HID_CHANNELS * BOTTLENECK_HW * BOTTLENECK_HW  # 512


def _is_64(img_size):
    if list(img_size[1:]) not in ([32, 32], [64, 64]):
        raise RuntimeError(
            "{} sized images not supported. Only (None, 32, 32) and "
            "(None, 64, 64) supported. Build your own architecture or "
            "reshape images!".format(img_size))
    return img_size[1] == img_size[2] == 64


def _conv(cin, cout):
    return precision.Conv2d(cin, cout, KERNEL, stride=2, padding=1)


def _convT(cin, cout):
    return precision.ConvTranspose2d(cin, cout, KERNEL, stride=2, padding=1)


def conv_transpose2d(x, w, b):
    """The k4 s2 p1 transposed conv of every decoder layer, under the
    precision policy."""
    return precision.conv_transpose2d(x, w, b)


# Implementation of the FINAL transposed conv only (Cout = n_chan <= 3;
# disvae_tpu/models/burgess.py:112-125). The forward is the same either way;
# ops/convt_bwd.py `conv_transpose2d_pl` swaps in the K1/K2 backward kernels,
# which run under the ``default`` precision policy. One implementation per
# process, chosen before training.
_convT_final = conv_transpose2d


def set_final_convt_impl(fn):
    """A/B hook: replace the final decoder convT implementation, a callable
    (x, w, b) -> y (e.g. ops.convt_bwd.conv_transpose2d_pl)."""
    global _convT_final
    _convT_final = fn


class Encoder(nn.Module):
    """x (N, H, W, C) -> (mu, logvar), each (N, latent_dim) float32."""

    def __init__(self, img_size, latent_dim=10):
        super().__init__()
        is_64 = _is_64(img_size)
        self.latent_dim = latent_dim
        self.conv1 = _conv(img_size[0], HID_CHANNELS)
        self.conv2 = _conv(HID_CHANNELS, HID_CHANNELS)
        self.conv3 = _conv(HID_CHANNELS, HID_CHANNELS)
        self.conv_64 = _conv(HID_CHANNELS, HID_CHANNELS) if is_64 else None
        self.lin1 = precision.Linear(BOTTLENECK_FLAT, HIDDEN_DIM)
        self.lin2 = precision.Linear(HIDDEN_DIM, HIDDEN_DIM)
        self.mu_logvar_gen = precision.Linear(HIDDEN_DIM, latent_dim * 2)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        if self.conv_64 is not None:
            h = F.relu(self.conv_64(h))
        # torch (N, C, H, W) element order, as burgess.py:78-80 flattens
        h = h.reshape(h.shape[0], -1)
        h = F.relu(self.lin1(h))
        h = F.relu(self.lin2(h))
        # a no-op but under the bf16 compute dtype (models/vae.py)
        mu_logvar = self.mu_logvar_gen(h).float()
        # interleaved (mu, logvar) pairs (burgess.py:84-87)
        mu, logvar = mu_logvar.view(-1, self.latent_dim, 2).unbind(-1)
        return mu, logvar


class Decoder(nn.Module):
    """z (N, latent_dim) -> images (N, H, W, C) in (0, 1), float32."""

    def __init__(self, img_size, latent_dim=10):
        super().__init__()
        is_64 = _is_64(img_size)
        self.lin1 = precision.Linear(latent_dim, HIDDEN_DIM)
        self.lin2 = precision.Linear(HIDDEN_DIM, HIDDEN_DIM)
        self.lin3 = precision.Linear(HIDDEN_DIM, BOTTLENECK_FLAT)
        self.convT_64 = _convT(HID_CHANNELS, HID_CHANNELS) if is_64 else None
        self.convT1 = _convT(HID_CHANNELS, HID_CHANNELS)
        self.convT2 = _convT(HID_CHANNELS, HID_CHANNELS)
        self.convT3 = _convT(HID_CHANNELS, img_size[0])

    def forward(self, z):
        h = F.relu(self.lin1(z))
        h = F.relu(self.lin2(h))
        h = F.relu(self.lin3(h))
        # un-flatten in torch element order (burgess.py:137-139)
        h = h.view(-1, HID_CHANNELS, BOTTLENECK_HW, BOTTLENECK_HW)
        if self.convT_64 is not None:
            h = F.relu(self.convT_64(h))
        h = F.relu(self.convT1(h))
        h = F.relu(self.convT2(h))
        h = _convT_final(h, self.convT3.weight, self.convT3.bias)
        h = torch.sigmoid(h.float())
        return h.permute(0, 2, 3, 1)  # NCHW -> NHWC


def parts(img_size, latent_dim):
    """The VAE container's submodules (models/vae.py); they check the
    image size."""
    return {"encoder": Encoder(img_size, latent_dim),
            "decoder": Decoder(img_size, latent_dim)}


def encode(vae, x):
    return vae.encoder(x)


def decode(vae, z):
    return vae.decoder(z)


# the reference repository's initialisation (models/initialization.py)
init_weights = weights_init
