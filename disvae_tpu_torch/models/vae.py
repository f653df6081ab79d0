"""VAE container (disvae_tpu/models/vae.py; reference disvae/models/vae.py).

`model_type` names the architecture (`MODELS`): the Burgess et al. (2018)
conv VAE (models/burgess.py) or Stable Diffusion's kl-f8 autoencoder
(models/autoencoder_kl.py), each checking the image size it takes.
forward -> (reconstruction, (mu, logvar), latent_sample). `encode` gives
(N, latent_dim) mu and logvar, `decode` NHWC images. `reparameterize`
returns the mean in eval mode and mu + sigma * eps in train mode, with
eps given (pinned noise) or drawn from an explicit `torch.Generator`.
`compute_dtype` is JAX's (disvae_tpu/models/vae.py:45-50): "float32" runs
the layers under the precision policy (ops/precision.py); "bfloat16" runs
the encoder and decoder in bf16 autocast (bf16 activations, weights and
layer outputs) under any policy. Their outputs are float32 either way.

While a profiler records, `vae.encode` and `vae.decode` are spans
(utils/trace.py).
"""

import torch
from torch import nn

from disvae_tpu_torch.models import autoencoder_kl, burgess
from disvae_tpu_torch.utils.trace import span

_ARCHITECTURES = {"Burgess": burgess, "AutoencoderKL": autoencoder_kl}
MODELS = list(_ARCHITECTURES)
COMPUTE_DTYPES = ["float32", "bfloat16"]


def model_name(model_type):
    """The name in MODELS that `model_type` matches, case aside."""
    names = {m.lower(): m for m in MODELS}
    try:
        return names[model_type.lower()]
    except KeyError:
        raise ValueError("Unknown model_type={}. Possible values: {}"
                         .format(model_type, MODELS)) from None


def derived_latent_dim(model_type, img_size):
    """The latent size the architecture fixes for `img_size` (kl-f8's 4 *
    H/8 * W/8), or None where it is free (Burgess)."""
    arch = _ARCHITECTURES[model_name(model_type)]
    return (arch.latent_dim(img_size) if hasattr(arch, "latent_dim")
            else None)


def init_specific_model(model_type, img_size, latent_dim, generator=None,
                        device=None, compute_dtype="float32", **arch):
    """Build a `model_type` VAE with its architecture's initialisation,
    drawn from `generator` (disvae_tpu vae.py:21-37); `arch` are the
    architecture's widths where it takes any (AutoencoderKL)."""
    model_type = model_name(model_type)
    model = VAE(tuple(img_size), latent_dim, model_type, compute_dtype,
                **arch)
    _ARCHITECTURES[model_type].init_weights(model, generator)
    return model.to(device) if device is not None else model


class VAE(nn.Module):
    """A VAE over NHWC images; img_size metadata is (C, H, W)."""

    def __init__(self, img_size, latent_dim=10, model_type="Burgess",
                 compute_dtype="float32", **arch):
        super().__init__()
        model_type = model_name(model_type)
        module = _ARCHITECTURES[model_type]
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError("Unknown compute_dtype={}. Possible values: {}"
                             .format(compute_dtype, COMPUTE_DTYPES))
        self.img_size = tuple(img_size)
        self.latent_dim = latent_dim
        self.model_type = model_type
        self.compute_dtype = compute_dtype
        # validates the image size
        for name, part in module.parts(self.img_size, latent_dim,
                                       **arch).items():
            setattr(self, name, part)
        self._encode, self._decode = module.encode, module.decode

    def _autocast(self, t):
        return torch.autocast(t.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == "bfloat16")

    def encode(self, x):
        """(N, H, W, C) -> (mu, logvar), each (N, latent_dim)."""
        with span("vae.encode"), self._autocast(x):
            return self._encode(self, x)

    def decode(self, z):
        """(N, latent_dim) -> (N, H, W, C) images."""
        with span("vae.decode"), self._autocast(z):
            return self._decode(self, z)

    def reparameterize(self, mean, logvar, generator=None, eps=None):
        """Train: mean + exp(logvar / 2) * eps, with eps given or drawn from
        `generator`; eval: mean."""
        if not self.training:
            return mean
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              dtype=mean.dtype, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps

    def forward(self, x, generator=None, eps=None):
        mean, logvar = self.encode(x)
        z = self.reparameterize(mean, logvar, generator, eps)
        return self.decode(z), (mean, logvar), z

    def sample_latent(self, x, generator=None, eps=None):
        mean, logvar = self.encode(x)
        return self.reparameterize(mean, logvar, generator, eps)
