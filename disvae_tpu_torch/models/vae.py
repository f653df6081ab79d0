"""VAE container (disvae_tpu/models/vae.py; reference disvae/models/vae.py).

forward -> (reconstruction, (mu, logvar), latent_sample). `reparameterize`
returns the mean in eval mode and mu + sigma * eps in train mode, with eps
given (pinned noise) or drawn from an explicit `torch.Generator`.
`compute_dtype` is JAX's (disvae_tpu/models/vae.py:45-50): "float32" runs
the layers under the precision policy (ops/precision.py); "bfloat16" runs
the encoder and decoder in bf16 autocast (bf16 activations, weights and
layer outputs) under any policy. Their outputs are float32 either way.
"""

import torch
from torch import nn

from disvae_tpu_torch.models import burgess
from disvae_tpu_torch.models.initialization import weights_init

MODELS = ["Burgess"]
COMPUTE_DTYPES = ["float32", "bfloat16"]


def init_specific_model(model_type, img_size, latent_dim, generator=None,
                        device=None, compute_dtype="float32"):
    """Build a `model_type` VAE with the reference's initialisation, drawn
    from `generator` (disvae_tpu vae.py:21-37)."""
    model_type = model_type.lower().capitalize()
    if model_type not in MODELS:
        raise ValueError("Unknown model_type={}. Possible values: {}"
                         .format(model_type, MODELS))
    model = VAE(tuple(img_size), latent_dim, model_type, compute_dtype)
    weights_init(model, generator)
    return model.to(device) if device is not None else model


class VAE(nn.Module):
    """Burgess VAE over NHWC images; img_size metadata is (C, H, W)."""

    def __init__(self, img_size, latent_dim=10, model_type="Burgess",
                 compute_dtype="float32"):
        super().__init__()
        burgess._is_64(img_size)  # validates 32^2 / 64^2
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError("Unknown compute_dtype={}. Possible values: {}"
                             .format(compute_dtype, COMPUTE_DTYPES))
        self.img_size = tuple(img_size)
        self.latent_dim = latent_dim
        self.model_type = model_type
        self.compute_dtype = compute_dtype
        self.encoder = burgess.Encoder(img_size, latent_dim)
        self.decoder = burgess.Decoder(img_size, latent_dim)

    def _autocast(self, t):
        return torch.autocast(t.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == "bfloat16")

    def encode(self, x):
        """(N, H, W, C) -> (mu, logvar), each (N, latent_dim)."""
        with self._autocast(x):
            return self.encoder(x)

    def decode(self, z):
        """(N, latent_dim) -> (N, H, W, C) in (0, 1)."""
        with self._autocast(z):
            return self.decoder(z)

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
