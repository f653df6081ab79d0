"""VAE container (disvae_tpu/models/vae.py; reference disvae/models/vae.py).

forward -> (reconstruction, (mu, logvar), latent_sample). `reparameterize`
returns the mean in eval mode and mu + sigma * eps in train mode, with eps
drawn from an explicit `torch.Generator`. Under the ``default`` precision
policy the encoder and decoder run in bf16 autocast; their outputs are
float32 either way (ops/precision.py).
"""

import torch
from torch import nn

from disvae_tpu_torch.models import burgess
from disvae_tpu_torch.models.initialization import weights_init
from disvae_tpu_torch.ops import precision

MODELS = ["Burgess"]


def init_specific_model(model_type, img_size, latent_dim, generator=None,
                        device=None):
    """Build a `model_type` VAE with the reference's initialisation, drawn
    from `generator` (disvae_tpu vae.py:21-37)."""
    model_type = model_type.lower().capitalize()
    if model_type not in MODELS:
        raise ValueError("Unknown model_type={}. Possible values: {}"
                         .format(model_type, MODELS))
    model = VAE(tuple(img_size), latent_dim, model_type)
    weights_init(model, generator)
    return model.to(device) if device is not None else model


class VAE(nn.Module):
    """Burgess VAE over NHWC images; img_size metadata is (C, H, W)."""

    def __init__(self, img_size, latent_dim=10, model_type="Burgess"):
        super().__init__()
        burgess._is_64(img_size)  # validates 32^2 / 64^2
        self.img_size = tuple(img_size)
        self.latent_dim = latent_dim
        self.model_type = model_type
        self.encoder = burgess.Encoder(img_size, latent_dim)
        self.decoder = burgess.Decoder(img_size, latent_dim)

    def encode(self, x):
        """(N, H, W, C) -> (mu, logvar), each (N, latent_dim)."""
        with precision.autocast(x.device.type):
            return self.encoder(x)

    def decode(self, z):
        """(N, latent_dim) -> (N, H, W, C) in (0, 1)."""
        with precision.autocast(z.device.type):
            return self.decoder(z)

    def reparameterize(self, mean, logvar, generator=None):
        """Train: mean + exp(logvar / 2) * eps; eval: mean."""
        if not self.training:
            return mean
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps

    def forward(self, x, generator=None):
        mean, logvar = self.encode(x)
        z = self.reparameterize(mean, logvar, generator)
        return self.decode(z), (mean, logvar), z

    def sample_latent(self, x, generator=None):
        mean, logvar = self.encode(x)
        return self.reparameterize(mean, logvar, generator)
