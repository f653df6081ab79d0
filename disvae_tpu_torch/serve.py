"""Serving surface: an inference bundle over a trained results directory.

Counterpart of disvae_tpu/serve.py `ServingModel` (:41-89), with the same
contract: numpy in, numpy out, images (N, H, W, C) float32 in [0, 1],
latents (N, latent_dim).

The JAX package padded every request to a fixed batch bucket so that XLA
never recompiled. PyTorch runs eagerly and compiles nothing per shape, so
requests run at their own size: there is no padding to strip, and outputs
equal an unpadded call by construction.

Export of the encoder/decoder (`export_artifacts`, StableHLO in the JAX
package) arrives later through `torch.export` (ROADMAP.md).

Usage:
    sm = ServingModel.from_dir("results/btcvae_dsprites", device="cuda")
    mu, logvar = sm.encode(images)
    imgs = sm.decode(mu)
"""

import numpy as np
import torch

from disvae_tpu_torch.utils.modelIO import load_model


class ServingModel:
    """Inference-only bundle: eval-mode encode/decode on one device."""

    def __init__(self, model):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @classmethod
    def from_dir(cls, directory, device=None):
        return cls(load_model(directory, device=device))

    def _in(self, array):
        return torch.from_numpy(np.asarray(array, np.float32)).to(self.device)

    @torch.no_grad()
    def encode(self, images):
        """(N, H, W, C) images -> (mu, logvar), each (N, latent_dim)."""
        mu, logvar = self.model.encode(self._in(images))
        return mu.cpu().numpy(), logvar.cpu().numpy()

    @torch.no_grad()
    def decode(self, latents):
        """(N, latent_dim) -> (N, H, W, C) images in (0, 1)."""
        return self.model.decode(self._in(latents)).cpu().numpy()

    @torch.no_grad()
    def reconstruct(self, images):
        """Mean (eval-mode) reconstruction decode(encode(x).mu), with the
        latents kept on the device."""
        mu, _ = self.model.encode(self._in(images))
        return self.model.decode(mu).cpu().numpy()

    def sample(self, n, seed=0):
        """Decode n prior draws. The draws come from a CPU
        `torch.Generator` seeded with `seed`, so a seed gives the same
        latents on every device."""
        gen = torch.Generator().manual_seed(seed)
        z = torch.randn((n, self.model.latent_dim), generator=gen)
        return self.decode(z.numpy())
