"""Serving surface: an inference bundle over a trained results directory.

Counterpart of disvae_tpu/serve.py `ServingModel` (:41-89), with the same
contract: numpy in, numpy out, images (N, H, W, C) float32 in [0, 1],
latents (N, latent_dim).

The JAX package padded every request to a fixed batch bucket so that XLA
never recompiled. PyTorch runs eagerly and compiles nothing per shape, so
requests run at their own size: there is no padding to strip, and outputs
equal an unpadded call by construction.

`export_artifacts` / `load_artifact` (disvae_tpu/serve.py:92-128, StableHLO
through `jax.export` there) write the encoder and decoder as `torch.export`
programs at a fixed batch, `encoder.pt2` and `decoder.pt2` next to the
checkpoint. They hold the weights and run without this package's model
code: `load_artifact(path)(x)`.

Both entry points run on the GPU, as the JAX ones run on the default
accelerator: without a `device` they take CUDA, and raise when no GPU is
visible. The CPU serves only a caller who asks for it (`device="cpu"`,
`--no-cuda`).

Usage:
    sm = ServingModel.from_dir("results/btcvae_dsprites")
    mu, logvar = sm.encode(images)
    imgs = sm.decode(mu)
    export_artifacts("results/btcvae_dsprites", batch_size=64)
    python -m disvae_tpu_torch.serve btcvae_dsprites [-b 64] [--no-cuda]
"""

import os
import sys

import numpy as np
import torch
from torch import nn

from disvae_tpu_torch.ops import precision
from disvae_tpu_torch.utils.helpers import get_device
from disvae_tpu_torch.utils.modelIO import load_model


class ServingModel:
    """Inference-only bundle: eval-mode encode/decode on one device."""

    def __init__(self, model):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @classmethod
    def from_dir(cls, directory, device=None):
        """The bundle of a results directory on `device`: CUDA when None,
        raising when no GPU is visible."""
        if device is None:
            device = get_device(False)
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


class _Encode(nn.Module):
    def __init__(self, vae):
        super().__init__()
        self.vae = vae

    def forward(self, x):
        return self.vae.encode(x)


class _Decode(_Encode):
    def forward(self, z):
        return self.vae.decode(z)


def export_artifacts(directory, batch_size=64, out_dir=None, device=None):
    """Export the trained encoder ((B, H, W, C) -> (mu, logvar)) and decoder
    ((B, latent_dim) -> (B, H, W, C)) of a results directory at batch
    `batch_size` on `device` (CUDA when None, raising when no GPU is
    visible), traced under the `highest` precision policy (float32, no
    autocast), as `encoder.pt2` and `decoder.pt2`. Returns their paths."""
    if device is None:
        device = get_device(False)
    model = load_model(directory, device=device)
    device = next(model.parameters()).device
    out_dir = out_dir or directory
    c, h, w = model.img_size
    specs = {
        "encoder.pt2": (_Encode(model), torch.zeros((batch_size, h, w, c),
                                                    device=device)),
        "decoder.pt2": (_Decode(model),
                        torch.zeros((batch_size, model.latent_dim),
                                    device=device)),
    }
    before = precision.current()
    precision.configure("highest")
    paths = []
    try:
        for name, (module, example) in specs.items():
            program = torch.export.export(module, (example,), strict=False)
            path = os.path.join(out_dir, name)
            torch.export.save(program, path)
            paths.append(path)
    finally:
        precision.configure(before)
    return paths


def load_artifact(path):
    """Load an exported `.pt2` program as a callable module."""
    return torch.export.load(path).module()


def _main(argv):
    import argparse
    parser = argparse.ArgumentParser(
        description="Export a trained run's encoder/decoder as torch.export "
                    "serving artifacts.")
    parser.add_argument("name", help="run name under results/")
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("--res-dir", default="results")
    parser.add_argument("--no-cuda", action="store_true",
                        help="Export on the CPU. Without it a CUDA device is "
                             "required.")
    args = parser.parse_args(argv)
    paths = export_artifacts(os.path.join(args.res_dir, args.name),
                             batch_size=args.batch_size,
                             device=get_device(args.no_cuda))
    for p in paths:
        print(p)


if __name__ == "__main__":
    _main(sys.argv[1:])
