"""What the benchmark makes from `--seed` and hands to the program and to
the reference alike: weights and images.

Everything is drawn on the run's device from a `torch.Generator` seeded
there, in a few large calls, and copied to the host only where the
program takes host arrays (its datasets).
"""

import math

import numpy as np
import torch

from reference.model import param_spec
from reference.seeds import derive_seeds


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(int(seed))


def vae_weights(img_size, latent_dim, seed, device):
    """The Burgess VAE's parameters, drawn as the reference repository
    initialises them (weights kaiming-uniform with the ReLU gain,
    U(+-sqrt(6 / fan_in)); biases U(+-1 / sqrt(fan_in))), from one uniform
    draw over all of them. Returns {name: float32 tensor on device}."""
    spec = param_spec(img_size, latent_dim)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=generator(device, seed))
    out, i = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        bound = (math.sqrt(6.0 / fan_in) if name.endswith(".weight")
                 else 1.0 / math.sqrt(fan_in))
        out[name] = (flat[i:i + n] * bound).view(shape)
        i += n
    return out


def uint8_images(n, img_size, seed, device, chunk=1 << 14):
    """n images (n, H, W, C) of uniform uint8 pixels, as a host array."""
    c, h, w = img_size
    gen = generator(device, seed)
    out = np.empty((n, h, w, c), np.uint8)
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        out[i:j] = torch.randint(0, 256, (j - i, h, w, c), generator=gen,
                                 dtype=torch.uint8,
                                 device=device).cpu().numpy()
    return out


def sprite_lattice(lat_sizes, device, side=64, patch=30, ss=4):
    """The dSprites factor lattice (shape, scale, orientation, posX, posY)
    rendered as binary side x side sprites, in the dataset's row-major
    factor order: square, ellipse and heart silhouettes supersampled
    `ss` times on a `patch` canvas and thresholded, then placed at the
    lattice's x and y offsets. Returns a host uint8 (N, side, side, 1)
    array of {0, 1}. The same for every seed, as the dataset is."""
    n_shape, n_scale, n_orient, n_x, n_y = (int(s) for s in lat_sizes)
    k = patch * ss
    ax = torch.linspace(-1.5, 1.5, k, device=device, dtype=torch.float64)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    scale = torch.linspace(0.5, 1.0, n_scale, device=device,
                           dtype=torch.float64)
    orient = torch.linspace(0.0, 2 * math.pi, n_orient, device=device,
                            dtype=torch.float64)
    cos = torch.cos(orient)[None, :, None, None]
    sin = torch.sin(orient)[None, :, None, None]
    sc = scale[:, None, None, None]
    u = (cos * xx + sin * yy) / sc          # (scale, orient, k, k)
    v = (-sin * xx + cos * yy) / sc
    hu, hv = u / 0.8, -v / 0.8
    masks = torch.stack([
        (u.abs() <= 0.75) & (v.abs() <= 0.75),                     # square
        (u / 0.9) ** 2 + (v / 0.55) ** 2 <= 1.0,                   # ellipse
        (hu ** 2 + hv ** 2 - 1) ** 3 - hu ** 2 * hv ** 3 <= 0,     # heart
    ])[:n_shape]
    frac = masks.to(torch.float32).reshape(
        n_shape, n_scale, n_orient, patch, ss, patch, ss).mean(dim=(4, 6))
    patches = (frac >= 0.5).to(torch.uint8).reshape(-1, patch, patch)
    # a zero row and column at index `patch` for the pixels off the sprite
    padded = torch.zeros((patches.shape[0], patch + 1, patch + 1),
                         dtype=torch.uint8, device=device)
    padded[:, :patch, :patch] = patches

    def rows_of(n_pos):
        off = torch.round(torch.linspace(0, 1, n_pos, device=device,
                                         dtype=torch.float64)
                          * (side - patch)).long()
        r = torch.arange(side, device=device)[None, :] - off[:, None]
        return torch.where((r >= 0) & (r < patch), r, patch)  # (n_pos, side)

    rx, ry = rows_of(n_x), rows_of(n_y)
    out = np.empty((padded.shape[0] * n_x * n_y, side, side, 1), np.uint8)
    per = n_x * n_y
    for p in range(padded.shape[0]):
        # image (ix, iy): pixel (y, x) = patch[y - off[iy], x - off[ix]]
        img = padded[p][ry[None, :, :, None], rx[:, None, None, :]]
        out[p * per:(p + 1) * per, ..., 0] = img.reshape(
            per, side, side).cpu().numpy()
    return out


def seed32(seed):
    """A seed for numpy's RandomState, which takes 32 bits."""
    return derive_seeds(seed, 1)[0] % (1 << 32)
