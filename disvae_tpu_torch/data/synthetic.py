"""Synthetic factor-lattice rendering for offline metric runs.

Copied from disvae_tpu/data/synthetic.py (numpy only; importing it from the
JAX package would load JAX), over the port's `ArrayDataset`.

A reduced but structurally faithful dsprites lattice: binary 64x64 sprites
fully determined by (shape, scale, orientation, posX, posY), walked in
row-major factor order like the dsprites npz, so the MIG/AAM pipeline runs
end to end on fabricated data. Every factor slice is a balanced
sub-lattice, which the MIG normalization H(v_k) = log|V_k| assumes.
"""

import numpy as np

from disvae_tpu_torch.data.datasets import ArrayDataset

DEFAULT_LAT_SIZES = (3, 6, 10, 8, 8)
LAT_NAMES = ("shape", "scale", "orientation", "posX", "posY")


def render_factor_lattice(lat_sizes=DEFAULT_LAT_SIZES, img_size=64):
    """Render the full factor lattice as binary sprites.

    Returns a uint8 array of shape (prod(lat_sizes), img_size, img_size, 1)
    with values in {0, 1}, ordered row-major over
    (shape, scale, orientation, posX, posY) like the dsprites npz.
    Shapes are square / ellipse / diamond (stand-ins for dsprites'
    square / ellipse / heart); scale sets the sprite radius, orientation
    rotates the sprite frame, posX/posY move its center on a regular grid.
    """
    n_shape, n_scale, n_orient, n_px, n_py = lat_sizes
    if n_shape > 3:
        raise ValueError("only 3 shape prototypes are defined")
    H = W = int(img_size)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    # largest rotated extent is the square's half-diagonal 0.75*r*sqrt(2);
    # the margin keeps every sprite fully inside the frame
    r_of = lambda c: 5.0 + 6.0 * (c / max(n_scale - 1, 1))  # noqa: E731
    margin = int(np.ceil(0.75 * r_of(n_scale - 1) * np.sqrt(2))) + 1
    cxs = np.linspace(margin, W - 1 - margin, n_px, dtype=np.float32)
    cys = np.linspace(margin, H - 1 - margin, n_py, dtype=np.float32)
    # position block ordered (posX outer, posY inner) = lattice row-major
    cx = np.repeat(cxs, n_py)[:, None, None]  # (P, 1, 1)
    cy = np.tile(cys, n_px)[:, None, None]

    N = int(np.prod(lat_sizes))
    imgs = np.zeros((N, H, W, 1), np.uint8)
    P = n_px * n_py
    i = 0
    for s in range(n_shape):
        for c in range(n_scale):
            r = r_of(c)
            for o in range(n_orient):
                th = o * np.pi / n_orient
                dx, dy = xs[None] - cx, ys[None] - cy  # (P, H, W)
                u = dx * np.cos(th) + dy * np.sin(th)
                v = -dx * np.sin(th) + dy * np.cos(th)
                if s == 0:       # square
                    mask = np.maximum(np.abs(u), np.abs(v)) <= 0.75 * r
                elif s == 1:     # ellipse
                    mask = (u / r) ** 2 + (v / (0.55 * r)) ** 2 <= 1.0
                else:            # diamond
                    mask = np.abs(u) + np.abs(v) <= r
                imgs[i:i + P, :, :, 0] = mask
                i += P
    return imgs


class BinaryLatticeDataset(ArrayDataset):
    """ArrayDataset over a rendered lattice: stored values are {0, 1}
    (scale 1, like DSprites) and the bitpacked wire format applies."""

    _scale = 1.0
    is_binary = True


def lattice_dataset(lat_sizes=DEFAULT_LAT_SIZES, img_size=64):
    """Rendered lattice wrapped as a metrics-capable dataset (carries
    `lat_sizes` / `lat_names`, which the evaluator requires)."""
    imgs = render_factor_lattice(lat_sizes, img_size)
    return BinaryLatticeDataset(imgs, lat_sizes=lat_sizes,
                                lat_names=LAT_NAMES[:len(lat_sizes)])
