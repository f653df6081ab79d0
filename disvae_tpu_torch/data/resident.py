"""Device-resident dataset: the wire-format images go to the device ONCE,
and epochs feed it by index.

Counterpart of disvae_tpu/data/resident.py. The streaming feed copies the
whole dataset host -> device every epoch (celeba: 2.4 GB of uint8 wire);
with residency each epoch copies only its permutation and every batch is
an index_select at device-memory bandwidth.

The wire format is the streaming feed's (bitpacked rows for binary
datasets, scaled uint8 otherwise), so the train step's on-device
decompression (train/steps.py `_decompress_batch`) is shared and the fed
pixel values are bit-identical to the streaming feed.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Residency budget of the `auto` policy, as in the JAX package.
DEFAULT_LIMIT_BYTES = 6_000_000_000


def wire_shape(dataset):
    """Shape of the dataset's wire-format array: (N, row_bytes) bitpacked
    rows for binary datasets, the raw (N, H, W, C) uint8 array
    otherwise."""
    n = len(dataset)
    if getattr(dataset, "is_binary", False):
        c, h, w = dataset.img_size
        return (n, (h * w * c + 7) // 8)
    return tuple(dataset.imgs.shape)


def wire_nbytes(dataset):
    """Bytes the dataset occupies in wire format (bitpacked or uint8)."""
    return int(np.prod(wire_shape(dataset)))


class ResidentData:
    """The dataset's wire-format array as one uint8 tensor on `device`:
    (N, n_bytes) for binary datasets (np.packbits rows), (N, H, W, C)
    otherwise — exactly what DataLoader(raw=True) would stream."""

    # Upload chunk: each piece is packed/scaled on the host and copied from
    # pinned memory without blocking, so chunk i+1's host work overlaps
    # chunk i's copy and the full unpacked dataset never materializes.
    CHUNK_BYTES = 64 << 20

    def __init__(self, dataset, device):
        device = torch.device(device)
        n = len(dataset)
        binary = bool(getattr(dataset, "is_binary", False))
        shape = wire_shape(dataset)
        row_bytes = int(np.prod(shape[1:]))
        mul = 1 if binary else int(round(255 * dataset._scale))
        pin = device.type == "cuda"

        def host_chunk(lo, hi):
            piece = np.asarray(dataset.imgs[lo:hi], np.uint8)
            if binary:
                return np.packbits(piece.reshape(hi - lo, -1), axis=1)
            # a writable copy: memmap slices are read-only
            return (piece * mul).astype(np.uint8)

        wire = torch.empty(shape, dtype=torch.uint8, device=device)
        rows_per_chunk = max(1, self.CHUNK_BYTES // max(1, row_bytes))
        n_chunks = 0
        for i in range(0, n, rows_per_chunk):
            hi = min(n, i + rows_per_chunk)
            piece = torch.from_numpy(host_chunk(i, hi))
            if pin:
                # the pinned block stays allocated until its copy is done
                piece = piece.pin_memory()
            wire[i:hi].copy_(piece, non_blocking=pin)
            n_chunks += 1
        self.wire = wire
        self.n = n
        logger.info("Resident dataset: %d images, %.0f MB wire on %s "
                    "(%d-chunk upload).", n, n * row_bytes / 1e6, device,
                    n_chunks)

    @classmethod
    def maybe(cls, dataset, device, limit_bytes=DEFAULT_LIMIT_BYTES):
        """Residency if the dataset fits the budget and exposes a raw uint8
        store; None otherwise (the streaming feed takes over)."""
        imgs = getattr(dataset, "imgs", None)
        if imgs is None or getattr(imgs, "dtype", None) != np.uint8:
            return None
        if wire_nbytes(dataset) > limit_bytes:
            return None
        return cls(dataset, device)
