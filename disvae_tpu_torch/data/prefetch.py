"""Host -> device batch prefetching for the streaming training feed.

Counterpart of disvae_tpu/data/prefetch.py. A background thread gathers
each batch (memmap gather, wire format) and pins it; the consumer starts
its copy to the device without blocking, so batch assembly and the copy
overlap the device's work on earlier steps. PyTorch's pinned-memory
allocator keeps a pinned block alive until the copy that reads it has
finished.

Under a mesh each rank prefetches only its rows of every global batch
(disvae_tpu/data/prefetch.py:31-35, 120-130): a host-sliced loader
(`DataLoader(host_slice=..., pad_global_to=...)`) already yields them;
from any other loader the prefetcher pads each global batch to the
data-axis multiple (repeating row 0) and takes this rank's share.
"""

import queue
import threading

import numpy as np
import torch

from disvae_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch


class DevicePrefetcher:
    """Iterate `(images, n_valid)` pairs of a DataLoader on `device` with
    up to `depth` batches prepared ahead. Labels are dropped (the train
    step never reads them). `n_valid` is None for a full batch and the
    true global size of a batch padded for `mesh`. An exception in the
    worker is raised at the consuming site."""

    def __init__(self, loader, device, depth=2, mesh=None):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.mesh = mesh

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()  # consumer gone: the worker must not block
        end = object()
        pin = self.device.type == "cuda"

        def put(item):
            """Bounded put that gives up once the consumer left: a break or
            exception mid-epoch must not leave the worker blocked on a full
            queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        mesh = self.mesh
        global_sizes = None
        if mesh is not None and getattr(self.loader, "host_slice", None):
            global_sizes = self.loader.global_batch_sizes()

        def worker():
            try:
                for bi, (imgs, _) in enumerate(self.loader):
                    n_valid = None
                    if mesh is not None:
                        if global_sizes is not None:  # the rank's share
                            true_n = global_sizes[bi]
                        else:  # the global batch
                            imgs, true_n = pad_to_multiple(
                                imgs, mesh.data_size)
                            imgs = shard_batch(imgs, mesh)
                        if imgs.shape[0] * mesh.data_size != true_n:
                            n_valid = true_n
                    batch = torch.from_numpy(np.ascontiguousarray(imgs))
                    if pin:
                        batch = batch.pin_memory()
                    if not put((batch, n_valid)):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                put(e)
                return
            put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, n_valid = item
                yield batch.to(self.device, non_blocking=pin), n_valid
        finally:
            stop.set()
            t.join(timeout=10)
