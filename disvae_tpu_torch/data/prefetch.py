"""Host -> device batch prefetching for the streaming training feed.

Counterpart of disvae_tpu/data/prefetch.py. A background thread gathers
each batch (memmap gather, wire format) and pins it; the consumer starts
its copy to the device without blocking, so batch assembly and the copy
overlap the device's work on earlier steps. PyTorch's pinned-memory
allocator keeps a pinned block alive until the copy that reads it has
finished.
"""

import queue
import threading

import numpy as np
import torch


class DevicePrefetcher:
    """Iterate a DataLoader's images on `device` with up to `depth` batches
    prepared ahead. Labels are dropped (the train step never reads them).
    An exception in the worker is raised at the consuming site."""

    def __init__(self, loader, device, depth=2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

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

        def worker():
            try:
                for imgs, _ in self.loader:
                    batch = torch.from_numpy(np.ascontiguousarray(imgs))
                    if pin:
                        batch = batch.pin_memory()
                    if not put(batch):
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
                yield item.to(self.device, non_blocking=pin)
        finally:
            stop.set()
            t.join(timeout=10)
