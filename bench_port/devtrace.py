"""The traced run's profile: the device's busy time, its kernels by name
and what the host was doing while the device sat idle.

The window runs under the PyTorch profiler (kineto, CPU and CUDA
activities). Its raw events are read as they come, without building the
profiler's event tree, which takes minutes for the thousands of steps of
a training window.
"""

import heapq
from collections import defaultdict

import torch

_DEVICE = torch.autograd.DeviceType.CUDA


class Profile:
    """Collects the raw profiler events of the code run inside `with`."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events = []

    def __enter__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import _enable_profiler, _prepare_profiler
        from torch.autograd.profiler import (ProfilerActivity,
                                             ProfilerConfig, ProfilerState)
        acts = {ProfilerActivity.CPU}
        if self.cuda:
            acts.add(ProfilerActivity.CUDA)
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False, _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        if self.cuda:
            torch.cuda.synchronize()
        self.events = _disable_profiler().events()
        return False


def summarize(events, top=10):
    """Reduce raw events: {"busy_s": union of the device's intervals,
    "kernels": {name: [seconds, count]}, "device_ops": the `top` device
    operations by time, "idle_gaps": the device's idle time between its
    first and last operation grouped by the innermost host event running
    at each gap's middle, the `top` groups by time}."""
    dev, host = [], []
    for e in events:
        if e.device_type() == _DEVICE:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    kernels = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += (b - a) * 1e-9
        k[1] += 1
    dev.sort()
    busy, end, gaps = 0, None, []
    for a, b, _ in dev:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    idle = defaultdict(float)
    for (lo, hi), name in zip(gaps, _innermost(host, gaps)):
        idle[name] += (hi - lo) * 1e-9
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy * 1e-9,
            "kernels": dict(kernels),
            "device_ops": [[n, v[0]] for n, v in by_time[:top]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def _innermost(host, gaps):
    """For each gap (in time order), the name of the latest-starting host
    event that spans the gap's middle, or "host code outside torch ops"."""
    host = sorted(host)
    names, heap, i = [], [], 0
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        while i < len(host) and host[i][0] <= mid:
            a, b, name = host[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "host code outside torch ops")
    return names


def kernel_time(summary, *parts):
    """(seconds, launches) of the device operations whose names hold any
    of `parts`."""
    s = n = 0
    for name, (sec, count) in summary["kernels"].items():
        if any(p in name for p in parts):
            s += sec
            n += count
    return s, n
