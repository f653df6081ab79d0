"""Named spans of the program's host work, on the profiler's clock.

`with span("eval.feed"): ...` brackets one piece of work. While a torch
profiler records (`torch.profiler.profile`, the CLI's `--profile`, a
benchmark's traced run), the span opens a `record_function` range named
"disvae::<name>", so the trace shows it among the host events, with its
start, end and parent, on the clock of the device's events; and it adds
its call and its wall seconds to a module tally, `tally()`. While none
records, a span asks `_profiler_enabled()` once and does nothing else.

The answer is taken at `__enter__` and kept until `__exit__`, so a span
that straddles the profiler's start or stop is either recorded whole or
not at all. Spans nest by containment and are opened on the main thread
only (the tally is not locked). A span is host-only: it issues nothing to
the device and may sit around a CUDA graph capture or replay.

`count("wgrad.f32")` adds one to a counter of the module's tally of
counts, `counts()`, whether or not a profiler records: a counter counts
what the host decides at a call (which route a layer takes), once per
call, so a CUDA graph's replays, which call nothing, add nothing.
"""

import time

import torch
from torch._C._autograd import _profiler_enabled

PREFIX = "disvae::"

# {name: [calls, seconds]} of the spans recorded since start or reset()
_TALLY = {}
# {name: calls} of the counters since start or reset()
_COUNTS = {}


class span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            seconds = (time.perf_counter_ns() - self._t0) * 1e-9
            self._range.__exit__(*exc)
            self._range = None
            entry = _TALLY.setdefault(self.name, [0, 0.0])
            entry[0] += 1
            entry[1] += seconds
        return False


def tally():
    """{name: (calls, seconds)} of the spans recorded so far."""
    return {k: (v[0], v[1]) for k, v in _TALLY.items()}


def count(name, n=1):
    """Add `n` to counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts():
    """{name: calls} of the counters so far."""
    return dict(_COUNTS)


def reset():
    _TALLY.clear()
    _COUNTS.clear()
