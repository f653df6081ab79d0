"""The torch thread budget of a test process: one place decides it.

pytest-xdist runs the suite in `PYTEST_XDIST_WORKER_COUNT` worker
processes on one machine. Left alone, torch gives each of them one
intra-op thread per core, so six workers on eight cores run 48 threads
that wait on each other. At import this module gives the process its
share of the cores, at least one thread; outside xdist that is every
core, so a file run alone keeps them all.

Every `tests/test_torch_*.py` imports this module before anything else.
An xdist worker imports every test module when it collects, so the
budget holds for every test the worker runs, the torch calls of the
JAX-era tests included, since they share the same cores.

Child processes take their share through `child_env`. A thread count
that pins a result (a reference that must sum in one order whatever the
machine's cores) is not a budget: it stays beside the code it pins.
"""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

torch.set_num_threads(THREADS)


def child_env(procs=1, **extra):
    """os.environ for `procs` child processes that run at once while this
    one waits: each gets an equal share of this process's threads through
    OMP_NUM_THREADS, which torch reads at start-up. `extra` is added on
    top."""
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, THREADS // procs)))
    env.update(extra)
    return env
