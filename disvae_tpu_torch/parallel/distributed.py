"""The process group of a data-parallel run (torch.distributed).

Counterpart of disvae_tpu/parallel/distributed.py. The JAX package forms
one runtime over all hosts and lets GSPMD insert the collectives; the port
runs one process per GPU, each on `cuda:LOCAL_RANK`, and its train step
calls the collectives itself (parallel/mesh.py):

    torchrun --nproc_per_node N -m disvae_tpu_torch <name> ...

    from disvae_tpu_torch.parallel import distributed, mesh
    distributed.initialize()        # no-op without the launcher's environment
    m = mesh.create_mesh()          # data axis = the world size
    ... Trainer(..., mesh=m)

Each rank feeds only its share of every global batch. The feeding contract
lives in the data pipeline: `DataLoader(host_slice=(rank, world_size),
pad_global_to=world_size)` pads each global batch's index list to the
data-axis multiple and splits it into equal contiguous shares (the same
(seed, epoch)-keyed permutation on every rank, pad rows at the global end,
true sizes from `global_batch_sizes()`). `local_batch_slice` below is the
simpler divisible-batch helper for callers that feed themselves.
"""

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# what torchrun (or any launcher) sets for every rank
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


def initialize(cuda=True, timeout=None):
    """Form the process group from the launcher's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`). Returns True
    when a group is up.

    Without `WORLD_SIZE` in the environment this is a no-op (a
    single-process run) and returns False. Idempotent: a group that is
    already up is kept. With `cuda` the rank's device `cuda:LOCAL_RANK`
    becomes the current device and the backend is NCCL, initialised
    eagerly on that device, so a failed NCCL init raises here; there is no
    fallback to gloo or to a single process. gloo serves `cuda=False`
    (`--no-cuda`) only. `timeout` (a timedelta) bounds each collective.
    """
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError("WORLD_SIZE is set but {} is not: launch with "
                           "torchrun".format(", ".join(missing)))
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    kwargs = {} if timeout is None else {"timeout": timeout}
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("rank {}: no CUDA device is visible; pass "
                               "--no-cuda to run over gloo on the CPU"
                               .format(rank))
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", rank=rank, world_size=world_size,
                                device_id=device, **kwargs)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world_size,
                                **kwargs)
    logger.info("distributed: rank %d of a %d-rank group (local rank %d), "
                "backend %s", rank, world_size, local_rank,
                dist.get_backend())
    return True


def shutdown():
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(name):
    """Block until every rank reaches this point (no-op without a group).
    Orders host-side filesystem effects across ranks: rank 0 creates or
    archives the results dir before the others use it, the final model is
    on disk before any rank loads it, and no rank exits while another
    still has collective work in flight. `name` says which barrier a hang
    is in."""
    if dist.is_initialized():
        logger.debug("barrier %s", name)
        dist.barrier()


def is_writer():
    """True on the single rank (rank 0, or the only process) that owns all
    artifact writes.

    Every rank holds the same replicated state, so rank 0 alone writes
    `results/<name>/`: concurrent writers would race on the same files.
    The flip side: `--resume` over several machines needs a shared
    filesystem, since every rank reads the checkpoint rank 0 wrote.
    """
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch_size, rank=None, world_size=None):
    """(start, stop) rows of the global batch this rank feeds (copied
    from disvae_tpu/parallel/distributed.py:95-105). `rank` and
    `world_size` default to the process group's (0 and 1 without one).
    Does not handle ragged batches: see DataLoader(pad_global_to=...)."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    n, i = world_size, rank
    per = global_batch_size // n
    if global_batch_size % n:
        raise ValueError("global batch {} not divisible by {} hosts".format(
            global_batch_size, n))
    return i * per, (i + 1) * per
