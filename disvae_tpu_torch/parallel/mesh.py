"""The data-parallel layout, its collectives, and the sharded step
builders.

Counterpart of disvae_tpu/parallel/mesh.py:29-128. The JAX step is written
over the GLOBAL batch and GSPMD inserts the gradient psum and the
latent-statistic all-gather. Here each rank runs the step on its own rows
of every global batch and calls the collectives itself, so that every
batch-dependent quantity is still computed at the global batch:

* the reconstruction sum of each rank's rows is all-reduced and divided
  by the global number of valid rows (`all_reduce_sum`);
* the latent statistics, (B/W, D) each, are gathered (`gather_rows`), and
  every rank computes the terms that couple rows (btcvae's (B, B, D)
  estimator and its MSS weights, the KL means, FactorVAE's permutation
  and discriminator) identically on the global (B, D) tensors;
* the gradients are all-reduced, one flat buffer per parameter set
  (`reduce_gradients`), before Adam steps on every rank alike.

Stock DistributedDataParallel would average per-rank losses instead,
which for btcvae and FactorVAE is a different loss.

Axis layout: `data` spans every rank, one GPU each; `model` is declared
with size 1 (tensor parallelism of the FactorVAE discriminator is not
ported: ROADMAP.md, Queue 1).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

# torch 2.13 renamed the single-tensor collectives and deprecated the old
# names; older releases (2.11 on the GPU machine) have only those
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclass(frozen=True)
class Mesh:
    """('data', 'model') layout over the default process group: this
    process's `rank` on the data axis of `size` ranks; the model axis has
    size 1."""
    rank: int
    size: int

    @property
    def shape(self):
        return {"data": self.size, "model": 1}


def create_mesh(model_parallel=1):
    """The mesh over every rank of the process group (data axis = world
    size). `model_parallel` > 1 is not ported yet."""
    if model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel {} (tensor parallelism of the FactorVAE "
            "discriminator) is not ported yet: ROADMAP.md, Queue 1 item 1"
            .format(model_parallel))
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: launch with "
                           "torchrun, which parallel.distributed."
                           "initialize() reads")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size())


def pad_to_multiple(batch, multiple):
    """Pad the batch's leading dim up to `multiple` by repeating the first
    element; returns (padded, true_size). Copied from
    disvae_tpu/parallel/mesh.py:67-77. Sharded dims must divide the mesh
    axis; losses that depend on batch size (MSS weights) must be given
    `true_size`."""
    b = batch.shape[0]
    rem = b % multiple
    if rem == 0:
        return batch, b
    pad = np.repeat(batch[:1], multiple - rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b


def shard_batch(batch, mesh):
    """This rank's contiguous share of a global batch whose leading dim
    divides the data axis (pad it with `pad_to_multiple` first)."""
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError("batch of {} does not divide the {}-rank data axis"
                         .format(n, mesh.size))
    share = n // mesh.size
    return batch[mesh.rank * share:(mesh.rank + 1) * share]


class _GatherRows(torch.autograd.Function):
    """Concatenate every rank's (b, ...) rows into (W * b, ...), in rank
    order.

    The backward returns this rank's slice of the incoming gradient and
    runs no collective. This is right because every rank computes the same
    global loss from the gathered tensor: the gradient that reaches rank
    r's own rows is the part of the global gradient that flows through
    them, so summing the parameter gradients over ranks gives the whole
    gradient (`reduce_gradients`). The alternative, a summing
    reduce-scatter in the backward, hands each rank W times its share and
    needs the parameter gradients averaged instead; it also makes every
    backward a collective that each rank must reach, a hang whenever one
    rank's rows carry no gradient (a FactorVAE rank that holds only pad
    rows). The W-rank = 1-process tests hold this choice.
    """

    @staticmethod
    def forward(ctx, x, size, rank):
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


def gather_rows(x, mesh):
    """All-gather of (b, ...) rows into (W * b, ...) whose backward is this
    rank's slice (see _GatherRows)."""
    return _GatherRows.apply(x, mesh.size, mesh.rank)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward passes the gradient through, by the
    argument of _GatherRows (the total's gradient is the same on every
    rank, and d total / d local = 1)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def all_reduce_sum(x, mesh):
    """Differentiable sum of `x` over the ranks of `mesh`."""
    del mesh  # the default group spans the mesh
    return _AllReduceSum.apply(x)


def reduce_gradients(params, mesh, mean=False):
    """One flat all-reduce of a parameter set's gradients, after backward
    and before the optimizer, in the set's fixed parameter order.

    The sum is the global gradient when each rank's gradient is the part
    that flows through its own rows (the VAE: see _GatherRows). `mean` is
    for a set whose whole forward every rank repeats on the gathered
    tensors (the FactorVAE discriminator), so each rank already holds the
    whole gradient. A parameter without a gradient (a rank whose rows were
    all padding) contributes zeros."""
    params = [p for p in params if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if mean and mesh.size > 1:
        flat.div_(mesh.size)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


def make_sharded_train_step(step_fn, mesh):
    """(state, local_batch, noise=None) -> metrics: `step_fn` (a train
    step of train/steps.py) on this rank's rows of each global batch, with
    its collectives over `mesh`. Pinned noise is the global batch's. With
    mesh None, as with the two builders below, the single-device step."""
    return partial(step_fn, mesh=mesh)


def make_sharded_padded_train_step(step_fn, mesh):
    """(state, local_batch, n_valid, noise=None) -> metrics: the sharded
    step for a global batch padded to the data-axis multiple, whose first
    `n_valid` global rows are real (the mask-aware losses)."""
    def step(state, batch, n_valid, noise=None):
        return step_fn(state, batch, noise, n_valid=n_valid, mesh=mesh)
    return step


def make_sharded_multi_train_step(multi_fn, mesh):
    """(state, data, idx) -> (K, n_keys) metrics: the resident K-step
    super-step with `idx` (K, B / W) this rank's columns of K global
    batches."""
    return partial(multi_fn, mesh=mesh)
