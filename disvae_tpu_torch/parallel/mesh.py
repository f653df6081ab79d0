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

Axis layout (disvae_tpu/parallel/mesh.py:29-45): W ranks, one GPU each,
laid out as `reshape(W // M, M)` for `model_parallel` M. Rank r has data
index r // M and model index r % M. The ranks of one data index form a
MODEL group and hold the same rows; the ranks of one model index form a
DATA group, over which the three collectives above run.

Tensor parallelism (disvae_tpu/parallel/mesh.py:131-163): the FactorVAE
discriminator's weights go column-parallel over the model group
(`tp_param_shards`): each model rank keeps its share of every split
layer's output units, computes those columns, and gathers the rest
(`ColumnParallelLinear`). The VAE stays replicated. The three
`make_sharded_*` functions apply it whenever the model axis is larger
than 1, as JAX's `_state_shardings` does; `make_tp_train_step` applies it
at any M.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from disvae_tpu_torch.ops import precision

# torch 2.13 renamed the single-tensor collectives and deprecated the old
# names; older releases (2.11 on the GPU machine) have only those
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclass(frozen=True, eq=False)
class Mesh:
    """('data', 'model') layout of a process group: this process's global
    `rank` among `size` ranks, the model axis's size, and the two groups
    this rank belongs to (`data_group` None means the default group, the
    data group whenever `model_size` is 1)."""
    rank: int
    size: int
    model_size: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self):
        return self.rank // self.model_size

    @property
    def data_size(self):
        return self.size // self.model_size

    @property
    def model_rank(self):
        return self.rank % self.model_size

    @property
    def shape(self):
        return {"data": self.data_size, "model": self.model_size}


def create_mesh(model_parallel=1):
    """The mesh over every rank of the process group: `model_parallel`
    ranks per model group, the world size over it on the data axis.

    Every rank makes every `dist.new_group` call, in the same order, as
    torch.distributed requires. With model_parallel 1 the data group is
    the default group and each model group holds one rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel != 0:
        raise ValueError("{} devices not divisible by model_parallel={}"
                         .format(n, model_parallel))
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: launch with "
                           "torchrun, which parallel.distributed."
                           "initialize() reads")
    rank = dist.get_rank()
    layout = np.arange(n).reshape(n // model_parallel, model_parallel)
    data_group = model_group = None
    if model_parallel > 1:
        for ranks in layout.T:
            group = dist.new_group(ranks.tolist())
            if rank in ranks:
                data_group = group
    for ranks in layout:
        group = dist.new_group(ranks.tolist())
        if rank in ranks:
            model_group = group
    return Mesh(rank=rank, size=n, model_size=model_parallel,
                data_group=data_group, model_group=model_group)


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
    divides the data axis (pad it with `pad_to_multiple` first). The ranks
    of one model group get the same share."""
    n = batch.shape[0]
    if n % mesh.data_size:
        raise ValueError("batch of {} does not divide the {}-rank data axis"
                         .format(n, mesh.data_size))
    share = n // mesh.data_size
    return batch[mesh.data_rank * share:(mesh.data_rank + 1) * share]


class _GatherRows(torch.autograd.Function):
    """Concatenate the (b, ...) rows of every rank of the data group into
    (W * b, ...), in data-rank order.

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
    def forward(ctx, x, group, size, rank):
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None, None


def gather_rows(x, mesh):
    """All-gather of (b, ...) rows over the data group into (W * b, ...)
    whose backward is this rank's slice (see _GatherRows)."""
    return _GatherRows.apply(x, mesh.data_group, mesh.data_size,
                             mesh.data_rank)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward passes the gradient through, by the
    argument of _GatherRows (the total's gradient is the same on every
    rank, and d total / d local = 1)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x, mesh):
    """Differentiable sum of `x` over the data group of `mesh`."""
    return _AllReduceSum.apply(x, mesh.data_group)


def reduce_gradients(params, mesh, mean=False):
    """One flat all-reduce of a parameter set's gradients over the data
    group, after backward and before the optimizer, in the set's fixed
    parameter order. The model ranks of one data index hold the same VAE
    gradients, so the data group alone makes the sum; a discriminator
    shard is averaged with the same shard of the other data ranks.

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
    dist.all_reduce(flat, group=mesh.data_group)
    if mean and mesh.data_size > 1:
        flat.div_(mesh.data_size)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


def _state_shards(mesh, state):
    """Tensor parallelism when the mesh has a model axis larger than 1 and
    a train state is given (disvae_tpu/parallel/mesh.py:76-82); otherwise
    the state stays replicated."""
    if mesh is not None and state is not None and mesh.model_size > 1:
        shard_train_state(state, mesh)


def make_sharded_train_step(step_fn, mesh, state=None):
    """(state, local_batch, noise=None) -> metrics: `step_fn` (a train
    step of train/steps.py) on this rank's rows of each global batch, with
    its collectives over `mesh`. Pinned noise is the global batch's. With
    mesh None, as with the two functions below, the single-device step.
    Given `state` on a mesh whose model axis is larger than 1, the state's
    discriminator is sharded here (`shard_train_state`), as in the two
    functions below."""
    _state_shards(mesh, state)
    return partial(step_fn, mesh=mesh)


def make_sharded_padded_train_step(step_fn, mesh, state=None):
    """(state, local_batch, n_valid, noise=None) -> metrics: the sharded
    step for a global batch padded to the data-axis multiple, whose first
    `n_valid` global rows are real (the mask-aware losses)."""
    _state_shards(mesh, state)

    def step(state, batch, n_valid, noise=None):
        return step_fn(state, batch, noise, n_valid=n_valid, mesh=mesh)
    return step


def make_sharded_multi_train_step(multi_fn, mesh, state=None):
    """(state, data, idx) -> (K, n_keys) metrics: the resident K-step
    super-step with `idx` (K, B / W) this rank's columns of K global
    batches."""
    _state_shards(mesh, state)
    return partial(multi_fn, mesh=mesh)


def make_tp_train_step(step_fn, mesh, state):
    """The sharded step with the FactorVAE discriminator column-parallel
    over the model axis at any model size, 1 included, where every split
    layer still runs its gather and its all-reduce over the one-rank model
    group (disvae_tpu/parallel/mesh.py:154-163). Shards `state` in
    place."""
    shard_train_state(state, mesh)
    return partial(step_fn, mesh=mesh)


# ----------------------------------------------------------------------
# tensor parallelism of the FactorVAE discriminator
# ----------------------------------------------------------------------

def tp_param_shards(mesh, disc):
    """Parameter name -> the dimension split over the model axis, or None
    for a replicated parameter, for a whole discriminator (counterpart of
    tp_state_shardings, disvae_tpu/parallel/mesh.py:131-151).

    JAX's rule: a 2-D weight goes column-parallel when its number of
    output units divides the model axis; biases stay replicated. A torch
    Linear weight is JAX's `w` transposed, so its output units are rows:
    the split dimension is 0."""
    m = mesh.model_size
    return {name: 0 if p.dim() == 2 and p.shape[0] % m == 0 else None
            for name, p in disc.named_parameters()}


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the
    model group, since each model rank's shard gives only its own
    columns' part of the input's gradient (the latent's gradient is
    whole only after this sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """(B, c) columns of every model rank -> (B, M * c), in model-rank
    order; the backward is this rank's columns of the gradient, which
    every model rank computes whole (the same loss from the same gathered
    activations)."""

    @staticmethod
    def forward(ctx, y, group, size, rank):
        b, c = y.shape
        ctx.cols = (rank * c, (rank + 1) * c)
        out = y.new_empty((size * b, c))
        _all_gather(out, y.contiguous(), group=group)
        return out.view(size, b, c).permute(1, 0, 2).reshape(b, size * c)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.cols
        return grad[:, lo:hi], None, None, None


class ColumnParallelLinear(nn.Module):
    """A Linear layer whose output units are split evenly over the model
    group: `weight` holds this rank's rows of the whole (out, in) weight,
    `bias` the whole replicated bias. The forward computes this rank's
    columns with their bias, as the policy's `linear` computes them
    (ops/precision.py; under `highest`/`high` one addmm), and gathers all
    of them, so every model rank returns the whole (B, out)
    output."""

    def __init__(self, weight, bias, mesh):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.group = mesh.model_group
        self.model_size = mesh.model_size
        self.model_rank = mesh.model_rank

    def forward(self, x):
        rows = self.weight.shape[0]
        lo = self.model_rank * rows
        y = precision.linear(_CopyToModel.apply(x, self.group), self.weight,
                             self.bias.detach()[lo:lo + rows])
        y = _GatherColumns.apply(y, self.group, self.model_size,
                                 self.model_rank)
        # The bias's value is in y already; adding it minus itself adds
        # zero and gives the replicated bias the whole output's gradient,
        # the same on every model rank, as nn.Linear's bias gets it.
        return y + (self.bias - self.bias.detach())


def _rows(t, mesh):
    """This model rank's share of `t`'s rows."""
    n = t.shape[0] // mesh.model_size
    return t[mesh.model_rank * n:(mesh.model_rank + 1) * n]


def _whole_rows(t, mesh):
    """Every model rank's rows of `t`, concatenated in model-rank order
    (the inverse of `_rows`)."""
    out = t.new_empty((mesh.model_size * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather(out, t.contiguous(), group=mesh.model_group)
    return out


def _split_names(disc):
    """Names of the parameters a ColumnParallelLinear shards."""
    return {"{}.weight".format(name) for name, m in disc.named_modules()
            if isinstance(m, ColumnParallelLinear)}


def _optimizer_names(disc, optimizer):
    """The parameter names of `disc` in the optimizer's state-dict order
    (its param groups', in which `state_dict()` numbers them)."""
    names = {id(p): n for n, p in disc.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _map_split(disc_sd, opt_sd, names, split, fn):
    """Copies of a discriminator's and its Adam's state dicts with `fn`
    applied to each split parameter and to its moments (every per-element
    state tensor; Adam's step counts are 0-d and stay)."""
    disc_sd = {k: fn(v) if k in split else v for k, v in disc_sd.items()}
    state = {}
    for i, s in opt_sd["state"].items():
        if names[i] in split:
            s = {k: fn(v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in s.items()}
        state[i] = s
    return disc_sd, dict(opt_sd, state=state)


def shard_train_state(state, mesh):
    """Split the discriminator of `state` column-parallel over `mesh`'s
    model group, in place: each split layer (`tp_param_shards`) becomes a
    ColumnParallelLinear holding this rank's rows, and the discriminator's
    Adam moves to the shards with its moments sliced alike. Every rank
    must hold the whole discriminator drawn from the same seed, so the
    sharded init equals the replicated one. A no-op without a
    discriminator or when the state is sharded already."""
    disc, opt = state.disc, state.disc_optimizer
    if disc is None or state.disc_mesh is not None:
        return state
    shards = tp_param_shards(mesh, disc)
    split = {k for k, dim in shards.items() if dim == 0}
    old = dict(disc.named_parameters())
    for name in sorted(split):
        layer = name.rsplit(".", 1)[0]
        linear = disc.get_submodule(layer)
        setattr(disc, layer, ColumnParallelLinear(
            _rows(linear.weight.detach(), mesh).clone(),
            linear.bias.detach().clone(), mesh))
    new = dict(disc.named_parameters())
    name_of = {id(p): n for n, p in old.items()}
    for group in opt.param_groups:
        group["params"] = [new[name_of[id(p)]] for p in group["params"]]
    for name, p in old.items():
        if p in opt.state:
            moments = opt.state.pop(p)
            if name in split:
                moments = {k: _rows(v, mesh).clone()
                           if torch.is_tensor(v) and v.dim() else v
                           for k, v in moments.items()}
            opt.state[new[name]] = moments
    state.disc_mesh = mesh
    return state


def whole_disc_state(disc, optimizer, mesh):
    """The state dicts of the WHOLE discriminator and its Adam, gathered
    over the model group from a sharded one (a collective: every rank of
    the model group calls it)."""
    split = _split_names(disc)
    return _map_split(disc.state_dict(), optimizer.state_dict(),
                      _optimizer_names(disc, optimizer), split,
                      partial(_whole_rows, mesh=mesh))


def load_whole_disc_state(disc, optimizer, mesh, disc_sd, opt_sd):
    """Load a whole discriminator's and its Adam's state dicts into a
    sharded one: each model rank takes its rows, whatever model size
    wrote them."""
    disc_sd, opt_sd = _map_split(disc_sd, opt_sd,
                                 _optimizer_names(disc, optimizer),
                                 _split_names(disc),
                                 partial(_rows, mesh=mesh))
    disc.load_state_dict(disc_sd)
    optimizer.load_state_dict(opt_sd)
