"""Train and evaluation steps, and on-device batch decompression.

Counterpart of disvae_tpu/train/steps.py: `make_optimizer` /
`make_disc_optimizer` (:24-38), the standard and FactorVAE train steps
(:144-194), the resident K-step super-step (:197-246) and its one-program
form on the card (`GraphedSuperStep`, a CUDA graph), `stack_metrics`
(:249-253), `make_eval_step` (:89-123) and `_decompress_batch` (:125-141).

A train step is (state, batch, noise=None) -> metrics, a dict of 0-d
device tensors; it updates `state` in place (model, optimizers, both step
counters, generator). The noise is drawn from `state.generator` unless the
caller pins it: `{"eps": (B, D)}` for the standard losses, `{"eps1",
"eps2": (B // 2, D), "perm": (B // 2, D) int64}` for FactorVAE. Nothing
in a step waits on the device.

The padded step (`make_padded_train_step`, disvae_tpu steps.py:60-87)
takes a batch padded to the data-axis multiple and `n_valid`, its true
size; every batch-size dependent quantity is computed at n_valid, so the
result equals the unpadded batch's. Under a mesh (parallel/mesh.py) each
rank passes its contiguous share of the global batch and the step runs
the collectives. Either way the noise is drawn at the GLOBAL valid shape
from `state.generator`, which every rank holds in the same state, and
each rank takes its rows (pad rows get zeros): a W-rank step consumes
the generator exactly as the 1-process step at the global batch does.
"""

from functools import partial

import torch

from disvae_tpu_torch.ops.losses import draw_permutations, factor_surrogate
from disvae_tpu_torch.parallel.mesh import (gather_rows,
                                            make_sharded_multi_train_step,
                                            make_sharded_padded_train_step,
                                            make_sharded_train_step,
                                            reduce_gradients)


def _adam(params, **kwargs):
    """Adam, `capturable` on the card: its step counts and bias corrections
    live on the device, so a CUDA graph captures its step
    (`GraphedSuperStep`) and eager steps run the same arithmetic. The
    CPU has no capturable Adam and keeps torch's default."""
    params = list(params)
    return torch.optim.Adam(params, capturable=all(p.is_cuda for p in params),
                            **kwargs)


def make_optimizer(params, lr):
    """Adam with torch's defaults, betas (0.9, 0.999), eps 1e-8 (reference
    main.py:208)."""
    return _adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_disc_optimizer(params, loss_cfg):
    """The discriminator's Adam, betas from the loss (reference
    losses.py:232-238: (0.5, 0.9))."""
    return _adam(params, lr=loss_cfg.lr_disc,
                 betas=tuple(loss_cfg.disc_betas), eps=1e-8)


def _decompress_batch(batch, img_size=None):
    """Wire-format batches decompress on the batch's device; float batches
    pass through unchanged.

    * uint8 (B, H, W, C): intensity = value / 255 (get_batch_raw)
    * uint8 (B, n_pixels/8): bitpacked binary images (get_batch_bits,
      np.packbits big-endian bit order); `img_size` (C, H, W) gives the
      unpacked shape
    """
    if batch.dtype != torch.uint8:
        return batch
    if batch.dim() == 2:  # bitpacked
        if img_size is None:
            raise ValueError("bit feed needs the model's img_size")
        c, h, w = img_size
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                              device=batch.device)
        bits = torch.bitwise_and(batch[:, :, None] >> shifts, 1)
        return bits.reshape(batch.shape[0], h, w, c).to(torch.float32)
    return batch.to(torch.float32) * (1.0 / 255.0)


def _global_rows(batch, n_valid, mesh):
    """(first global row of this rank's share, global valid rows)."""
    b = batch.shape[0]
    row0, total = ((0, b) if mesh is None
                   else (mesh.data_rank * b, mesh.data_size * b))
    return row0, total if n_valid is None else int(n_valid)


def _local_rows(x, row0, b):
    """Rows [row0, row0 + b) of a global (n, ...) tensor, zero-filled past
    its end (the pad rows of a padded batch)."""
    out = x[row0:row0 + b]
    if out.shape[0] < b:
        out = torch.cat([out, out.new_zeros((b - out.shape[0],)
                                            + tuple(out.shape[1:]))])
    return out


def _standard_train_step(loss_cfg, state, batch, noise=None, n_valid=None,
                         mesh=None):
    model = state.model
    model.train()
    batch = _decompress_batch(batch, model.img_size)
    step = state.device_step.add_(1)  # incremented before use, like _pre_call
    row0, n = _global_rows(batch, n_valid, mesh)
    if noise is None:
        eps = torch.randn((n, model.latent_dim), generator=state.generator,
                          device=batch.device)
    else:
        eps = noise["eps"]
    recon, latent_dist, z = model(batch, eps=_local_rows(eps, row0,
                                                         batch.shape[0]))
    if mesh is not None:
        # ~30 KB at b256: each rank computes the batch-coupled terms on
        # the global (B, D) statistics; images are never gathered
        stats = gather_rows(torch.cat([*latent_dist, z], 1), mesh)
        mu, logvar, z = (t.contiguous()
                         for t in stats.split(model.latent_dim, 1))
        latent_dist = (mu, logvar)
    loss, metrics = loss_cfg(batch, recon, latent_dist, True, step,
                             latent_sample=z, n_valid=n_valid, mesh=mesh,
                             coefs=state.coefs)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        reduce_gradients(model.parameters(), mesh)
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def _factor_train_step(loss_cfg, state, batch, noise=None, n_valid=None,
                       mesh=None):
    """FactorVAE step: one backward of `factor_surrogate`, then both
    optimizers step from the pre-step parameters' grads (the reference's
    end-of-iteration optimizer.step() / optimizer_d.step(),
    losses.py:306-308). Under a mesh the VAE's gradients are summed over
    the data group and the discriminator's, which every data rank computes
    whole (or, tensor-parallel, its shard of it), averaged over it
    (parallel/mesh.py reduce_gradients)."""
    model, disc = state.model, state.disc
    model.train()
    batch = _decompress_batch(batch, model.img_size)
    step = state.device_step.add_(1)
    if noise is None:
        shape = (_global_rows(batch, n_valid, mesh)[1] // 2,
                 model.latent_dim)
        noise = dict(
            eps1=torch.randn(shape, generator=state.generator,
                             device=batch.device),
            eps2=torch.randn(shape, generator=state.generator,
                             device=batch.device),
            perm=draw_permutations(shape, state.generator, batch.device))
    surrogate, metrics = factor_surrogate(
        loss_cfg, model, disc, batch, step, noise["eps1"], noise["eps2"],
        noise["perm"], is_train=True, n_valid=n_valid, mesh=mesh,
        coefs=state.coefs)
    state.optimizer.zero_grad(set_to_none=True)
    state.disc_optimizer.zero_grad(set_to_none=True)
    surrogate.backward()
    if mesh is not None:
        reduce_gradients(model.parameters(), mesh)
        reduce_gradients(disc.parameters(), mesh, mean=True)
    state.optimizer.step()
    state.disc_optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def _step_fn(loss_cfg):
    if loss_cfg.needs_discriminator:
        return partial(_factor_train_step, loss_cfg)
    return partial(_standard_train_step, loss_cfg)


def make_train_step(loss_cfg, mesh=None, state=None):
    """The train step of `loss_cfg`'s family: (state, batch, noise=None)
    -> metrics; with `mesh`, on this rank's share of each global batch
    (parallel/mesh.py make_sharded_train_step). Given `state` and a model
    axis larger than 1, the state's discriminator goes tensor-parallel, as
    in the two functions below."""
    return make_sharded_train_step(_step_fn(loss_cfg), mesh, state)


def make_padded_train_step(loss_cfg, mesh=None, state=None):
    """The step for a batch padded to the data-axis multiple: (state,
    batch, n_valid, noise=None) -> metrics, with `n_valid` the true
    (global) batch size. For the non-adversarial losses the result equals
    the unpadded step's; FactorVAE's too, since its permutations are drawn
    at the true half (the JAX package's masked draw matches only in
    distribution). Without a mesh `batch` is the whole padded batch."""
    return make_sharded_padded_train_step(_step_fn(loss_cfg), mesh, state)


def stack_metrics(metrics, key_order):
    """Pack a metrics dict into one float32 (n_keys,) tensor in canonical
    key order: one device buffer per step instead of ~16."""
    return torch.stack([metrics[k] for k in key_order])


def make_resident_multi_train_step(loss_cfg, key_order, mesh=None,
                                   state=None, graph_steps=None):
    """K-step super-step over a device-resident wire-format dataset:
    (state, data, idx) -> (K, n_keys) metrics, idx = (K, B) int64 batch
    indices on the data's device. The JAX package scans the K steps in one
    program; here each step gathers its batch with index_select, in idx's
    row order. Given `graph_steps` K and a `state` on the card, with no
    mesh, the K-step super-step replays as one CUDA graph
    (`GraphedSuperStep`); anywhere else `graph_steps` is ignored.
    Under a mesh every rank holds the whole upload, `idx` holds this
    rank's columns of K global batches, and the steps run eagerly."""
    step_fn = _step_fn(loss_cfg)

    def multi(state, data, idx, mesh=None):
        return torch.stack([
            stack_metrics(step_fn(state, data.index_select(0, i), mesh=mesh),
                          key_order)
            for i in idx])
    multi = make_sharded_multi_train_step(multi, mesh, state)
    if (graph_steps is None or mesh is not None or state is None
            or not state.device_step.is_cuda):
        return multi
    return GraphedSuperStep(multi, graph_steps)


class GraphedSuperStep:
    """The resident K-step super-step replayed as one CUDA graph: the
    port's form of the JAX package's one scanned program
    (disvae_tpu/train/steps.py:197-246), with no host work between steps.

    Called as the eager super-step `multi`: (state, data, idx) -> (K,
    n_keys) metrics. The first call with K rows for a (state, data, batch
    size) runs eagerly: it picks cuDNN's algorithms, loads the kernels and
    creates Adam's state. The next one captures K steps into a graph over
    a static (K, B) index buffer, the resident `data` and a static (K,
    n_keys) metrics buffer, then replays it; each later call copies its
    indices into the buffer on the device, replays, and clones the
    metrics. A call with fewer rows (an epoch's last short super-step)
    runs eagerly on the same state. A failed capture raises: there is no
    quiet fallback to the eager loop.

    What a replay must do as eager steps would, and how:
    * Adam is capturable (`_adam`): its step counts live on the device;
    * the state's generator is registered with the graph, so a replay
      draws the noise eager steps would draw and advances the generator
      as far;
    * the losses read `state.device_step`, which the graph increments;
      the host adds K to `state.step` after each replay;
    * the capture's backward leaves the gradients in the graph's pool;
      each replay points `p.grad` at them again, as an eager step leaves
      the last step's gradients there.
    A kernel wrapper's launch count grows where it is called: in the
    eager steps and once per step of the capture. The replays do not
    call it; `replays` counts them since the last capture, and
    `captured_steps` / `replayed_steps` count the steps captured and
    replayed over the object's life.
    Whoever replaces the state's tensors (an optimizer's
    `load_state_dict`) calls `reset()`, and the next calls warm up and
    capture again.
    """

    def __init__(self, multi, k):
        self.multi, self.k = multi, int(k)
        self.captured_steps = self.replayed_steps = 0
        self.reset()

    def reset(self):
        """Drop the graph (and its memory pool)."""
        self._warm = self._captured = self._graph = None
        self._idx = self._out = None
        self._grads = []
        self.replays = 0

    @property
    def captured(self):
        return self._graph is not None

    def __call__(self, state, data, idx):
        key = (state, data, tuple(idx.shape))
        if idx.shape[0] != self.k:
            return self.multi(state, data, idx)
        if not _same(self._captured, key):
            if not _same(self._warm, key):
                self._warm = key
                return self.multi(state, data, idx)
            self._capture(state, data, idx)
        self._idx.copy_(idx)
        self._graph.replay()
        self.replays += 1
        self.replayed_steps += self.k
        state.step += self.k
        for p, g in self._grads:
            p.grad = g
        return self._out.clone()

    def _capture(self, state, data, idx):
        self.reset()  # frees the last graph before the next is captured
        optimizers = [o for o in (state.optimizer, state.disc_optimizer)
                      if o is not None]
        host_step = state.step
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        static_idx = idx.clone()
        # the captured backward makes the gradients in the graph's pool
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        try:
            with torch.cuda.graph(graph):
                out = self.multi(state, data, static_idx)
        finally:
            state.step = host_step  # the capture ran nothing
        self._grads = [(p, p.grad) for o in optimizers
                       for g in o.param_groups for p in g["params"]
                       if p.grad is not None]
        self._graph, self._idx, self._out = graph, static_idx, out
        self._captured = (state, data, tuple(idx.shape))
        self.captured_steps += self.k


def _same(key, other):
    """Keys of GraphedSuperStep: the same state and data objects and the
    same index shape."""
    return (key is not None and key[0] is other[0] and key[1] is other[1]
            and key[2] == other[2])


def make_eval_step(model, loss_cfg, disc=None):
    """Build the evaluation step: (batch, coefs=None) -> metrics dict.

    Eval-mode semantics: reparameterize returns the mean, annealing factors
    are at their final value. FactorVAE evaluates the first half-batch
    against `disc` and skips the discriminator loss (reference
    losses.py:276-278). `coefs` is the loss's coefficient vector
    (ops/losses.py coef_vector)."""
    if loss_cfg.needs_discriminator:
        @torch.no_grad()
        def factor_eval_fn(batch, coefs=None):
            model.eval()
            batch = _decompress_batch(batch, model.img_size)
            data1 = batch[:batch.shape[0] // 2]
            recon, latent_dist, z = model(data1)
            _, metrics = loss_cfg.eval_losses(data1, recon, latent_dist,
                                              disc(z), False, 0, coefs=coefs)
            return metrics
        return factor_eval_fn

    @torch.no_grad()
    def eval_fn(batch, coefs=None):
        model.eval()
        batch = _decompress_batch(batch, model.img_size)
        recon, latent_dist, z = model(batch)
        _, metrics = loss_cfg(batch, recon, latent_dist, False, 0,
                              latent_sample=z, coefs=coefs)
        return metrics
    return eval_fn
