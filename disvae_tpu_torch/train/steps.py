"""Train and evaluation steps, and on-device batch decompression.

Counterpart of disvae_tpu/train/steps.py: `make_optimizer` /
`make_disc_optimizer` (:24-38), the standard and FactorVAE train steps
(:144-194), the resident K-step super-step (:197-246), `stack_metrics`
(:249-253), `make_eval_step` (:89-123) and `_decompress_batch` (:125-141).

A train step is (state, batch, noise=None) -> metrics, a dict of 0-d
device tensors; it updates `state` in place (model, optimizers, step
counter, generator). The noise is drawn from `state.generator` unless the
caller pins it: `{"eps": (B, D)}` for the standard losses, `{"eps1",
"eps2": (B // 2, D), "perm": (B // 2, D) int64}` for FactorVAE. Nothing
in a step waits on the device.
"""

from functools import partial

import torch

from disvae_tpu_torch.ops.losses import draw_permutations, factor_surrogate


def make_optimizer(params, lr):
    """Adam with torch's defaults, betas (0.9, 0.999), eps 1e-8 (reference
    main.py:208)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_disc_optimizer(params, loss_cfg):
    """The discriminator's Adam, betas from the loss (reference
    losses.py:232-238: (0.5, 0.9))."""
    return torch.optim.Adam(params, lr=loss_cfg.lr_disc,
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


def _standard_train_step(loss_cfg, state, batch, noise=None):
    model = state.model
    model.train()
    batch = _decompress_batch(batch, model.img_size)
    step = state.step + 1  # incremented before use, like _pre_call
    if noise is None:
        eps = torch.randn((batch.shape[0], model.latent_dim),
                          generator=state.generator, device=batch.device)
    else:
        eps = noise["eps"]
    recon, latent_dist, z = model(batch, eps=eps)
    loss, metrics = loss_cfg(batch, recon, latent_dist, True, step,
                             latent_sample=z, coefs=state.coefs)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step = step
    return {k: v.detach() for k, v in metrics.items()}


def _factor_train_step(loss_cfg, state, batch, noise=None):
    """FactorVAE step: one backward of `factor_surrogate`, then both
    optimizers step from the pre-step parameters' grads (the reference's
    end-of-iteration optimizer.step() / optimizer_d.step(),
    losses.py:306-308)."""
    model, disc = state.model, state.disc
    model.train()
    batch = _decompress_batch(batch, model.img_size)
    step = state.step + 1
    if noise is None:
        shape = (batch.shape[0] // 2, model.latent_dim)
        noise = dict(
            eps1=torch.randn(shape, generator=state.generator,
                             device=batch.device),
            eps2=torch.randn(shape, generator=state.generator,
                             device=batch.device),
            perm=draw_permutations(shape, state.generator, batch.device))
    surrogate, metrics = factor_surrogate(
        loss_cfg, model, disc, batch, step, noise["eps1"], noise["eps2"],
        noise["perm"], is_train=True, coefs=state.coefs)
    state.optimizer.zero_grad(set_to_none=True)
    state.disc_optimizer.zero_grad(set_to_none=True)
    surrogate.backward()
    state.optimizer.step()
    state.disc_optimizer.step()
    state.step = step
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(loss_cfg):
    """The train step of `loss_cfg`'s family: (state, batch, noise=None)
    -> metrics."""
    if loss_cfg.needs_discriminator:
        return partial(_factor_train_step, loss_cfg)
    return partial(_standard_train_step, loss_cfg)


def stack_metrics(metrics, key_order):
    """Pack a metrics dict into one float32 (n_keys,) tensor in canonical
    key order: one device buffer per step instead of ~16."""
    return torch.stack([metrics[k] for k in key_order])


def make_resident_multi_train_step(loss_cfg, key_order):
    """K-step super-step over a device-resident wire-format dataset:
    (state, data, idx) -> (K, n_keys) metrics, idx = (K, B) int64 batch
    indices on the data's device. The JAX package scans the K steps in one
    program; here each step gathers its batch with index_select, in idx's
    row order."""
    step_fn = make_train_step(loss_cfg)

    def multi(state, data, idx):
        return torch.stack([
            stack_metrics(step_fn(state, data.index_select(0, i)), key_order)
            for i in idx])
    return multi


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
