"""Evaluation step and on-device batch decompression.

Counterpart of disvae_tpu/train/steps.py `make_eval_step` (:89-123, the
non-discriminator branch) and `_decompress_batch` (:125-141). The train
steps arrive with the training slice (ROADMAP.md).
"""

import torch


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


def make_eval_step(model, loss_cfg):
    """Build the evaluation step: batch -> metrics dict (no updates).

    Eval-mode semantics: reparameterize returns the mean, annealing factors
    are at their final value. `coefs` is the loss's hyperparameter vector
    (ops/losses.py coef_vector)."""
    @torch.no_grad()
    def eval_fn(batch, coefs=None):
        model.eval()
        batch = _decompress_batch(batch, model.img_size)
        recon, latent_dist, z = model(batch)
        _, metrics = loss_cfg(batch, recon, latent_dist, False, 0,
                              latent_sample=z, coefs=coefs)
        return metrics
    return eval_fn
