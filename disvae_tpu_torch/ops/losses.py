"""The VAE losses in PyTorch (disvae_tpu/ops/losses.py).

Every loss returns ``(loss, metrics_dict)`` with the JAX package's keys.
Data and reconstructions are NHWC float32 in [0, 1]; `step` is the train
step counter (incremented before use) that drives annealing: in training,
the train state's 0-d device tensor (`linear_annealing`). FactorVAE
trains two parameter sets on a batch split in half: `factor_surrogate`
is the one scalar whose backward gives both the reference's updates, and
`FactorKLoss.eval_losses` its evaluation pieces.

Two optional arguments carry a data-parallel step (parallel/mesh.py):
`n_valid`, the true size of a batch padded to the data-axis multiple (its
first n_valid rows are real; every batch-size dependent quantity is
computed at n_valid, as disvae_tpu/ops/losses.py's masked paths do), and
`mesh`, under which `data` and `recon_data` are this rank's contiguous
share of the global batch while the latent statistics are the gathered
global ones.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.func import functional_call

from disvae_tpu_torch.ops.math import (
    log_density_gaussian, log_importance_weight_matrix,
    log_importance_weight_matrix_masked, matrix_log_density_gaussian)
from disvae_tpu_torch.parallel.mesh import all_reduce_sum, gather_rows

LOSSES = ["VAE", "betaH", "betaB", "factor", "btcvae"]
RECON_DIST = ["bernoulli", "laplace", "gaussian"]

# The reference's BaseLoss(record_loss_every=50): sub-losses are recorded
# when step % 50 == 1, the step counter being incremented before the check.
RECORD_LOSS_EVERY = 50


def get_loss_f(loss_name, **kwargs_parse):
    """Build the loss config from argparse-style kwargs (disvae_tpu
    losses.py:52-79). `device` is accepted and ignored."""
    kwargs_all = dict(rec_dist=kwargs_parse["rec_dist"],
                      steps_anneal=kwargs_parse["reg_anneal"])
    if loss_name == "betaH":
        return BetaHLoss(beta=kwargs_parse["betaH_B"], **kwargs_all)
    elif loss_name == "VAE":
        return BetaHLoss(beta=1, **kwargs_all)
    elif loss_name == "betaB":
        return BetaBLoss(C_init=kwargs_parse["betaB_initC"],
                         C_fin=kwargs_parse["betaB_finC"],
                         gamma=kwargs_parse["betaB_G"],
                         **kwargs_all)
    elif loss_name == "factor":
        return FactorKLoss(gamma=kwargs_parse["factor_G"],
                           latent_dim=kwargs_parse["latent_dim"],
                           lr_disc=kwargs_parse["lr_disc"],
                           **kwargs_all)
    elif loss_name == "btcvae":
        return BtcvaeLoss(n_data=kwargs_parse["n_data"],
                          alpha=kwargs_parse["btcvae_A"],
                          beta=kwargs_parse["btcvae_B"],
                          gamma=kwargs_parse["btcvae_G"],
                          **kwargs_all)
    else:
        raise ValueError("Unrecognized loss: {}".format(loss_name))


def coef_vector(loss_cfg, device=None):
    """The loss's sweepable hyperparameters as a float32 vector in
    `coef_names` order (disvae_tpu losses.py:82-89); `coefs=` of every loss
    reads them back."""
    names = getattr(loss_cfg, "coef_names", ())
    return torch.tensor([float(getattr(loss_cfg, n)) for n in names],
                        dtype=torch.float32, device=device)


def linear_annealing(init, fin, step, annealing_steps):
    """Linear ramp init -> fin over `annealing_steps` steps, a float32
    clamp as JAX's traced `jnp.minimum` (disvae_tpu losses.py:92-97).

    `step` is the train state's device counter (a 0-d integer tensor), so
    a captured step reads the step of each replay; a Python int is taken
    as one."""
    if annealing_steps == 0:
        return fin
    delta = fin - init
    return torch.clamp(init + delta * torch.as_tensor(step)
                       / annealing_steps, max=fin)


def _masked_mean(x, n_valid):
    """Mean of a per-row vector over its first `n_valid` rows (the whole
    vector when n_valid is None): the one masked-mean idiom the padded
    paths share (disvae_tpu losses.py:140-147)."""
    return torch.mean(x if n_valid is None else x[:n_valid])


def _reconstruction_sum(data, recon_data, distribution):
    """The reconstruction negative log likelihood summed over images and
    pixels."""
    if distribution == "bernoulli":
        loss = F.binary_cross_entropy(recon_data, data, reduction="sum")
    elif distribution == "gaussian":
        loss = torch.sum((recon_data * 255 - data * 255) ** 2) / 255
    elif distribution == "laplace":
        loss = torch.sum(torch.abs(recon_data - data)) * 3
        loss = loss * (loss != 0)  # reference's nan guard (losses.py:439)
    else:
        raise ValueError("Unrecognized distribution: {}".format(distribution))
    return loss


def reconstruction_loss(data, recon_data, distribution="bernoulli",
                        n_valid=None, mesh=None):
    """Per-image negative log likelihood, summed over pixels and averaged
    over the batch (disvae_tpu losses.py:150-177).

    bernoulli -> summed BCE (F.binary_cross_entropy, whose -100 log clamp
    the JAX `_bce_sum` imitates); gaussian -> summed MSE in [0, 255] space /
    255; laplace -> summed L1 * 3.

    With `n_valid` only the first n_valid (global) rows are real and the
    result equals the loss of the unpadded batch. With `mesh` the rows are
    this rank's share: the sum over its valid rows is all-reduced and
    divided by the global count.
    """
    b = recon_data.shape[0]
    row0, total = ((0, b) if mesh is None
                   else (mesh.data_rank * b, mesh.data_size * b))
    n = total if n_valid is None else int(n_valid)
    k = min(max(n - row0, 0), b)  # this rank's valid rows are a prefix
    loss = _reconstruction_sum(data[:k], recon_data[:k], distribution)
    if mesh is not None:
        loss = all_reduce_sum(loss, mesh)
    return loss / n


def kl_normal_loss(mean, logvar, n_valid=None):
    """Closed-form KL(q || N(0, I)). Returns (total_kl, per_dim_kl), the
    per-dimension batch means logged as kl_loss_i. With `n_valid`, rows
    past it are padding and excluded from the means."""
    if n_valid is not None:
        mean, logvar = mean[:n_valid], logvar[:n_valid]
    term = -1 - logvar + mean ** 2 + torch.exp(logvar)
    latent_kl = 0.5 * torch.mean(term, dim=0)
    return torch.sum(latent_kl), latent_kl


def _kl_metrics(mean, logvar, n_valid=None):
    total_kl, latent_kl = kl_normal_loss(mean, logvar, n_valid)
    metrics = {"kl_loss": total_kl}
    for i in range(latent_kl.shape[0]):
        metrics["kl_loss_" + str(i)] = latent_kl[i]
    return total_kl, metrics


def metric_key_order(loss_name, latent_dim):
    """Canonical row order of the train log for each loss family."""
    kl_keys = ["kl_loss"] + ["kl_loss_" + str(i) for i in range(latent_dim)]
    if loss_name == "btcvae":
        return (["recon_loss", "loss", "mi_loss", "tc_loss", "dw_kl_loss"]
                + kl_keys)
    if loss_name == "factor":
        return ["recon_loss"] + kl_keys + ["loss", "tc_loss", "discrim_loss"]
    return ["recon_loss"] + kl_keys + ["loss"]


@dataclass(frozen=True)
class BetaHLoss:
    """Higgins et al. beta-VAE: rec + anneal * beta * KL. With beta=1 this
    is the plain VAE loss."""
    beta: float = 4.0
    rec_dist: str = "bernoulli"
    steps_anneal: int = 0

    name = "betaH"
    needs_discriminator = False
    coef_names = ("beta",)

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, n_valid=None, mesh=None, coefs=None,
                 **unused):
        beta = self.beta if coefs is None else coefs[0]
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist,
                                       n_valid, mesh)
        kl_loss, metrics = _kl_metrics(*latent_dist, n_valid=n_valid)
        anneal_reg = (linear_annealing(0, 1, step, self.steps_anneal)
                      if is_train else 1.0)
        loss = rec_loss + anneal_reg * (beta * kl_loss)
        metrics.update(recon_loss=rec_loss, loss=loss)
        return loss, metrics


@dataclass(frozen=True)
class BetaBLoss:
    """Burgess et al. capacity-annealed beta-VAE:
    rec + gamma * |KL - C(step)|. Eval uses C = C_fin."""
    C_init: float = 0.0
    C_fin: float = 20.0
    gamma: float = 100.0
    rec_dist: str = "bernoulli"
    steps_anneal: int = 0

    name = "betaB"
    needs_discriminator = False
    coef_names = ("C_init", "C_fin", "gamma")

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, n_valid=None, mesh=None, coefs=None,
                 **unused):
        C_init, C_fin, gamma = ((self.C_init, self.C_fin, self.gamma)
                                if coefs is None else coefs)
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist,
                                       n_valid, mesh)
        kl_loss, metrics = _kl_metrics(*latent_dist, n_valid=n_valid)
        C = (linear_annealing(C_init, C_fin, step, self.steps_anneal)
             if is_train else C_fin)
        loss = rec_loss + gamma * torch.abs(kl_loss - C)
        metrics.update(recon_loss=rec_loss, loss=loss)
        return loss, metrics


@dataclass(frozen=True)
class BtcvaeLoss:
    """beta-TCVAE decomposed ELBO (Chen et al. 2018):
    rec + alpha*MI + beta*TC + anneal*gamma*dwKL, with the minibatch
    stratified sampling estimator by default."""
    n_data: int = 1
    alpha: float = 1.0
    beta: float = 6.0
    gamma: float = 1.0
    is_mss: bool = True
    rec_dist: str = "bernoulli"
    steps_anneal: int = 0

    name = "btcvae"
    needs_discriminator = False
    coef_names = ("alpha", "beta", "gamma")

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, n_valid=None, mesh=None, coefs=None,
                 **unused):
        alpha, beta, gamma = ((self.alpha, self.beta, self.gamma)
                              if coefs is None else coefs)
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist,
                                       n_valid, mesh)
        log_pz, log_qz, log_prod_qzi, log_q_zCx = _log_pz_qz_prodzi_qzCx(
            latent_sample, latent_dist, self.n_data, is_mss=self.is_mss,
            n_valid=n_valid)

        mi_loss = _masked_mean(log_q_zCx - log_qz, n_valid)        # I[z;x]
        tc_loss = _masked_mean(log_qz - log_prod_qzi, n_valid)     # TC[z]
        dw_kl_loss = _masked_mean(log_prod_qzi - log_pz, n_valid)  # dwKL
        anneal_reg = (linear_annealing(0, 1, step, self.steps_anneal)
                      if is_train else 1.0)
        loss = rec_loss + (alpha * mi_loss
                           + beta * tc_loss
                           + anneal_reg * gamma * dw_kl_loss)
        _, metrics = _kl_metrics(*latent_dist, n_valid=n_valid)
        metrics.update(recon_loss=rec_loss, loss=loss, mi_loss=mi_loss,
                       tc_loss=tc_loss, dw_kl_loss=dw_kl_loss)
        return loss, metrics


@dataclass(frozen=True)
class FactorKLoss:
    """FactorVAE adversarial total-correlation loss (Kim & Mnih 2018,
    Alg. 2; disvae_tpu losses.py:315-350). Training goes through
    `factor_surrogate` and the factor train step; this config carries the
    discriminator's hyperparameters."""
    gamma: float = 10.0
    latent_dim: int = 10
    lr_disc: float = 5e-5
    disc_betas: tuple = (0.5, 0.9)
    rec_dist: str = "bernoulli"
    steps_anneal: int = 0

    name = "factor"
    needs_discriminator = True
    coef_names = ("gamma",)

    def __call__(self, *args, **kwargs):
        raise ValueError("Use the factor train/eval step to also train the "
                         "discriminator")

    def eval_losses(self, data, recon_data, latent_dist, d_z, is_train, step,
                    coefs=None):
        """Evaluation loss pieces (no updates), as the reference stores them
        when the model is not training (losses.py:254-278)."""
        gamma = self.gamma if coefs is None else coefs[0]
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist)
        kl_loss, metrics = _kl_metrics(*latent_dist)
        tc_loss = torch.mean(d_z[:, 0] - d_z[:, 1])
        anneal_reg = (linear_annealing(0, 1, step, self.steps_anneal)
                      if is_train else 1.0)
        vae_loss = rec_loss + kl_loss + anneal_reg * gamma * tc_loss
        metrics.update(recon_loss=rec_loss, loss=vae_loss, tc_loss=tc_loss)
        return vae_loss, metrics


def permute_dims(latent_sample, perm):
    """Permute each latent dimension independently across the batch:
    out[i, d] = latent_sample[perm[i, d], d] (reference losses.py:483-508).
    `perm` (B, D) holds one permutation of the batch per column."""
    return torch.gather(latent_sample, 0, perm)


def draw_permutations(shape, generator=None, device=None):
    """(B, D) independent batch permutations, as the JAX package draws
    them: argsort of uniform noise along the batch axis."""
    noise = torch.rand(shape, generator=generator, device=device)
    return torch.argsort(noise, dim=0)


def softmax_cross_entropy(logits, labels):
    """Mean cross entropy with integer labels (F.cross_entropy)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None])[:, 0])


def factor_surrogate(loss_cfg, model, disc, data, step, eps1, eps2, perm,
                     is_train=True, n_valid=None, mesh=None, coefs=None):
    """One scalar whose backward gives the reference's two updates
    (disvae_tpu losses.py:378-446; reference losses.py:243-313).

    The VAE receives grad(vae_loss) + grad(d_tc_loss), since d_tc_loss's
    backward flows through D(z1) into the encoder; the discriminator
    receives grad(d_tc_loss) only. So `vae_loss` sees the discriminator's
    parameters detached (a functional call on detached tensors),
    `d_tc_loss` sees them live, and z_perm is detached.

    The batch splits as the reference's `data.split(half)`: data1 = rows
    [0, half), data2 = rows [half, 2 half); an odd trailing row is dropped.
    eps1 / eps2 (>= half, D) are the reparameterization noise of the two
    halves and `perm` (>= half, D) the permutations of z2's dimensions;
    their first `half` rows are used (a pinned draw of a padded batch may
    carry more).

    With `n_valid` (a padded batch) the split holds at the true size:
    half = n_valid // 2, data2 starts at row `half`, and the result equals
    the unpadded batch's. With `mesh`, `data` is this rank's contiguous
    share of the global batch: each local row takes its part by its
    GLOBAL index (data1 rows are a prefix of the share, data2 rows the
    block after them, either may be empty), so the halves may straddle
    ranks. The reconstruction sum is all-reduced; mu, logvar and z of
    every local row are gathered, and the KL, the permutation and both
    discriminator terms run on the global halves on every rank alike. A
    tensor-parallel `disc` (parallel/mesh.py ColumnParallelLinear) runs
    its three forwards through its shards, the detached one included, so
    the latent's gradient from each is summed over the model group.
    Returns (surrogate, metrics)."""
    b = data.shape[0]
    row0, total = ((0, b) if mesh is None
                   else (mesh.data_rank * b, mesh.data_size * b))
    half = (total if n_valid is None else int(n_valid)) // 2
    # local rows [0, a) are data1 rows row0 + i, rows [a, c) data2 rows
    # row0 + i - half; rows from c on are dropped or padding
    a = min(max(half - row0, 0), b)
    c = min(max(2 * half - row0, 0), b)
    D = eps1.shape[1]

    rec_sum = data.new_zeros(())
    mu1 = logvar1 = z1 = data.new_zeros((0, D))
    if a:
        data1 = data[:a]
        recon, (mu1, logvar1), z1 = model(data1, eps=eps1[row0:row0 + a])
        rec_sum = _reconstruction_sum(data1, recon, loss_cfg.rec_dist)
    z2 = data.new_zeros((0, D))
    if c > a:
        z2 = model.sample_latent(data[a:c],
                                 eps=eps2[row0 + a - half:row0 + c - half])
    if mesh is not None:
        rec_sum = all_reduce_sum(rec_sum, mesh)
        rows = torch.cat([torch.cat([mu1, logvar1, z1], 1),
                          F.pad(z2, (2 * D, 0)),
                          data.new_zeros((b - c, 3 * D))])
        rows = gather_rows(rows, mesh)
        mu1, logvar1, z1 = (t.contiguous() for t in rows[:half].split(D, 1))
        z2 = rows[half:2 * half, 2 * D:].contiguous()
    rec_loss = rec_sum / half
    kl_loss, metrics = _kl_metrics(mu1, logvar1)

    detached = {k: v.detach() for k, v in disc.named_parameters()}
    d_z_for_vae = functional_call(disc, detached, (z1,))
    tc_loss = torch.mean(d_z_for_vae[:, 0] - d_z_for_vae[:, 1])
    anneal_reg = (linear_annealing(0, 1, step, loss_cfg.steps_anneal)
                  if is_train else 1.0)
    gamma = loss_cfg.gamma if coefs is None else coefs[0]
    vae_loss = rec_loss + kl_loss + anneal_reg * gamma * tc_loss

    # discriminator loss: real z1 against the detached permuted z2
    z_perm = permute_dims(z2, perm[:half]).detach()
    zeros = torch.zeros(half, dtype=torch.long, device=data.device)
    d_tc_loss = 0.5 * (softmax_cross_entropy(disc(z1), zeros)
                       + softmax_cross_entropy(disc(z_perm), zeros + 1))

    metrics.update(recon_loss=rec_loss, loss=vae_loss, tc_loss=tc_loss,
                   discrim_loss=d_tc_loss)
    return vae_loss + d_tc_loss, metrics


def _log_pz_qz_prodzi_qzCx(latent_sample, latent_dist, n_data, is_mss=True,
                           n_valid=None):
    """btcvae estimator internals (disvae_tpu losses.py:449-483, reference
    losses.py:523-544).

    With `n_valid`, rows past it are padding: their mixture components
    leave the logsumexp through a -inf column mask (the masked MSS weights
    carry it; the MWS path gets an explicit one), so rows < n_valid hold
    the values of the unpadded batch. Padded ROWS still compute; the
    caller's batch means exclude them."""
    batch_size = latent_sample.shape[0]
    mean, logvar = latent_dist

    log_q_zCx = torch.sum(log_density_gaussian(latent_sample, mean, logvar),
                          dim=1)
    zeros = torch.zeros_like(latent_sample)
    log_pz = torch.sum(log_density_gaussian(latent_sample, zeros, zeros),
                       dim=1)

    mat_log_qz = matrix_log_density_gaussian(latent_sample, mean, logvar)
    if is_mss:
        if n_valid is None:
            log_iw = log_importance_weight_matrix(
                batch_size, n_data, dtype=mat_log_qz.dtype,
                device=mat_log_qz.device)
        else:
            log_iw = log_importance_weight_matrix_masked(
                batch_size, n_valid, n_data, dtype=mat_log_qz.dtype,
                device=mat_log_qz.device)
        mat_log_qz = mat_log_qz + log_iw[:, :, None]
    elif n_valid is not None:
        col_mask = torch.zeros(batch_size, dtype=mat_log_qz.dtype,
                               device=mat_log_qz.device)
        col_mask[n_valid:] = -math.inf
        mat_log_qz = mat_log_qz + col_mask[None, :, None]

    log_qz = torch.logsumexp(mat_log_qz.sum(dim=2), dim=1)
    log_prod_qzi = torch.logsumexp(mat_log_qz, dim=1).sum(dim=1)
    return log_pz, log_qz, log_prod_qzi, log_q_zCx
