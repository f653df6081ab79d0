"""The VAE losses' forward, in PyTorch (disvae_tpu/ops/losses.py).

Every loss returns ``(loss, metrics_dict)`` with the JAX package's keys.
Data and reconstructions are NHWC float32 in [0, 1]. This slice serves
evaluation, so the losses run forward only; `is_train`/`step` keep their
meaning (annealing) so the signatures match the JAX package. FactorVAE
(adversarial, needs the discriminator and its train step) comes with the
training slice: ROADMAP.md, Queue 1 item 2.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from disvae_tpu_torch.ops.math import (log_density_gaussian,
                                       log_importance_weight_matrix,
                                       matrix_log_density_gaussian)

LOSSES = ["VAE", "betaH", "betaB", "factor", "btcvae"]
RECON_DIST = ["bernoulli", "laplace", "gaussian"]


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
        raise NotImplementedError(
            "The FactorVAE loss is not ported yet: it arrives with the "
            "training slice (ROADMAP.md, Queue 1 item 2).")
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
    """Linear ramp init -> fin over `annealing_steps` steps."""
    if annealing_steps == 0:
        return fin
    delta = fin - init
    return min(init + delta * step / annealing_steps, fin)


def reconstruction_loss(data, recon_data, distribution="bernoulli"):
    """Per-image negative log likelihood, summed over pixels and averaged
    over the batch (disvae_tpu losses.py:150-177).

    bernoulli -> summed BCE (F.binary_cross_entropy, whose -100 log clamp
    the JAX `_bce_sum` imitates); gaussian -> summed MSE in [0, 255] space /
    255; laplace -> summed L1 * 3.
    """
    batch_size = recon_data.shape[0]
    if distribution == "bernoulli":
        loss = F.binary_cross_entropy(recon_data, data, reduction="sum")
    elif distribution == "gaussian":
        loss = torch.sum((recon_data * 255 - data * 255) ** 2) / 255
    elif distribution == "laplace":
        loss = torch.sum(torch.abs(recon_data - data)) * 3
        loss = loss * (loss != 0)  # reference's nan guard (losses.py:439)
    else:
        raise ValueError("Unrecognized distribution: {}".format(distribution))
    return loss / batch_size


def kl_normal_loss(mean, logvar):
    """Closed-form KL(q || N(0, I)). Returns (total_kl, per_dim_kl), the
    per-dimension batch means logged as kl_loss_i."""
    term = -1 - logvar + mean ** 2 + torch.exp(logvar)
    latent_kl = 0.5 * torch.mean(term, dim=0)
    return torch.sum(latent_kl), latent_kl


def _kl_metrics(mean, logvar):
    total_kl, latent_kl = kl_normal_loss(mean, logvar)
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
    coef_names = ("beta",)

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, coefs=None, **unused):
        beta = self.beta if coefs is None else coefs[0]
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist)
        kl_loss, metrics = _kl_metrics(*latent_dist)
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
    coef_names = ("C_init", "C_fin", "gamma")

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, coefs=None, **unused):
        C_init, C_fin, gamma = ((self.C_init, self.C_fin, self.gamma)
                                if coefs is None else coefs)
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist)
        kl_loss, metrics = _kl_metrics(*latent_dist)
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
    coef_names = ("alpha", "beta", "gamma")

    def __call__(self, data, recon_data, latent_dist, is_train, step,
                 latent_sample=None, coefs=None, **unused):
        alpha, beta, gamma = ((self.alpha, self.beta, self.gamma)
                              if coefs is None else coefs)
        rec_loss = reconstruction_loss(data, recon_data, self.rec_dist)
        log_pz, log_qz, log_prod_qzi, log_q_zCx = _log_pz_qz_prodzi_qzCx(
            latent_sample, latent_dist, self.n_data, is_mss=self.is_mss)

        mi_loss = torch.mean(log_q_zCx - log_qz)        # I[z;x]
        tc_loss = torch.mean(log_qz - log_prod_qzi)     # TC[z]
        dw_kl_loss = torch.mean(log_prod_qzi - log_pz)  # dwKL
        anneal_reg = (linear_annealing(0, 1, step, self.steps_anneal)
                      if is_train else 1.0)
        loss = rec_loss + (alpha * mi_loss
                           + beta * tc_loss
                           + anneal_reg * gamma * dw_kl_loss)
        _, metrics = _kl_metrics(*latent_dist)
        metrics.update(recon_loss=rec_loss, loss=loss, mi_loss=mi_loss,
                       tc_loss=tc_loss, dw_kl_loss=dw_kl_loss)
        return loss, metrics


def _log_pz_qz_prodzi_qzCx(latent_sample, latent_dist, n_data, is_mss=True):
    """btcvae estimator internals (disvae_tpu losses.py:449-483, reference
    losses.py:523-544)."""
    batch_size = latent_sample.shape[0]
    mean, logvar = latent_dist

    log_q_zCx = torch.sum(log_density_gaussian(latent_sample, mean, logvar),
                          dim=1)
    zeros = torch.zeros_like(latent_sample)
    log_pz = torch.sum(log_density_gaussian(latent_sample, zeros, zeros),
                       dim=1)

    mat_log_qz = matrix_log_density_gaussian(latent_sample, mean, logvar)
    if is_mss:
        log_iw = log_importance_weight_matrix(
            batch_size, n_data, dtype=mat_log_qz.dtype,
            device=mat_log_qz.device)
        mat_log_qz = mat_log_qz + log_iw[:, :, None]

    log_qz = torch.logsumexp(mat_log_qz.sum(dim=2), dim=1)
    log_prod_qzi = torch.logsumexp(mat_log_qz, dim=1).sum(dim=1)
    return log_pz, log_qz, log_prod_qzi, log_q_zCx
