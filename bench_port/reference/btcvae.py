"""The beta-TCVAE training step (Chen et al. 2018) as the reference
repository computes it, with torch's Adam written out.

Loss per batch of B images x with posterior (mu, logvar), sample
z = mu + exp(logvar / 2) * eps and reconstruction r:
  rec   = sum over pixels of BCE(r, x) (log clamped at -100), over B;
  log q(z|x) = sum_d log N(z_d; mu_d, var_d); log p(z) likewise at N(0, 1);
  mat[i, j, d] = log N(z_i,d; mu_j,d, var_j,d), plus the minibatch
  stratified sampling log-weights (the reference's strided fill, which
  writes columns 0 and 1 and one corner, not the diagonal);
  log q(z)   = logsumexp_j sum_d mat[i, j, d];
  log prod q(z_d) = sum_d logsumexp_j mat[i, j, d];
  loss = rec + alpha MI + beta TC + anneal gamma dwKL, anneal =
  min(1, step / steps_anneal) with the step counted from 1.
"""

import math

import torch
import torch.nn.functional as F

from . import model

_LOG_2PI = math.log(2 * math.pi)


def _log_density(x, mu, logvar):
    return -0.5 * (_LOG_2PI + logvar + (x - mu) ** 2 * torch.exp(-logvar))


def _log_importance_weights(batch, n_data, device):
    """The reference's `log_importance_weight_matrix`, its strided writes
    kept as they are."""
    m = batch - 1
    strat = (n_data - m) / (n_data * m)
    w = torch.full((batch, batch), 1.0 / m, device=device)
    flat = w.view(-1)
    flat[::m + 1] = 1.0 / n_data
    flat[1::m + 1] = strat
    w[m - 1, 0] = strat
    return w.log()


def loss(params, x, eps, step, cfg, numerics):
    """The btcvae loss of one batch (x NHWC float32 in [0, 1], eps the
    reparameterisation noise) at training step `step` (1 for the first),
    and each latent's KL to the prior over the batch (the logged
    kl_loss_i)."""
    mu, logvar = model.encode(params, x, numerics)
    z = mu + torch.exp(0.5 * logvar) * eps
    recon = model.decode(params, z, numerics)
    b = x.shape[0]
    rec = F.binary_cross_entropy(recon, x, reduction="sum") / b
    log_q_zx = _log_density(z, mu, logvar).sum(1)
    log_pz = _log_density(z, torch.zeros_like(z), torch.zeros_like(z)).sum(1)
    mat = _log_density(z[:, None], mu[None], logvar[None])
    mat = mat + _log_importance_weights(b, cfg["n_images"],
                                        x.device)[:, :, None]
    log_qz = torch.logsumexp(mat.sum(2), dim=1)
    log_prod = torch.logsumexp(mat, dim=1).sum(1)
    mi = (log_q_zx - log_qz).mean()
    tc = (log_qz - log_prod).mean()
    dw_kl = (log_prod - log_pz).mean()
    anneal = (min(1.0, step / cfg["reg_anneal"]) if cfg["reg_anneal"]
              else 1.0)
    # the KL to N(0, I) of each latent, over the batch, as logged
    kl = 0.5 * (-1 - logvar + mu ** 2 + torch.exp(logvar)).mean(0)
    return rec + (cfg["btcvae_A"] * mi + cfg["btcvae_B"] * tc
                  + anneal * cfg["btcvae_G"] * dw_kl), kl


class Adam:
    """torch's Adam (Kingma & Ba), betas (0.9, 0.999), eps 1e-8, written
    out: m and v are the first and second moments, bias-corrected by the
    step count."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads):
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_steps(weights, batches, noises, cfg, numerics):
    """Follow the program's first steps from the same weights, batches and
    noise. Returns {"losses": the loss of each step, "kl_step1": the
    first step's KL of each latent, "first_grads", "last_grads": the
    first and the last step's gradients, "params" and "m": the
    parameters and Adam's first moment after the last step}, tensors
    float32 on the weights' device."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, cfg["lr"])
    losses, first_grads = [], None
    with model.exact_float32():
        for t, (x, eps) in enumerate(zip(batches, noises)):
            value, kl = loss(params, x, eps, t + 1, cfg, numerics)
            grads = dict(zip(params, torch.autograd.grad(
                value, list(params.values()))))
            if first_grads is None:
                kl_step1 = kl.detach()
                first_grads = {k: g.detach().clone()
                               for k, g in grads.items()}
            last_grads = grads
            opt.step(grads)
            losses.append(float(value.detach()))
    return {"losses": losses, "kl_step1": kl_step1,
            "first_grads": first_grads,
            "last_grads": {k: g.detach() for k, g in last_grads.items()},
            "params": {k: v.detach() for k, v in params.items()},
            "m": opt.m}
