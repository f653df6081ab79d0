"""Data-parallel cases on the card, shared by tests/test_torch_gpu.py and
chip_smoke.py: a celeba-shaped train state, pinned noise, and how far two
train states are apart. Imports torch and the port only (never jax).
"""

import numpy as np
import torch


def celeba_state(loss, device, n_data=202599, seed=0):
    """btcvae_celeba's settings (B = 6.4, lr 5e-4; FactorVAE lr 1e-4 and
    lr_disc 1e-5, gamma 6.4) on a seeded Burgess 64x64x3 model."""
    from disvae_tpu_torch.models.discriminator import Discriminator
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                              make_optimizer)
    cfg = PL.get_loss_f(loss, rec_dist="bernoulli", reg_anneal=0,
                        btcvae_A=1, btcvae_B=6.4, btcvae_G=1, factor_G=6.4,
                        latent_dim=10, lr_disc=1e-5, n_data=n_data)
    model = init_specific_model(
        "Burgess", (3, 64, 64), 10,
        generator=torch.Generator().manual_seed(seed), device=device)
    disc = disc_opt = None
    if cfg.needs_discriminator:
        disc = Discriminator(
            latent_dim=10,
            generator=torch.Generator().manual_seed(seed + 2)).to(device)
        disc_opt = make_disc_optimizer(disc.parameters(), cfg)
    lr = 1e-4 if cfg.needs_discriminator else 5e-4
    return cfg, create_train_state(
        model, make_optimizer(model.parameters(), lr),
        torch.Generator(device=device).manual_seed(seed + 1), disc=disc,
        disc_optimizer=disc_opt, loss_cfg=cfg)


def celeba_batch(n, device, seed=2):
    return torch.from_numpy((np.random.RandomState(seed).rand(n, 64, 64, 3)
                             * 255).astype(np.uint8)).to(device)


def pinned_noise(cfg, n, device, seed=3):
    """The noise a step draws for a global batch of n rows, drawn once so
    that two steps can share it."""
    from disvae_tpu_torch.ops.losses import draw_permutations
    g = torch.Generator(device=device).manual_seed(seed)
    if not cfg.needs_discriminator:
        return {"eps": torch.randn((n, 10), generator=g, device=device)}
    shape = (n // 2, 10)
    return {"eps1": torch.randn(shape, generator=g, device=device),
            "eps2": torch.randn(shape, generator=g, device=device),
            "perm": draw_permutations(shape, g, device)}


def _tensors(state):
    """name -> tensor: every parameter and Adam moment of a train state."""
    out = {}
    for part, opt in (("model", "optimizer"), ("disc", "disc_optimizer")):
        module = getattr(state, part)
        if module is None:
            continue
        params = dict(module.named_parameters())
        moments = getattr(state, opt).state
        for k, p in params.items():
            out["{}.{}".format(part, k)] = p.detach()
            for m in ("exp_avg", "exp_avg_sq"):
                out["{}.{}.{}".format(part, k, m)] = moments[p][m]
    return out


def state_diff(a, b):
    """(max over tensors of max |a - b| / max |a|, bitwise equal) over the
    parameters and Adam moments of two train states."""
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    worst, equal = 0.0, True
    for k, x in ta.items():
        y = tb[k]
        worst = max(worst, ((x - y).abs().max()
                            / x.abs().max().clamp_min(1e-30)).item())
        equal = equal and torch.equal(x, y)
    return worst, equal


def settled_param_diff(ref, other, frac=1e-2):
    """max |d| over the parameters whose gradient in `ref` is at least
    `frac` of its tensor's largest: there Adam's step, lr * g / (|g| +
    eps), does not turn gradient noise into a sign flip."""
    worst = 0.0
    for part in ("model", "disc"):
        if getattr(ref, part) is None:
            continue
        for p, q in zip(getattr(ref, part).parameters(),
                        getattr(other, part).parameters()):
            g = p.grad.abs()
            keep = g >= frac * g.max()
            worst = max(worst, (p - q).abs()[keep].max().item())
    return worst
