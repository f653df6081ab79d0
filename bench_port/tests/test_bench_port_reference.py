"""The plain reference against the program at a small size on the CPU:
the model under both numerics, the beta-TCVAE step with Adam, the
mixture log-density of the MIG/AAM estimator.

    python -m pytest bench_port/tests -q
"""

import math

import numpy as np
import pytest
import torch

from tiny import restore_program

import inputs
from reference import btcvae, mig, model

CPU = torch.device("cpu")


def _program(img_size, seed, compute_dtype="float32"):
    from disvae_tpu_torch.models.vae import VAE
    weights = inputs.vae_weights(img_size, 10, seed, CPU)
    vae = VAE(img_size, 10, compute_dtype=compute_dtype)
    vae.load_state_dict(weights)
    return vae, weights


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("precision, numerics", [("highest", "float32"),
                                                 ("default",
                                                  "bf16_operands")])
def test_reference_model_matches_the_program(precision, numerics):
    from disvae_tpu_torch.ops.precision import configure
    configure(precision)
    try:
        vae, p = _program((3, 64, 64), 3)
        x = torch.rand((4, 64, 64, 3), generator=torch.Generator()
                       .manual_seed(0))
        z = torch.randn((4, 10), generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            mu, logvar = vae.encode(x)
            rmu, rlogvar = model.encode(p, x, numerics)
            assert _rel(mu, rmu) < 1e-5 and _rel(logvar, rlogvar) < 1e-5
            assert _rel(vae.decode(z), model.decode(p, z, numerics)) < 1e-5
    finally:
        restore_program()


def test_reference_btcvae_steps_match_the_program():
    """Three train steps on pinned noise, float32: each loss, the first
    gradients, the parameters and Adam's first moment after the last."""
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
    cfg = {"n_images": 100, "reg_anneal": 10000, "btcvae_A": 1.0,
           "btcvae_B": 6.4, "btcvae_G": 1.0, "lr": 5e-4,
           "rec_dist": "bernoulli"}
    vae, weights = _program((1, 32, 32), 4)
    loss_f = get_loss_f("btcvae", n_data=100, **cfg)
    state = create_train_state(vae, make_optimizer(vae.parameters(), 5e-4),
                               torch.Generator(), loss_cfg=loss_f)
    step = make_train_step(loss_f)
    gen = torch.Generator().manual_seed(5)
    batches = [torch.randint(0, 256, (8, 32, 32, 1), generator=gen)
               .float() / 255 for _ in range(3)]
    noises = [torch.randn((8, 10), generator=gen) for _ in range(3)]
    losses = []
    for t, (x, eps) in enumerate(zip(batches, noises)):
        losses.append(float(step(state, x, {"eps": eps})["loss"]))
        if t == 0:
            grads = {n: p.grad.clone() for n, p in vae.named_parameters()}
    ref = btcvae.train_steps(weights, batches, noises, cfg, "float32")
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    for n, p in vae.named_parameters():
        assert _rel(grads[n], ref["first_grads"][n]) < 1e-4
        assert float((p.detach() - ref["params"][n]).abs().max()) < 1e-6
        assert _rel(state.optimizer.state[p]["exp_avg"], ref["m"][n]) < 1e-4


def test_log_mixture_matches_a_direct_sum():
    g = torch.Generator().manual_seed(6)
    L, M, D, S = 2, 300, 3, 50
    values = torch.randn((L, D, S), generator=g)
    mu = torch.randn((L, M, D), generator=g)
    logvar = torch.randn((L, M, D), generator=g) - 1
    got = mig.log_mixture(values, mu, logvar)
    v = values.double()[:, None]                   # (L, 1, D, S)
    m = mu.double()[..., None]                     # (L, M, D, 1)
    lv = logvar.double()[..., None]
    ld = -0.5 * (math.log(2 * math.pi) + lv + (v - m) ** 2 * torch.exp(-lv))
    assert torch.allclose(got, torch.logsumexp(ld, dim=1), atol=1e-10)


def test_the_sprite_lattice_is_its_factors():
    imgs = inputs.sprite_lattice([3, 2, 2, 4, 4], CPU)
    assert imgs.shape == (3 * 2 * 2 * 16, 64, 64, 1)
    assert set(np.unique(imgs)) == {0, 1}
    # along posX and posY the same sprite moves, unchanged in area
    block = imgs[:16, ..., 0].reshape(4, 4, 64, 64)
    areas = block.sum(axis=(2, 3))
    assert (areas == areas[0, 0]).all()
    assert not (block[0, 0] == block[3, 3]).all()
