"""The losses' annealing on the train state's device step counter, against
the JAX package's losses at a traced step, and the two step counters of
the port's TrainState.

Tolerance: the loss-parity tolerances of tests/test_torch_losses.py (rtol
1e-5, atol 1e-6); the annealing factor itself bit for bit (both take the
float32 ramp init + delta * step / steps and clamp it); a whole step's
gradients at the evidence run's settings as GRAD_L2 says.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.models.discriminator import Discriminator as JaxDisc
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.torch_compat import (disc_from_jax_params,
                                                 from_jax_params)

RTOL, ATOL = 1e-5, 1e-6
# gradients at b64 on 64 x 64 images, |d|_2 / |g|_2 per tensor: the two
# frameworks' float32 convolutions round differently, and a ReLU whose
# pre-activation lands on the other side of 0 passes another unit's
# gradient; the decoder's linear layers, at the end of that chain, were
# measured up to 5.2e-4 apart on an x86 CPU (4.3e-4 with oneDNN)
GRAD_L2 = 1e-3
ANNEAL = 10000
STEPS = [1, 2, 5000, 10000, 10001]
KWARGS = dict(rec_dist="bernoulli", reg_anneal=ANNEAL, betaH_B=4,
              betaB_initC=0, betaB_finC=25, betaB_G=100, btcvae_A=1,
              btcvae_B=6.4, btcvae_G=1, n_data=737280, latent_dim=10,
              factor_G=6.4, lr_disc=1e-4)


def _batch(seed, B=16, D=10):
    rng = np.random.RandomState(seed)
    data = (rng.rand(B, 32, 32, 1) > 0.5).astype(np.float32)
    recon = rng.uniform(0.02, 0.98, (B, 32, 32, 1)).astype(np.float32)
    mu = rng.randn(B, D).astype(np.float32)
    logvar = (0.5 * rng.randn(B, D)).astype(np.float32)
    z = (mu + np.exp(0.5 * logvar) * rng.randn(B, D)).astype(np.float32)
    return data, recon, mu, logvar, z


def _device_step(step):
    """The step as TrainState carries it: a 0-d int64 tensor."""
    return torch.tensor(step, dtype=torch.int64)


def _assert_dicts_close(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(port[k].detach()), float(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("step", STEPS)
def test_annealing_factor_bitwise_jax(step):
    for init, fin in [(0, 1), (0.0, 25.0)]:
        ref = jax.jit(lambda s: JL.linear_annealing(init, fin, s, ANNEAL))(
            jnp.int32(step))
        for s in (_device_step(step), step):  # a Python int as well
            got = PL.linear_annealing(init, fin, s, ANNEAL)
            assert got.dtype == torch.float32
            assert got.item() == float(ref), (init, fin, s)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("loss", ["betaH", "betaB", "btcvae"])
def test_tensor_step_losses_match_jax_traced_step(loss, step):
    """Each loss in training mode at the device step, with the coefficient
    vector the train state carries, against the JAX loss jitted over a
    traced int32 step: the annealed terms agree across the ramp, at its
    end and past it."""
    data, recon, mu, logvar, z = _batch(step % 7)
    j_cfg = JL.get_loss_f(loss, **KWARGS)
    p_cfg = PL.get_loss_f(loss, **KWARGS)

    @jax.jit
    def jax_loss(s):
        return j_cfg(jnp.asarray(data), jnp.asarray(recon),
                     (jnp.asarray(mu), jnp.asarray(logvar)), True, s,
                     latent_sample=jnp.asarray(z),
                     coefs=JL.coef_vector(j_cfg))
    j_loss, j_metrics = jax_loss(jnp.int32(step))
    t = [torch.from_numpy(a) for a in (data, recon, mu, logvar, z)]
    p_loss, p_metrics = p_cfg(t[0], t[1], (t[2], t[3]), True,
                              _device_step(step), latent_sample=t[4],
                              coefs=PL.coef_vector(p_cfg))
    _assert_dicts_close(p_metrics, j_metrics)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL)


@pytest.mark.parametrize("step", STEPS)
def test_factor_tensor_step_matches_jax_traced_step(step):
    """FactorVAE at the device step: `factor_surrogate` (the training
    scalar, on JAX's own noise) and `eval_losses` in training mode, against
    JAX's at a traced int32 step."""
    B, D = 16, 10
    batch = np.random.RandomState(step % 5).rand(B, 32, 32, 1).astype(
        np.float32)
    j_cfg = JL.get_loss_f("factor", **KWARGS)
    p_cfg = PL.get_loss_f("factor", **KWARGS)
    model, params = jax_init("Burgess", (1, 32, 32), D,
                             key=jax.random.PRNGKey(0))
    disc = JaxDisc(latent_dim=D)
    disc_params = disc.init(jax.random.PRNGKey(1))
    rng = jax.random.PRNGKey(2)

    @jax.jit
    def jax_surrogate(s):
        return JL.factor_surrogate(j_cfg, model, disc, params, disc_params,
                                   jnp.asarray(batch), rng, s,
                                   coefs=JL.coef_vector(j_cfg))
    j_total, j_metrics = jax_surrogate(jnp.int32(step))
    r1, r2, rp = jax.random.split(rng, 3)
    h = B // 2
    eps1, eps2 = (torch.from_numpy(np.array(jax.random.normal(r, (h, D))))
                  for r in (r1, r2))
    perm = torch.from_numpy(np.array(jnp.argsort(
        jax.random.uniform(rp, (h, D)), axis=0))).long()

    port = VAE((1, 32, 32), D)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    p_disc = Discriminator(latent_dim=D)
    p_disc.load_state_dict(disc_from_jax_params(
        jax.tree_util.tree_map(np.array, disc_params)))
    port.train()
    p_total, p_metrics = PL.factor_surrogate(
        p_cfg, port, p_disc, torch.from_numpy(batch), _device_step(step),
        eps1, eps2, perm, coefs=PL.coef_vector(p_cfg))
    _assert_dicts_close(p_metrics, j_metrics)
    np.testing.assert_allclose(float(p_total.detach()), float(j_total),
                               rtol=RTOL)

    data, recon, mu, logvar, z = _batch(step % 3)
    d_z = np.random.RandomState(step % 11).randn(16, 2).astype(np.float32)
    _, j_eval = jax.jit(lambda s: j_cfg.eval_losses(
        jnp.asarray(data), jnp.asarray(recon),
        (jnp.asarray(mu), jnp.asarray(logvar)), jnp.asarray(d_z), True,
        s))(jnp.int32(step))
    t = [torch.from_numpy(a) for a in (data, recon, mu, logvar, d_z)]
    _, p_eval = p_cfg.eval_losses(t[0], t[1], (t[2], t[3]), t[4], True,
                                  _device_step(step))
    _assert_dicts_close(p_eval, j_eval)


@pytest.mark.parametrize("step", [1, 5000, 10001])
def test_evidence_config_step_matches_jax(step):
    """One train step at the evidence run's settings (btcvae_dsprites: b64
    on 64 x 64 dsprites lattice images, lr 5e-4, B = 6.4, MSS weights at N
    = 737,280, reg_anneal 10,000) from one set of weights and JAX's own
    noise, on the ramp, at its end and past it: every logged metric within
    the loss-parity tolerances and every gradient within GRAD_L2 of its
    tensor's norm."""
    from disvae_tpu.train.state import create_train_state as jax_state
    from disvae_tpu.train.steps import make_optimizer as jax_opt
    from disvae_tpu.train.steps import make_train_step as jax_step
    from disvae_tpu_torch.data.synthetic import render_factor_lattice
    from disvae_tpu_torch.utils.torch_compat import to_jax_params
    B, D, lr = 64, 10, 5e-4
    imgs = render_factor_lattice((3, 6, 4, 4, 4))
    batch = imgs[np.random.RandomState(step).randint(0, len(imgs), B)]
    batch = batch.astype(np.float32)
    j_cfg = JL.get_loss_f("btcvae", **KWARGS)
    p_cfg = PL.get_loss_f("btcvae", **KWARGS)
    model, params = jax_init("Burgess", (1, 64, 64), D,
                             key=jax.random.PRNGKey(0))
    state = jax_state(model, params, jax_opt(lr), jax.random.PRNGKey(1),
                      loss_cfg=j_cfg).replace(step=jnp.int32(step - 1))
    _, sub = jax.random.split(state.rng)

    def loss(p):
        recon, dist, z = model.apply(p, jnp.asarray(batch), sub,
                                     is_train=True)
        return j_cfg(jnp.asarray(batch), recon, dist, True, step,
                     latent_sample=z, coefs=state.coefs)[0]
    j_grads = jax.grad(loss)(state.params)
    _, j_metrics = jax_step(model, j_cfg, jax_opt(lr), donate=False)(
        state, jnp.asarray(batch))

    port = VAE((1, 64, 64), D)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    p_state = create_train_state(port, make_optimizer(port.parameters(), lr),
                                 torch.Generator(), loss_cfg=p_cfg)
    p_state.step = step - 1
    p_state.device_step.fill_(step - 1)
    eps = torch.from_numpy(np.array(jax.random.normal(sub, (B, D))))
    p_metrics = make_train_step(p_cfg)(p_state, torch.from_numpy(batch),
                                       {"eps": eps})
    assert p_state.step == int(p_state.device_step) == step
    _assert_dicts_close(p_metrics, j_metrics)
    p_grads = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(
        {k: p.grad for k, p in port.named_parameters()})))
    for path, g in jax.tree_util.tree_leaves_with_path(j_grads):
        g = np.asarray(g, np.float64)
        rel = np.linalg.norm(g - np.asarray(p_grads[path], np.float64)) / (
            np.linalg.norm(g) + 1e-30)
        assert rel <= GRAD_L2, (jax.tree_util.keystr(path), rel)


def test_loss_term_gradients_match_jax_in_float64():
    """Each btcvae term's gradient at the evidence settings (b64, 64 x 64
    lattice images, N = 737,280, step 5,000 on the ramp), both packages
    in float64 from the same weights and noise, so float32 rounding
    cannot hide a difference: the decoder's sigmoid output and the
    encoder's (mu, logvar) stay float32 by design in both, which bounds
    the agreement near 1e-6 of each gradient's norm; every term within
    1e-5."""
    from disvae_tpu_torch.data.synthetic import render_factor_lattice
    from disvae_tpu_torch.utils.torch_compat import to_jax_params
    B, D, step = 64, 10, 5000
    imgs = render_factor_lattice((3, 6, 4, 4, 4))
    batch = imgs[np.random.RandomState(3).randint(0, len(imgs), B)]
    data = batch.astype(np.float32)
    eps = np.random.RandomState(9).randn(B, D)
    j_cfg = JL.get_loss_f("btcvae", **KWARGS)
    p_cfg = PL.get_loss_f("btcvae", **KWARGS)
    model, params = jax_init("Burgess", (1, 64, 64), D,
                             key=jax.random.PRNGKey(0))
    port = VAE((1, 64, 64), D)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    port = port.double().train()
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
        for term in ["recon_loss", "mi_loss", "tc_loss", "dw_kl_loss",
                     "loss"]:
            def loss(p):
                mean, logvar = model.encode(p, jnp.asarray(batch,
                                                           jnp.float64))
                z = mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps)
                recon = model.decode(p, z)
                return j_cfg(jnp.asarray(data), recon, (mean, logvar), True,
                             step, latent_sample=z)[1][term]
            j_grads = jax.grad(loss)(params)
            port.zero_grad()
            recon, dist, z = port(torch.from_numpy(batch).double(),
                                  eps=torch.from_numpy(eps))
            p_cfg(torch.from_numpy(data), recon, dist, True,
                  _device_step(step), latent_sample=z)[1][term].backward()
            p_grads = dict(jax.tree_util.tree_leaves_with_path(
                to_jax_params({k: torch.zeros_like(p) if p.grad is None
                               else p.grad
                               for k, p in port.named_parameters()})))
            for path, g in jax.tree_util.tree_leaves_with_path(j_grads):
                g = np.asarray(g)
                if not np.any(g):
                    continue
                rel = np.linalg.norm(g - p_grads[path]) / np.linalg.norm(g)
                assert rel <= 1e-5, (term, jax.tree_util.keystr(path), rel)


def _state(loss="btcvae"):
    cfg = PL.get_loss_f(loss, **dict(KWARGS, n_data=64))
    model = init_specific_model("Burgess", (1, 32, 32), 10,
                                generator=torch.Generator().manual_seed(0))
    return cfg, create_train_state(
        model, make_optimizer(model.parameters(), 1e-3),
        torch.Generator().manual_seed(1), loss_cfg=cfg)


def test_train_state_saves_and_restores_the_device_step():
    """Each step adds one to both counters; `state_dict()` carries both and
    a fresh state loads both; counters that disagree raise, on save and on
    load."""
    cfg, state = _state()
    assert state.device_step.dtype == torch.int64 and state.step == 0
    batch = torch.from_numpy((np.random.RandomState(0).rand(8, 32, 32, 1)
                              * 255).astype(np.uint8))
    step = make_train_step(cfg)
    for _ in range(3):
        step(state, batch)
    assert state.step == int(state.device_step) == 3
    sd = state.state_dict()
    assert sd["step"] == 3 and int(sd["device_step"]) == 3
    _, fresh = _state()
    fresh.load_state_dict(sd)
    assert fresh.step == int(fresh.device_step) == 3
    step(fresh, batch)
    assert fresh.step == int(fresh.device_step) == 4

    bad = dict(sd, device_step=torch.tensor(2))
    with pytest.raises(ValueError, match="counters disagree"):
        fresh.load_state_dict(bad)
    fresh.device_step.fill_(9)
    with pytest.raises(RuntimeError, match="device step counter"):
        fresh.state_dict()


def test_trainer_resume_restores_both_counters(tmp_path):
    """A Trainer resumed from train_state.pt starts with both counters at
    the checkpoint's step and ends with them equal."""
    cfg = PL.get_loss_f("betaH", **dict(KWARGS, n_data=40))
    ds = PD.ArrayDataset((np.random.RandomState(2).rand(40, 32, 32, 1)
                          * 255).astype(np.uint8))

    def trainer(resume=False):
        model = init_specific_model(
            "Burgess", (1, 32, 32), 10,
            generator=torch.Generator().manual_seed(0))
        return Trainer(model, cfg, lr=1e-3, seed=1, is_progress_bar=False,
                       save_dir=str(tmp_path), resume=resume)

    trainer()(PD.DataLoader(ds, batch_size=16, shuffle=True, seed=0),
              epochs=1, checkpoint_every=1)
    resumed = trainer(resume=True)
    assert resumed.state.step == int(resumed.state.device_step) == 3
    resumed(PD.DataLoader(ds, batch_size=16, shuffle=True, seed=0),
            epochs=2, checkpoint_every=1)
    assert resumed.state.step == int(resumed.state.device_step) == 6
