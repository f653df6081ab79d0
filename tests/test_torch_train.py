"""The port's training path against the JAX package's, and the port's
Trainer against itself (the mirror of tests/test_train.py).

One step, both packages: the same weights (torch_compat), the same batch,
and the noise drawn from the JAX step's own key splits, fed to the port as
pinned noise. Both run float32 at full precision (`highest`), so metrics
agree to rtol 1e-5 (atol 1e-6) and each gradient to max |d| / max |g| <=
1e-4 (summation order; the pairwise btcvae and adversarial terms amplify
it). After one Adam step from zero moments a parameter moves by about
lr * g / (|g| + eps), so a near-zero gradient element can move by any
fraction of lr; updated parameters are held to atol lr / 10.

The Trainer checks run on the CPU, where every step is deterministic, so
resident = streaming, pipelined = sequential and a resumed run = a straight
one hold bit for bit.
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
from disvae_tpu.train.state import create_train_state as jax_state
from disvae_tpu.train.steps import make_disc_optimizer as jax_disc_opt
from disvae_tpu.train.steps import make_optimizer as jax_opt
from disvae_tpu.train.steps import make_train_step as jax_step

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models import burgess
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.ops.convt_bwd import conv_transpose2d_pl
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                          make_optimizer, make_train_step)
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.torch_compat import (disc_from_jax_params,
                                                 disc_to_jax_params,
                                                 from_jax_params,
                                                 to_jax_params)

LR = 1e-3
KWARGS = dict(rec_dist="bernoulli", reg_anneal=0, betaH_B=4, betaB_initC=0,
              betaB_finC=25, betaB_G=100, btcvae_A=1, btcvae_B=6,
              btcvae_G=1, n_data=100, latent_dim=10, factor_G=6,
              lr_disc=5e-5)


def _jax_noise(cfg, rng, B, D):
    """The noise the JAX step draws from state.rng (train/steps.py:148,
    :174 and ops/losses.py:410, :362)."""
    _, sub = jax.random.split(rng)
    if not cfg.needs_discriminator:
        return {"eps": jax.random.normal(sub, (B, D))}
    r1, r2, rp = jax.random.split(sub, 3)
    h = B // 2
    return {"eps1": jax.random.normal(r1, (h, D)),
            "eps2": jax.random.normal(r2, (h, D)),
            "perm": jnp.argsort(jax.random.uniform(rp, (h, D)), axis=0)}


def _jax_grads(cfg, model, disc, state, batch, noise_rng):
    """The gradients the JAX step applies (its loss_fn, recomputed)."""
    _, sub = jax.random.split(noise_rng)
    if cfg.needs_discriminator:
        g = jax.grad(lambda p, dp: JL.factor_surrogate(
            cfg, model, disc, p, dp, batch, sub, 1, coefs=state.coefs)[0],
            argnums=(0, 1))(state.params, state.disc_params)
        return g
    def loss(p):
        recon, dist, z = model.apply(p, batch, sub, is_train=True)
        return cfg(batch, recon, dist, True, 1, latent_sample=z,
                   coefs=state.coefs)[0]
    return jax.grad(loss)(state.params), None


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / (
        np.abs(ref).max() + 1e-30)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("loss", ["betaH", "betaB", "btcvae", "factor"])
def test_one_step_matches_jax(loss):
    B, D = 16, 10
    batch = (np.random.RandomState(0).rand(B, 32, 32, 1) * 255).astype(
        np.uint8)
    j_cfg = JL.get_loss_f(loss, **KWARGS)
    p_cfg = PL.get_loss_f(loss, **KWARGS)
    model, params = jax_init("Burgess", (1, 32, 32), D,
                             key=jax.random.PRNGKey(0))
    disc = d_opt = None
    if j_cfg.needs_discriminator:
        disc, d_opt = JaxDisc(latent_dim=D), jax_disc_opt(j_cfg)
    state = jax_state(model, params, jax_opt(LR), jax.random.PRNGKey(1),
                      disc=disc, disc_optimizer=d_opt,
                      disc_rng=jax.random.PRNGKey(2), loss_cfg=j_cfg)
    noise = _jax_noise(j_cfg, state.rng, B, D)
    j_grads, j_dgrads = _jax_grads(j_cfg, model, disc, state,
                                   jnp.asarray(batch) / 255.0, state.rng)
    step = jax_step(model, j_cfg, jax_opt(LR), disc=disc,
                    disc_optimizer=d_opt, donate=False)
    j_new, j_metrics = step(state, jnp.asarray(batch))

    port = VAE((1, 32, 32), D)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    p_disc = p_dopt = None
    if p_cfg.needs_discriminator:
        p_disc = Discriminator(latent_dim=D)
        p_disc.load_state_dict(disc_from_jax_params(
            jax.tree_util.tree_map(np.array, state.disc_params)))
        p_dopt = make_disc_optimizer(p_disc.parameters(), p_cfg)
    p_state = create_train_state(port, make_optimizer(port.parameters(), LR),
                                 torch.Generator(), disc=p_disc,
                                 disc_optimizer=p_dopt, loss_cfg=p_cfg)
    p_noise = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    if "perm" in p_noise:
        p_noise["perm"] = p_noise["perm"].long()
    p_metrics = make_train_step(p_cfg)(p_state, torch.from_numpy(batch),
                                       p_noise)
    assert p_state.step == 1

    assert set(p_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(p_metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    pairs = [(to_jax_params({k: p.grad for k, p in port.named_parameters()}),
              j_grads, to_jax_params(port.state_dict()), j_new.params)]
    if p_disc is not None:
        pairs.append((disc_to_jax_params(
            {k: p.grad for k, p in p_disc.named_parameters()}), j_dgrads,
            disc_to_jax_params(p_disc.state_dict()), j_new.disc_params))
    for p_g, j_g, p_p, j_p in pairs:
        p_g, j_g, p_p, j_p = map(_leaves, (p_g, j_g, p_p, j_p))
        assert set(p_g) == set(j_g)
        for path in j_g:
            assert _rel(j_g[path], p_g[path]) <= 1e-4, (path, _rel(
                j_g[path], p_g[path]))
            np.testing.assert_allclose(p_p[path], np.asarray(j_p[path]),
                                       atol=LR / 10, rtol=0,
                                       err_msg=str(path))


def _btcvae_step_state(hook):
    """One btcvae train step of a seeded port model, with or without the
    final-convT hook."""
    cfg = PL.get_loss_f("btcvae", **KWARGS)
    model = init_specific_model("Burgess", (1, 32, 32), 10,
                                generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(model.parameters(), LR),
                               torch.Generator().manual_seed(1),
                               loss_cfg=cfg)
    batch = torch.from_numpy((np.random.RandomState(1).rand(16, 32, 32, 1)
                              * 255).astype(np.uint8))
    if hook:
        burgess.set_final_convt_impl(conv_transpose2d_pl)
    try:
        metrics = make_train_step(cfg)(state, batch)
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
    return metrics, model


def test_final_convt_hook_step_bitexact_under_parity():
    """The hook leaves a btcvae step bitwise unchanged under ``highest``
    (the mirror of tests/test_train.py's
    test_final_convt_hook_step_bitexact_under_parity)."""
    m_ref, model_ref = _btcvae_step_state(hook=False)
    m_got, model_got = _btcvae_step_state(hook=True)
    assert {k: float(v) for k, v in m_got.items()} == \
        {k: float(v) for k, v in m_ref.items()}
    for (k, a), b in zip(model_ref.state_dict().items(),
                         model_got.state_dict().values()):
        assert torch.equal(a, b), k


# ----------------------------------------------------------------------
# Trainer
# ----------------------------------------------------------------------

def _dataset(n, seed=0):
    imgs = (np.random.RandomState(seed).rand(n, 32, 32, 1) * 255).astype(
        np.uint8)
    return PD.ArrayDataset(imgs)


def _trainer(save_dir, cfg, **kw):
    model = init_specific_model("Burgess", (1, 32, 32), 10,
                                generator=torch.Generator().manual_seed(0))
    kw.setdefault("is_progress_bar", False)
    return Trainer(model, cfg, lr=LR, seed=1, save_dir=str(save_dir), **kw)


def _params_equal(a, b):
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("loss", ["VAE", "betaB", "btcvae", "factor"])
def test_trainer_log_and_checkpoints(tmp_path, loss):
    cfg = PL.get_loss_f(loss, **dict(KWARGS, n_data=96, reg_anneal=10))
    trainer = _trainer(tmp_path, cfg)
    trainer(PD.DataLoader(_dataset(96), batch_size=16, shuffle=True, seed=0),
            epochs=2, checkpoint_every=1)
    lines = (tmp_path / "train_losses.log").read_text().strip().split("\n")
    assert lines[0] == "Epoch,Loss,Value"
    # 96 / 16 = 6 steps per epoch; step 1 of epoch 0 is recorded, epoch 1
    # has no step with step % 50 == 1
    epoch0 = [l.split(",") for l in lines[1:] if l.startswith("0,")]
    assert [r[1] for r in epoch0] == PL.metric_key_order(cfg.name, 10)
    assert all(np.isfinite(float(r[2])) for r in epoch0)
    assert not [l for l in lines[1:] if l.startswith("1,")]
    for f in ("model-0.pt", "model-1.pt", "train_state.pt", "specs.json"):
        assert (tmp_path / f).exists(), f
    assert trainer.state.step == 12
    assert [e["epoch"] for e in trainer.epoch_stats] == [0, 1]
    if cfg.needs_discriminator:
        assert trainer.state.disc is not None


def test_record_gate_rows_are_recorded_step_means(tmp_path):
    """Epoch 1's row holds the metrics of step 51 alone (the only step of
    that epoch with step % 50 == 1)."""
    cfg = PL.get_loss_f("VAE", **KWARGS)
    trainer = _trainer(tmp_path, cfg, resident="always")
    loader = PD.DataLoader(_dataset(64), batch_size=2, shuffle=True, seed=0)
    trainer(loader, epochs=2, checkpoint_every=10)
    rows = [l.split(",") for l in
            (tmp_path / "train_losses.log").read_text().split("\n")[1:] if l]
    assert sorted({r[0] for r in rows}) == ["0", "1"]
    assert trainer.state.step == 64


@pytest.mark.parametrize("loss", ["btcvae", "factor"])
def test_resident_feed_matches_streaming(tmp_path, loss):
    """Same epoch order, same wire format, same steps, including the ragged
    26-row tail (90 % 32): the same parameters bit for bit."""
    cfg = PL.get_loss_f(loss, **dict(KWARGS, n_data=90, reg_anneal=20))
    ds = _dataset(90)
    out = {}
    for resident in ("never", "always"):
        tr = _trainer(tmp_path / resident, cfg, resident=resident)
        loader = PD.DataLoader(ds, batch_size=32, shuffle=True, seed=0)
        out[resident] = ([tr._train_epoch(loader, e)[0] for e in range(2)],
                         tr)
        assert (tr._resident is not None) == (resident == "always")
    assert out["never"][0] == out["always"][0]
    assert out["never"][1].state.step == out["always"][1].state.step == 6
    _params_equal(out["never"][1].model, out["always"][1].model)


def test_pipelined_epochs_match_sequential(tmp_path):
    cfg = PL.get_loss_f("btcvae", **dict(KWARGS, n_data=90, reg_anneal=20))
    runs = {}
    for pipelined in (False, True):
        save = tmp_path / str(pipelined)
        tr = _trainer(save, cfg, resident="always",
                      pipeline_epochs=pipelined, steps_per_dispatch=2)
        tr(PD.DataLoader(_dataset(90), batch_size=32, shuffle=True, seed=0),
           epochs=4, checkpoint_every=10)
        runs[pipelined] = (tr, (save / "train_losses.log").read_text())
    assert runs[True][1] == runs[False][1]
    assert runs[True][0].state.step == runs[False][0].state.step == 12
    _params_equal(runs[False][0].model, runs[True][0].model)


@pytest.mark.parametrize("loss", ["VAE", "factor"])
def test_checkpoint_resume_bitexact(tmp_path, loss):
    """4 epochs straight == 2 epochs, resume, 2 more: parameters, optimizer
    moments, generator and step counter all come back."""
    cfg = PL.get_loss_f(loss, **KWARGS)
    ds = _dataset(64)

    def loader():
        return PD.DataLoader(ds, batch_size=16, shuffle=True, seed=0)

    straight = _trainer(tmp_path / "straight", cfg)
    straight(loader(), epochs=4, checkpoint_every=1)
    first = _trainer(tmp_path / "resumed", cfg)
    first(loader(), epochs=2, checkpoint_every=1)
    resumed = _trainer(tmp_path / "resumed", cfg, resume=True)
    assert resumed._start_epoch == 2
    resumed(loader(), epochs=4, checkpoint_every=1)
    _params_equal(straight.model, resumed.model)
    if cfg.needs_discriminator:
        _params_equal(straight.state.disc, resumed.state.disc)
    assert straight.state.step == resumed.state.step == 16
    log = (tmp_path / "resumed" / "train_losses.log").read_text()
    assert log.count("\n0,loss,") == 1
    # and a resumed loss config keeps its own coefficients
    other = PL.get_loss_f(loss, **dict(KWARGS, betaH_B=8, factor_G=9))
    again = _trainer(tmp_path / "resumed", other, resume=True)
    assert torch.equal(again.state.coefs, PL.coef_vector(other))


@pytest.mark.parametrize("loss", ["factor", "btcvae"])
def test_tiny_tail_raises_by_default(tmp_path, loss):
    cfg = PL.get_loss_f(loss, **dict(KWARGS, n_data=33))
    trainer = _trainer(tmp_path, cfg, resident="never")
    loader = PD.DataLoader(_dataset(33), batch_size=16, shuffle=True, seed=0)
    with pytest.raises(ValueError, match="half|M = B-1"):
        trainer(loader, epochs=1, checkpoint_every=10)
    assert trainer.state.step == 0  # raised before any step ran


@pytest.mark.parametrize("resident", ["never", "always"])
def test_tiny_tail_optin_skips_with_warning(tmp_path, caplog, resident):
    import logging
    cfg = PL.get_loss_f("btcvae", **dict(KWARGS, n_data=33))
    loader = PD.DataLoader(_dataset(33), batch_size=16, shuffle=True, seed=0)
    trainer = _trainer(tmp_path / "skip", cfg, resident=resident,
                       skip_tiny_tail=True)
    with caplog.at_level(logging.WARNING):
        trainer(loader, epochs=1, checkpoint_every=10)
    assert any("Skipping a final batch" in r.message for r in caplog.records)
    assert trainer.state.step == 2
    # betaH is defined on one sample: the tail trains, nothing is skipped
    ok = _trainer(tmp_path / "ok", PL.get_loss_f("betaH", **KWARGS),
                  resident=resident)
    ok(loader, epochs=1, checkpoint_every=10)
    assert ok.state.step == 3


@pytest.mark.parametrize("loss", ["btcvae", "factor"])
def test_cli_trains_on_cpu(tmp_path, monkeypatch, loss):
    """`python -m disvae_tpu_torch <name> --no-cuda ...` trains, writes the
    JAX package's artifact set, then evaluates the saved model."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.utils.modelIO import load_metadata
    root = tmp_path / "data" / "mnist"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez_compressed(root / "train32.npz",
                        imgs=(rng.rand(40, 32, 32, 1) * 255).astype(np.uint8),
                        labels=np.zeros(40, np.int32))
    monkeypatch.setattr(PD, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    args = cli.parse_arguments(
        ["run", "--no-cuda", "-d", "mnist", "-l", loss, "-b", "8", "-e", "1",
         "--checkpoint-every", "1", "--no-viz-gif", "--no-progress-bar",
         "-s", "3", "--eval-batchsize", "16", "--resident-data", "always"])
    trainer, evaluator = cli.main(args)
    run = tmp_path / "results" / "run"
    epochs = 2 if loss == "factor" else 1  # FactorVAE doubles both
    for f in ["model.pt", "specs.json", "train_state.pt",
              "train_losses.log", "test_losses.log"] + [
                  "model-{}.pt".format(e) for e in range(epochs)]:
        assert (run / f).exists(), f
    specs = load_metadata(str(run))
    assert specs["dataset"] == "mnist" and specs["img_size"] == [1, 32, 32]
    assert specs["batch_size"] == 8 * (2 if loss == "factor" else 1)
    assert trainer.state.step == epochs * -(-40 // specs["batch_size"])
    losses = load_metadata(str(run), filename="test_losses.log")
    assert all(np.isfinite(v) for v in losses.values())
    log = (run / "train_losses.log").read_text()
    assert log.startswith("Epoch,Loss,Value\n0,")
    if loss == "factor":
        assert "discrim_loss" in log and "tc_loss" in log
