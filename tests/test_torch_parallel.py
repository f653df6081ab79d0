"""The port's data-parallel pieces in one process: host-sliced feeding, the
mask-aware losses and padded steps against the JAX package, and the whole
data-parallel path at world size 1 over gloo, where it must equal the
plain path bit for bit.

Tolerances, each against the JAX value unless stated:
* host slices, pad_to_multiple, local_batch_slice, global_batch_sizes:
  equal;
* the masked MSS weights: the same -inf columns, finite entries rtol 1e-6
  (both compute in float32);
* each loss's n_valid path on the same inputs: rtol 1e-5, atol 1e-6
  (float32 summation order);
* the padded step against the unpadded step, the bounds of
  tests/test_train.py::test_padded_step_matches_unpadded: metrics rel
  1e-4, abs 1e-4, parameters atol 2e-4;
* the padded step against JAX's padded step on the 8-device mesh, on JAX's
  own noise, the bounds of tests/test_torch_train.py: metrics rtol 1e-5
  (atol 1e-6), gradients max |d| / max |g| <= 1e-4, parameters atol
  lr / 10. Adam's first step moves a parameter by lr * g / (|g| + eps),
  eps = 1e-8, so where |g| < 1e-6 float noise in g moves it by up to a
  fraction of lr (1.7e-3 seen for one FactorVAE encoder weight): such a
  parameter is held through its gradient;
* world size 1: bitwise.
"""

import os
import socket
import subprocess
import sys
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from disvae_tpu.data import datasets as JD
from disvae_tpu.models.discriminator import Discriminator as JaxDisc
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL
from disvae_tpu.ops.math import log_importance_weight_matrix_masked as j_iw
from disvae_tpu.parallel import distributed as JDist
from disvae_tpu.parallel.mesh import create_mesh as jax_mesh
from disvae_tpu.parallel.mesh import pad_to_multiple as jax_pad
from disvae_tpu.parallel.mesh import shard_batch as jax_shard
from disvae_tpu.train.state import create_train_state as jax_state
from disvae_tpu.train.steps import make_disc_optimizer as jax_disc_opt
from disvae_tpu.train.steps import make_optimizer as jax_opt
from disvae_tpu.train.steps import make_padded_train_step as jax_padded

import dp_worker as W
from disvae_tpu_torch import cli
from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.ops.math import log_importance_weight_matrix_masked
from disvae_tpu_torch.parallel import distributed
from disvae_tpu_torch.parallel.mesh import (create_mesh, gather_rows,
                                            pad_to_multiple)
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                          make_optimizer,
                                          make_padded_train_step,
                                          make_train_step)
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.torch_compat import (disc_from_jax_params,
                                                 disc_to_jax_params,
                                                 from_jax_params,
                                                 to_jax_params)

LR = W.LR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICES = [(0, 1), (0, 2), (1, 2), (0, 4), (1, 4), (2, 4), (3, 4)]
PADDED_LOSSES = {
    "VAE": dict(loss="VAE"),
    "betaB": dict(loss="betaB", reg_anneal=10),
    "btcvae-mss": dict(loss="btcvae", reg_anneal=10, n_data=1000),
    "btcvae-mws": dict(loss="btcvae", n_data=1000, is_mss=False),
    "factor": dict(loss="factor"),
}


def _cfgs(loss, is_mss=True, **kw):
    """The same loss config in both packages."""
    kwargs = dict(W.KWARGS, **kw)
    j, p = JL.get_loss_f(loss, **kwargs), PL.get_loss_f(loss, **kwargs)
    if not is_mss:
        j = j.__class__(**dict(vars(j), is_mss=False))
        p = p.__class__(**dict(vars(p), is_mss=False))
    return j, p


# ----------------------------------------------------------------------
# host-sliced feeding
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 8, 13])
@pytest.mark.parametrize("multiple", [1, 2, 4, 8])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 3).reshape(n, 3)
    got, got_n = pad_to_multiple(x, multiple)
    want, want_n = jax_pad(x, multiple)
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n == n


@pytest.mark.parametrize("rank, count", SLICES + [(1, 3)])
def test_local_batch_slice_matches_jax(monkeypatch, rank, count):
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    for b in (12, 16, 10):
        try:
            want = JDist.local_batch_slice(b)
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                distributed.local_batch_slice(b, rank, count)
            continue
        assert distributed.local_batch_slice(b, rank, count) == want


def _indexed(n):
    """Images that carry their own dataset index in two pixels."""
    imgs = np.zeros((n, 4, 4, 1), np.uint8)
    imgs[:, 0, 0, 0] = np.arange(n) % 256
    imgs[:, 0, 1, 0] = np.arange(n) // 256
    return imgs


def _indices(batch):
    batch = np.asarray(batch)
    return (batch[:, 0, 0, 0].astype(np.int64)
            + 256 * batch[:, 0, 1, 0].astype(np.int64))


@pytest.mark.parametrize("rank, count", SLICES)
def test_host_slices_match_jax(rank, count):
    """Three epochs over 99 images at b16 (a ragged tail of 3), padded to
    the data axis: the same index lists as the JAX loader, and the shares
    of all ranks make up each padded global batch of the unsliced
    permutation."""
    imgs = _indexed(99)
    kw = dict(batch_size=16, shuffle=True, seed=3, raw=True)

    def port(r):
        return PD.DataLoader(PD.ArrayDataset(imgs), host_slice=(r, count),
                             pad_global_to=count, **kw)
    jax_loader = JD.DataLoader(JD.ArrayDataset(imgs),
                               host_slice=(rank, count),
                               pad_global_to=count, **kw)
    mine = port(rank)
    full = PD.DataLoader(PD.ArrayDataset(imgs), **kw)
    all_ranks = [port(r) for r in range(count)]
    assert mine.global_batch_sizes() == jax_loader.global_batch_sizes() \
        == [16] * 6 + [3]
    for _ in range(3):
        got = [_indices(b) for b, _ in mine]
        want = [_indices(b) for b, _ in jax_loader]
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        shares = [[_indices(b) for b, _ in p] for p in all_ranks]
        for k, (b, _) in enumerate(full):
            union = np.concatenate([s[k] for s in shares])
            true_n = len(b)
            np.testing.assert_array_equal(union[:true_n], _indices(b))
            # pad rows repeat the global batch's last index, at the end
            assert len(union) == -(-true_n // count) * count
            assert (union[true_n:] == _indices(b)[-1]).all()


def test_host_slice_shuffle_needs_a_seed():
    ds = PD.ArrayDataset(_indexed(8))
    with pytest.raises(ValueError, match="requires a seed"):
        PD.DataLoader(ds, shuffle=True, host_slice=(0, 2))
    with pytest.raises(ValueError, match="divisible"):
        PD.DataLoader(ds, host_slice=(0, 2), pad_global_to=3)


# ----------------------------------------------------------------------
# the mask-aware losses
# ----------------------------------------------------------------------

@pytest.mark.parametrize("padded, n_valid", [(72, 71), (72, 70), (8, 2)])
def test_masked_mss_weights_match_jax(padded, n_valid):
    got = log_importance_weight_matrix_masked(padded, n_valid, 1000).numpy()
    want = np.asarray(j_iw(padded, n_valid, 1000))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[:, n_valid:]).all() and np.isfinite(
        got[:, :n_valid]).all()
    np.testing.assert_allclose(got[:, :n_valid], want[:, :n_valid],
                               rtol=1e-6, atol=0)


def _loss_inputs(n=72, d=10, seed=0):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, 32, 32, 1) > 0.5).astype(np.float32)
    recon = (1 / (1 + np.exp(-rng.randn(n, 32, 32, 1)))).astype(np.float32)
    mu, logvar, eps = (rng.randn(n, d).astype(np.float32) for _ in range(3))
    z = mu + np.exp(0.5 * logvar) * eps
    return data, recon, mu, logvar, z


def _jax_factor_noise(rng, half_p, n_valid, d=10):
    """The noise JAX's factor_surrogate draws from `rng` for a padded batch
    (ops/losses.py:410, :362 with the n_valid mask)."""
    r1, r2, rp = jax.random.split(rng, 3)
    valid = jnp.arange(half_p)[:, None] < n_valid // 2
    noise = jnp.where(valid, jax.random.uniform(rp, (half_p, d)), jnp.inf)
    return {"eps1": jax.random.normal(r1, (half_p, d)),
            "eps2": jax.random.normal(r2, (half_p, d)),
            "perm": jnp.argsort(noise, axis=0)}


def _torch(noise):
    out = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    if "perm" in out:
        out["perm"] = out["perm"].long()
    return out


def _models(d=10, seed=0):
    model, params = jax_init("Burgess", (1, 32, 32), d,
                             key=jax.random.PRNGKey(seed))
    port = VAE((1, 32, 32), d)
    port.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.array, params)))
    return model, params, port


@pytest.mark.parametrize("name", ["VAE", "betaH", "betaB", "btcvae-mss",
                                  "btcvae-mws", "factor"])
def test_masked_losses_match_jax(name):
    """Each loss's n_valid path at 71 real rows of 72, on the same inputs
    (the factor surrogate on JAX's own noise), in both packages."""
    loss = name.split("-")[0]
    j_cfg, p_cfg = _cfgs(loss, is_mss=name != "btcvae-mws", reg_anneal=10)
    if loss == "factor":
        model, params, port = _models()
        disc = JaxDisc(latent_dim=10)
        d_params = disc.init(jax.random.PRNGKey(3))
        p_disc = Discriminator(latent_dim=10)
        p_disc.load_state_dict(disc_from_jax_params(
            jax.tree_util.tree_map(np.array, d_params)))
        data = _loss_inputs()[0]
        rng = jax.random.PRNGKey(4)
        _, want = JL.factor_surrogate(j_cfg, model, disc, params, d_params,
                                      jnp.asarray(data), rng, 3,
                                      n_valid=71)
        noise = _torch(_jax_factor_noise(rng, 36, 71))
        _, got = PL.factor_surrogate(p_cfg, port.train(), p_disc,
                                     torch.from_numpy(data), 3,
                                     noise["eps1"], noise["eps2"],
                                     noise["perm"], n_valid=71)
        got = {k: v.detach() for k, v in got.items()}
    else:
        inputs = _loss_inputs()
        data, recon, mu, logvar, z = map(jnp.asarray, inputs)
        _, want = j_cfg(data, recon, (mu, logvar), True, 3,
                        latent_sample=z, n_valid=71)
        data, recon, mu, logvar, z = map(torch.from_numpy, inputs)
        _, got = p_cfg(data, recon, (mu, logvar), True, 3, latent_sample=z,
                       n_valid=71)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ----------------------------------------------------------------------
# the padded step
# ----------------------------------------------------------------------

def _port_state(p_cfg, seed=0):
    model = init_specific_model("Burgess", (1, 32, 32), 10,
                                generator=torch.Generator().manual_seed(seed))
    disc = d_opt = None
    if p_cfg.needs_discriminator:
        disc = Discriminator(latent_dim=10,
                             generator=torch.Generator().manual_seed(2))
        d_opt = make_disc_optimizer(disc.parameters(), p_cfg)
    return create_train_state(model, make_optimizer(model.parameters(), 5e-4),
                              torch.Generator().manual_seed(1), disc=disc,
                              disc_optimizer=d_opt, loss_cfg=p_cfg)


def _params(state):
    out = {"model." + k: v for k, v in state.model.named_parameters()}
    if state.disc is not None:
        out.update({"disc." + k: v for k, v in state.disc.named_parameters()})
    return out


@pytest.mark.parametrize("name", list(PADDED_LOSSES))
def test_padded_step_matches_unpadded(name):
    """71 rows padded to 72 with n_valid = 71 against the unpadded 71-row
    step from the same state and generator (the mirror of
    tests/test_train.py::test_padded_step_matches_unpadded). The padded
    step draws its noise at the 71 real rows, so FactorVAE's permutations
    agree too and it is held like the others."""
    spec = dict(PADDED_LOSSES[name])
    _, p_cfg = _cfgs(spec.pop("loss"), **spec)
    batch = torch.from_numpy(np.random.RandomState(0).rand(
        71, 32, 32, 1).astype(np.float32))
    s0, s1 = _port_state(p_cfg), _port_state(p_cfg)
    m0 = make_train_step(p_cfg)(s0, batch)
    padded, true_n = pad_to_multiple(batch.numpy(), 8)
    assert padded.shape[0] == 72 and true_n == 71
    m1 = make_padded_train_step(p_cfg)(s1, torch.from_numpy(padded), true_n)
    assert set(m0) == set(m1)
    for k in m0:
        assert float(m1[k]) == pytest.approx(float(m0[k]), rel=1e-4,
                                             abs=1e-4), k
    for (k, a), b in zip(_params(s0).items(), _params(s1).values()):
        np.testing.assert_allclose(b.detach(), a.detach(), rtol=0,
                                   atol=2e-4, err_msg=k)
    assert s0.step == s1.step == 1
    # the generators consumed the same draws
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())


def _jax_padded_grads(j_cfg, model, disc, state, batch, n_valid):
    """The gradients JAX's padded step applies (its loss_fn, recomputed)."""
    _, sub = jax.random.split(state.rng)
    if j_cfg.needs_discriminator:
        return jax.grad(lambda p, dp: JL.factor_surrogate(
            j_cfg, model, disc, p, dp, batch, sub, 1, n_valid=n_valid,
            coefs=state.coefs)[0], argnums=(0, 1))(state.params,
                                                   state.disc_params)

    def loss(p):
        recon, dist_, z = model.apply(p, batch, sub, is_train=True)
        return j_cfg(batch, recon, dist_, True, 1, latent_sample=z,
                     n_valid=n_valid, coefs=state.coefs)[0]
    return jax.grad(loss)(state.params), None


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / (
        np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("name", list(PADDED_LOSSES))
def test_padded_step_matches_jax(name):
    """The port's padded step (no mesh) against JAX's make_padded_train_step
    on the 8-device mesh, 71 real rows of 72, on JAX's own noise."""
    spec = dict(PADDED_LOSSES[name])
    j_cfg, p_cfg = _cfgs(spec.pop("loss"), **spec)
    model, params, port = _models()
    disc = d_opt = None
    if j_cfg.needs_discriminator:
        disc, d_opt = JaxDisc(latent_dim=10), jax_disc_opt(j_cfg)
    state = jax_state(model, params, jax_opt(LR), jax.random.PRNGKey(1),
                      disc=disc, disc_optimizer=d_opt,
                      disc_rng=jax.random.PRNGKey(2), loss_cfg=j_cfg)
    batch = np.random.RandomState(0).rand(71, 32, 32, 1).astype(np.float32)
    padded, true_n = jax_pad(batch, 8)
    _, sub = jax.random.split(state.rng)
    if j_cfg.needs_discriminator:
        noise = _jax_factor_noise(sub, 36, true_n)
    else:
        noise = {"eps": jax.random.normal(sub, (72, 10))}
    j_grads, j_dgrads = _jax_padded_grads(j_cfg, model, disc, state,
                                          jnp.asarray(padded), true_n)
    mesh = jax_mesh()
    step = jax_padded(model, j_cfg, jax_opt(LR), disc=disc,
                      disc_optimizer=d_opt, mesh=mesh, donate=False,
                      state=state)
    j_new, j_metrics = step(state, jax_shard(padded, mesh), np.int32(true_n))

    p_disc = p_dopt = None
    if disc is not None:
        p_disc = Discriminator(latent_dim=10)
        p_disc.load_state_dict(disc_from_jax_params(
            jax.tree_util.tree_map(np.array, state.disc_params)))
        p_dopt = make_disc_optimizer(p_disc.parameters(), p_cfg)
    p_state = create_train_state(port, make_optimizer(port.parameters(), LR),
                                 torch.Generator(), disc=p_disc,
                                 disc_optimizer=p_dopt, loss_cfg=p_cfg)
    p_metrics = make_padded_train_step(p_cfg)(
        p_state, torch.from_numpy(padded), true_n, _torch(noise))

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
        p_g, j_g, p_p, j_p = (dict(jax.tree_util.tree_leaves_with_path(t))
                              for t in (p_g, j_g, p_p, j_p))
        assert set(p_g) == set(j_g)
        for path in j_g:
            assert _rel(j_g[path], p_g[path]) <= 1e-4, path
            stable = np.abs(np.asarray(j_g[path])) >= 1e-6
            np.testing.assert_allclose(p_p[path][stable],
                                       np.asarray(j_p[path])[stable],
                                       atol=LR / 10, rtol=0,
                                       err_msg=str(path))


# ----------------------------------------------------------------------
# world size 1 over gloo: the data-parallel path equals the plain one
# ----------------------------------------------------------------------

@pytest.fixture
def group():
    """A one-rank gloo group in this process, destroyed afterwards."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}".format(
        port), rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield create_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_needs_a_group_and_one_model_rank(group):
    """The layout at world size 1; a model axis that does not divide the
    world raises JAX's ValueError (disvae_tpu/parallel/mesh.py:40-42)."""
    assert group.shape == {"data": 1, "model": 1} and group.rank == 0
    assert (group.data_rank, group.data_size, group.model_rank,
            group.model_size) == (0, 1, 0, 1)
    assert group.data_group is None and group.model_group is not None
    with pytest.raises(ValueError,
                       match="1 devices not divisible by model_parallel=2"):
        create_mesh(model_parallel=2)
    x = torch.randn(3, 4, requires_grad=True)
    y = gather_rows(x, group)
    assert torch.equal(y, x)
    (y * torch.arange(4.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(4.0).expand(3, 4))


def test_no_group_no_mesh(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    assert distributed.initialize(cuda=False) is False
    assert distributed.is_writer()
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh()
    # one device does not divide a model axis of 2, as in the JAX CLI
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        create_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        cli.main(cli.parse_arguments(["run", "--no-cuda",
                                      "--model-parallel", "2"]))


@pytest.mark.parametrize("n", [16, 15], ids=["full", "padded"])
@pytest.mark.parametrize("loss", W.LOSSES)
def test_dp_step_at_world_size_1_is_the_plain_step(group, loss, n):
    """One rank: the gather and the all-reduces are copies, so the DP step
    (and the padded DP step) leaves exactly what the plain step does."""
    batch = torch.from_numpy(W.step_batch(n))
    cfg, plain = W.make_state(loss)
    _, dp = W.make_state(loss)
    if n == 16:
        want = make_train_step(cfg)(plain, batch)
        got = make_train_step(cfg, group)(dp, batch)
    else:
        padded, true_n = pad_to_multiple(batch.numpy(), 2)
        want = make_padded_train_step(cfg)(plain, torch.from_numpy(padded),
                                           true_n)
        got = make_padded_train_step(cfg, group)(
            dp, torch.from_numpy(padded), true_n)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    for (k, a), b in zip(_params(plain).items(), _params(dp).values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("resident", ["never", "always"])
@pytest.mark.parametrize("sliced", [True, False], ids=["sliced", "global"])
def test_trainer_at_world_size_1_is_the_plain_trainer(tmp_path, group,
                                                      resident, sliced):
    """Two epochs over 90 images at b32 (a ragged tail of 26), fed from a
    host-sliced loader or a global one, resident or streamed: the mesh
    Trainer's log and parameters equal the plain Trainer's bit for bit."""
    cfg = PL.get_loss_f("btcvae", **dict(W.KWARGS, n_data=90,
                                          reg_anneal=20))
    ds = PD.ArrayDataset(W.step_batch(90))
    runs = {}
    for mesh in (None, group):
        kw = {}
        if mesh is not None and sliced:
            kw = dict(host_slice=(0, 1))
        loader = PD.DataLoader(ds, batch_size=32, shuffle=True, seed=0, **kw)
        save = tmp_path / ("plain" if mesh is None else "mesh")
        model = init_specific_model(
            "Burgess", (1, 32, 32), 10,
            generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, cfg, lr=LR, seed=1, save_dir=str(save),
                     is_progress_bar=False, resident=resident, mesh=mesh,
                     steps_per_dispatch=2)
        tr(loader, epochs=2, checkpoint_every=1)
        runs[mesh is None] = (tr, (save / "train_losses.log").read_text())
        if sliced and mesh is not None and resident == "never":
            assert loader.pad_global_to == 1  # set by the Trainer
    assert runs[True][1] == runs[False][1]
    for (k, a), b in zip(_params(runs[True][0].state).items(),
                         _params(runs[False][0].state).values()):
        assert torch.equal(a, b), k
    stats = runs[False][0].epoch_stats
    # resident: ceil(2 full batches / 2) super-step + the tail
    assert [e["dispatches"] for e in stats] == \
        [2 if resident == "always" else 3] * 2


def test_split_evaluator_at_world_size_1_is_the_evaluator(tmp_path, group):
    os.makedirs(tmp_path / "mesh")
    os.makedirs(tmp_path / "plain")
    got = W.evaluate(group, str(tmp_path / "mesh"))
    want = W.evaluate(None, str(tmp_path / "plain"))
    assert got["metrics"] == want["metrics"]
    assert got["losses"] == want["losses"]
    assert torch.equal(got["H_zCv"], want["H_zCv"])


def test_cli_refuses_what_the_port_cannot_run(group, monkeypatch, tmp_path):
    """--model-parallel must divide the world size (one rank here), and
    --no-mesh is refused on a multi-rank run."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError,
                       match="1 devices not divisible by model_parallel=2"):
        cli.main(cli.parse_arguments(["run", "--no-cuda",
                                      "--model-parallel", "2"]))
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="--no-mesh"):
        cli.main(cli.parse_arguments(["run", "--no-cuda", "--no-mesh"]))


def test_new_modules_import_without_jax():
    """The data-parallel modules, and the CLI that uses them, import with
    jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.path.insert(0, {!r}); "
            "import disvae_tpu_torch.parallel, "
            "disvae_tpu_torch.parallel.distributed, "
            "disvae_tpu_torch.parallel.mesh, disvae_tpu_torch.cli, "
            "disvae_tpu_torch.train.trainer; "
            "assert not any(m == 'disvae_tpu' or m.startswith('disvae_tpu.')"
            " for m in sys.modules)").format(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
