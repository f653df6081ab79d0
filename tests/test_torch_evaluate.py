"""The inference slice as a whole: the port's Evaluator and CLI against the
JAX package's, plus checkpoints crossing between the two packages.

Tolerances, each against the JAX value:
* test losses: rtol 1e-5 (float32, summation order only);
* entropies H[z], H[z|v]: atol 1e-4, the log_qz bound (tests/
  test_torch_log_qz.py) averaged over samples;
* MIG / AAM: atol 1e-4, functions of those entropies;
* forwards after a checkpoint round trip: atol 1e-5 (tests/
  test_torch_models.py).
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import json
import os

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.data import datasets as JD
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL
from disvae_tpu.train.evaluate import Evaluator as JaxEvaluator
from disvae_tpu.utils import modelIO as JIO

from disvae_tpu_torch import cli as port_cli
from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.ops import log_qz as port_log_qz
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.train.evaluate import Evaluator
from disvae_tpu_torch.utils import modelIO as PIO
from disvae_tpu_torch.utils.torch_compat import from_jax_params

LAT_SIZES = (3, 4, 2)
LAT_NAMES = ("a", "b", "c")


def _lattice_images(seed=0):
    """Binary 64x64 images on the full (3, 4, 2) factor lattice: each
    factor value owns a seeded random blob, OR-ed together, so the images
    (and a random encoder's codes) depend on the factors."""
    rng = np.random.RandomState(seed)
    blobs = [rng.rand(n, 64, 64) > 0.8 for n in LAT_SIZES]
    imgs = np.zeros(LAT_SIZES + (64, 64), bool)
    for i in range(LAT_SIZES[0]):
        for j in range(LAT_SIZES[1]):
            for k in range(LAT_SIZES[2]):
                imgs[i, j, k] = blobs[0][i] | blobs[1][j] | blobs[2][k]
    return imgs.reshape(-1, 64, 64, 1).astype(np.uint8)


def _weights(img_size=(1, 64, 64), latent_dim=4, seed=0):
    model, params = jax_init("Burgess", img_size, latent_dim,
                             key=jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.array, params)
    # tight posteriors (logvar bias -6; logvars sit at the odd head
    # outputs), so the random code carries information about the factors
    params["encoder"]["mu_logvar_gen"]["b"][1::2] -= 6.0
    port = VAE(img_size, latent_dim)
    port.load_state_dict(from_jax_params(params))
    return model, params, port


@pytest.mark.parametrize("scramble_quirk", [True, False])
def test_evaluator_matches_jax(tmp_path, scramble_quirk):
    imgs = _lattice_images() * 255  # ArrayDataset stores 0..255 intensities
    model, params, port = _weights()
    kwargs = dict(rec_dist="bernoulli", reg_anneal=0, btcvae_A=1,
                  btcvae_B=6, btcvae_G=1, n_data=len(imgs))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    os.makedirs(jdir)
    os.makedirs(pdir)

    j_loader = JD.DataLoader(JD.ArrayDataset(imgs, lat_sizes=LAT_SIZES,
                                             lat_names=LAT_NAMES),
                             batch_size=10)
    jev = JaxEvaluator(model, params, JL.get_loss_f("btcvae", **kwargs),
                       save_dir=str(jdir), is_progress_bar=False,
                       scramble_quirk=scramble_quirk, metrics_seed=7,
                       resident="never")
    j_metrics, j_losses = jev(j_loader, is_metrics=True, is_losses=True)

    p_loader = PD.DataLoader(PD.ArrayDataset(imgs, lat_sizes=LAT_SIZES,
                                             lat_names=LAT_NAMES),
                             batch_size=10)
    pev = Evaluator(port, PL.get_loss_f("btcvae", **kwargs),
                    save_dir=str(pdir),
                    scramble_quirk=scramble_quirk, metrics_seed=7)
    launches = port_log_qz.log_qz.launches
    p_metrics, p_losses = pev(p_loader, is_metrics=True, is_losses=True)
    assert port_log_qz.log_qz.launches == launches  # CPU: plain version

    assert set(p_losses) == set(j_losses)
    for k in j_losses:
        np.testing.assert_allclose(p_losses[k], j_losses[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    ji, pi = jev.last_metrics_internals, pev.last_metrics_internals
    np.testing.assert_allclose(pi["marginal_entropies"],
                               ji["marginal_entropies"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pi["cond_entropies"], ji["cond_entropies"],
                               atol=1e-4, rtol=0)
    # the random code does carry information about the factors
    assert (ji["marginal_entropies"][None] - ji["cond_entropies"]).max() > 0.1
    for k in ("MIG", "AAM"):
        assert p_metrics[k] == pytest.approx(j_metrics[k], abs=1e-4)
    for name in ("metrics.log", "test_losses.log"):
        with open(jdir / name) as f, open(pdir / name) as g:
            assert set(json.load(f)) == set(json.load(g))
    assert os.path.exists(pdir / "metric_helpers.pth")
    assert set(pev.last_metrics_timings) == {"encode_seconds",
                                             "entropy_seconds",
                                             "total_seconds"}


def test_metrics_need_factor_metadata(tmp_path):
    _, _, port = _weights()
    ev = Evaluator(port, PL.get_loss_f("VAE", rec_dist="bernoulli",
                                       reg_anneal=0),
                   save_dir=str(tmp_path))
    loader = PD.DataLoader(PD.ArrayDataset(_lattice_images()[:4]))
    with pytest.raises(ValueError, match="known true factors"):
        ev.compute_metrics(loader)


def _forward(model, params, port, x):
    recon, (mu, _), _ = model.apply(params, x, rng=None, is_train=False)
    with torch.no_grad():
        p_recon, (p_mu, _), _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(p_mu.numpy(), mu, atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_recon.numpy(), recon, atol=1e-5, rtol=0)


def test_checkpoints_cross_between_packages(tmp_path):
    x = np.random.RandomState(1).rand(3, 32, 32, 1).astype(np.float32)
    # JAX model.npz -> port load_model
    model, params = jax_init("Burgess", (1, 32, 32), 6,
                             key=jax.random.PRNGKey(2))
    jdir = tmp_path / "jax"
    os.makedirs(jdir)
    JIO.save_model(model, params, str(jdir))
    port = PIO.load_model(str(jdir))
    assert not port.training
    _forward(model, params, port, x)

    # port model.pt -> JAX load_model (which falls back to model.pt)
    port = init_specific_model("Burgess", (1, 32, 32), 6,
                               generator=torch.Generator().manual_seed(3))
    pdir = tmp_path / "port"
    os.makedirs(pdir)
    PIO.save_model(port, str(pdir), metadata=dict(
        dataset="mnist", img_size=[1, 32, 32], latent_dim=6,
        model_type="Burgess", loss="btcvae"))
    assert not os.path.exists(pdir / "model.npz")
    model, params = JIO.load_model(str(pdir))
    _forward(model, params, port.eval(), x)

    # a checkpoint without metadata merges into specs.json, never erases
    PIO.save_model(port, str(pdir), filename="model-3.pt")
    assert PIO.load_metadata(str(pdir))["loss"] == "btcvae"
    ckpts = PIO.load_checkpoints(str(pdir))
    assert [e for e, _ in ckpts] == [3]
    _forward(model, params, ckpts[0][1], x)


def _tiny_dsprites(root, n=24):
    os.makedirs(root)
    np.save(os.path.join(root, "dsprites_imgs.npy"), _lattice_images()[:n])
    np.save(os.path.join(root, "dsprites_latents.npy"),
            np.zeros((n, 6), np.float32))


def test_cli_eval_only_matches_jax_cli(tmp_path, monkeypatch):
    """`python -m disvae_tpu_torch <name> --is-eval-only` on a tiny dsprites
    cache writes the test_losses.log the JAX CLI writes for the same
    checkpoint (a port model.pt, which the JAX CLI reads too)."""
    from disvae_tpu import cli as jax_cli

    _tiny_dsprites(str(tmp_path / "data" / "dsprites"))
    monkeypatch.setattr(PD, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setattr(JD, "DATA_ROOT", str(tmp_path / "data"))
    port = init_specific_model("Burgess", (1, 64, 64), 10,
                               generator=torch.Generator().manual_seed(0))
    for name in ("port_run", "jax_run"):
        run_dir = tmp_path / "results" / name
        os.makedirs(run_dir)
        PIO.save_model(port, str(run_dir), metadata=dict(
            dataset="dsprites", img_size=[1, 64, 64], latent_dim=10,
            model_type="Burgess"))
    monkeypatch.chdir(tmp_path)
    flags = ["--is-eval-only", "-l", "btcvae", "--eval-batchsize", "8",
             "--no-progress-bar"]
    port_cli.main(port_cli.parse_arguments(["port_run", "--no-cuda"] + flags))
    jax_cli.main(jax_cli.parse_arguments(["jax_run"] + flags))

    got = PIO.load_metadata(str(tmp_path / "results" / "port_run"),
                            filename="test_losses.log")
    ref = JIO.load_metadata(str(tmp_path / "results" / "jax_run"),
                            filename="test_losses.log")
    assert set(got) == set(ref) and "tc_loss" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert not os.path.exists(tmp_path / "results" / "port_run"
                              / "metrics.log")


@pytest.mark.parametrize("flags", [
    ["--model-parallel", "2"],
    ["--is-eval-only", "--fast-metrics", "--model-parallel", "2"],
    ["--is-eval-only", "--model-parallel", "4"]])
def test_cli_refuses_paths_not_ported(tmp_path, monkeypatch, flags):
    """`--model-parallel` > 1 without a process group is refused with JAX's
    ValueError (one device does not divide the model axis), before any
    work in training and in evaluation."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="1 devices not divisible by "
                       "model_parallel={}".format(flags[-1])):
        port_cli.main(port_cli.parse_arguments(["run", "--no-cuda"]
                                               + flags))
    assert not os.path.exists(tmp_path / "results")


@pytest.mark.parametrize("binary,raw,shuffle", [(False, False, True),
                                                (False, True, False),
                                                (True, True, True)])
def test_dataloader_batches_equal_jax(tmp_path, binary, raw, shuffle):
    """The port's copied host feed yields the JAX feed's batches, bit for
    bit: float, uint8 wire and bitpacked wire formats, seeded shuffles."""
    if binary:
        _tiny_dsprites(str(tmp_path / "dsprites"))
        jds = JD.DSprites(root=str(tmp_path / "dsprites"))
        pds = PD.DSprites(root=str(tmp_path / "dsprites"))
    else:
        imgs = (np.random.RandomState(5).rand(23, 32, 32, 3) * 255).astype(
            np.uint8)
        jds, pds = JD.ArrayDataset(imgs), PD.ArrayDataset(imgs)
    kw = dict(batch_size=5, shuffle=shuffle, seed=3, raw=raw)
    j_loader, p_loader = JD.DataLoader(jds, **kw), PD.DataLoader(pds, **kw)
    assert len(p_loader) == len(j_loader) == 5
    for _ in range(2):  # two epochs: the (seed, epoch) permutation advances
        for (jx, jy), (px, py) in zip(j_loader, p_loader, strict=True):
            assert px.dtype == jx.dtype and np.array_equal(px, jx)
            assert np.array_equal(py, jy)


def test_missing_dataset_raises_without_downloading(tmp_path):
    with pytest.raises(FileNotFoundError, match="fabricate"):
        PD.DSprites(root=str(tmp_path / "nothing"))


@pytest.mark.parametrize("argv", [
    ["run"],
    ["run", "-x", "btcvae_dsprites", "--is-eval-only", "--is-metrics"],
    ["run", "-x", "factor_celeba", "--corrected-mig", "--eval-batchsize",
     "64"],
    ["run", "-x", "best_dsprites", "--precision", "default", "-s", "7"],
])
def test_cli_parses_like_jax_cli(argv):
    """Same flags, defaults and -x INI layering as disvae_tpu/cli.py."""
    from disvae_tpu import cli as jax_cli
    assert vars(port_cli.parse_arguments(argv)) == vars(
        jax_cli.parse_arguments(argv))


def test_set_seed_seeds_host_rngs_and_returns_generator():
    from disvae_tpu_torch.utils.helpers import set_seed
    gen = set_seed(11)
    a = np.random.rand()
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 11
    set_seed(11)
    assert np.random.rand() == a
    assert set_seed(None) is None
