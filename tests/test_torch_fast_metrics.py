"""`--fast-metrics` (the bf16 entropy estimator) and the evaluator's
resident feed, on the CPU.

Tolerances:
* `log_qz_fast` against JAX `log_qz_mxu` and against the exact log_qz:
  2e-2 absolute in log density, the bound of the JAX docstring
  (disvae_tpu/ops/pallas_kernels.py:131-133), on the inputs of the JAX
  package's own test of it (tests/test_metrics.py). JAX on the CPU takes
  the product in float32; the port rounds both operands to bf16 on every
  device, so this also holds the bf16 error itself.
* `log_qz_fast` against the exact log_qz on inputs where it exceeds 2e-2:
  within its bf16 error bound (the `log_qz_fast` docstring, weighted by
  the mixture) at every point, plus 1e-5 of float32 rounding.
* Fast against exact Evaluator on a rendered lattice: entropies within
  1e-3 (the per-sample bf16 errors average over 10,000 samples), MIG
  within 1e-3, AAM within 1e-2 (a ratio of mutual informations of order
  1e-2 here, so it moves more than MIG).
* Resident against streamed feed: bit-identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.ops.pallas_kernels import log_qz_mxu

from disvae_tpu_torch import cli as port_cli
from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.data.resident import ResidentData
from disvae_tpu_torch.data.synthetic import lattice_dataset
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops import log_qz as K
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.train.evaluate import Evaluator
from disvae_tpu_torch.utils.modelIO import load_metadata, save_model

LAT_SIZES = (3, 3, 4, 4, 4)


def _inputs(seed=0, M=700, D=3, S=300):
    rng = np.random.RandomState(seed)
    mu = rng.randn(M, D).astype(np.float32)
    lv = (rng.randn(M, D) * 0.3).astype(np.float32)
    v = rng.randn(D, S).astype(np.float32)
    return v, mu, lv


@pytest.mark.parametrize("chunk", [256, 8192])
def test_log_qz_fast_matches_jax_mxu_and_exact(chunk):
    v, mu, lv = _inputs()
    ref = np.asarray(log_qz_mxu(jnp.asarray(v), jnp.asarray(mu),
                                jnp.asarray(lv), chunk=chunk))
    t = [torch.from_numpy(a)[None] for a in (v, mu, lv)]
    got = K.log_qz_fast(*t, chunk=chunk)[0].numpy()
    exact = K.log_qz_plain(*t)[0].numpy()
    assert got.shape == (3, 300) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-2
    assert np.abs(got - exact).max() <= 2e-2
    assert np.abs(got - exact).mean() <= 2e-3  # bf16 errors mostly cancel


def test_log_qz_fast_batches_slices_independently():
    """Each slice of an L-batched call (its own bound G, its own padded
    components) is the unbatched call on that slice."""
    parts = [_inputs(seed, M=500, D=4, S=200) for seed in range(3)]
    v, mu, lv = (torch.from_numpy(np.stack(a)) for a in zip(*parts))
    mu[1] += 3.0  # slices with different bounds
    lv[2] -= 1.0
    got = K.log_qz_fast(v, mu, lv, chunk=128)
    assert got.shape == (3, 4, 200)
    for l in range(3):
        one = K.log_qz_fast(v[l:l + 1], mu[l:l + 1], lv[l:l + 1], chunk=128)
        np.testing.assert_allclose(got[l].numpy(), one[0].numpy(),
                                   atol=1e-6, rtol=0)


def _fast_error_bound(values, mu, logvar):
    """|e_m| <= (2^-7 + 2^-16) T_m, T_m = sum_k |A_k F_k| (the
    `log_qz_fast` docstring), and |logsumexp(ld + e) - logsumexp(ld)| <=
    log sum_m w_m exp(|e_m|), w the softmax of the exact ld. Float64."""
    lv = logvar.double()
    invvar = torch.exp(-lv)
    peak = -0.5 * (lv + np.log(2 * np.pi))
    c0 = peak - 0.5 * mu.double() ** 2 * invvar - peak.amax(dim=(1, 2),
                                                            keepdim=True)
    a2, a1, a0 = (t[..., None] for t in (-0.5 * invvar,
                                         mu.double() * invvar, c0))
    v = values.double()[:, None]                      # (L, 1, D, S)
    w = torch.softmax(a2 * v ** 2 + a1 * v + a0, dim=1)
    T = a2.abs() * v ** 2 + a1.abs() * v.abs() + a0.abs()
    return torch.log((w * torch.exp((2 ** -7 + 2 ** -16) * T)).sum(dim=1))


@pytest.mark.parametrize("logvar_shift, worst", [(0.0, 2e-2), (-2.0, 0.15)])
def test_log_qz_fast_within_bf16_bound(logvar_shift, worst):
    """Unit-scale and tight posteriors, where one bf16 pass exceeds the
    JAX docstring's 2e-2 (`worst` is below the largest error seen)."""
    rng = np.random.RandomState(2)
    mu = torch.from_numpy(rng.randn(2, 1000, 3).astype(np.float32))
    lv = torch.from_numpy((rng.randn(2, 1000, 3) * 0.3
                           + logvar_shift).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 3, 300).astype(np.float32))
    err = (K.log_qz_fast(v, mu, lv, chunk=256)
           - K.log_qz_plain(v, mu, lv)).abs().double()
    assert err.max().item() > worst
    assert (err <= _fast_error_bound(v, mu, lv) + 1e-5).all()


def _model(seed=0, logvar_shift=2.0):
    model = init_specific_model("Burgess", (1, 64, 64), 6,
                                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # tighter posteriors: an informative code
        model.encoder.mu_logvar_gen.bias[1::2] -= logvar_shift
    return model.eval()


def _metrics(tmp_path, model, loader, **kw):
    ev = Evaluator(model, PL.get_loss_f("VAE", rec_dist="bernoulli",
                                        reg_anneal=0),
                   save_dir=str(tmp_path), metrics_seed=7, **kw)
    return ev.compute_metrics(loader), ev


def test_fast_entropies_close_to_exact_on_lattice(tmp_path):
    loader = PD.DataLoader(lattice_dataset(LAT_SIZES), batch_size=100)
    model = _model()
    exact, ev = _metrics(tmp_path, model, loader, scramble_quirk=False)
    fast, fev = _metrics(tmp_path, model, loader, scramble_quirk=False,
                         fast_entropies=True)
    a, b = ev.last_metrics_internals, fev.last_metrics_internals
    assert np.abs(a["marginal_entropies"]
                  - b["marginal_entropies"]).max() <= 1e-3
    assert np.abs(a["cond_entropies"] - b["cond_entropies"]).max() <= 1e-3
    assert exact["MIG"] > 1e-3  # the code carries information
    assert fast["MIG"] == pytest.approx(exact["MIG"], abs=1e-3)
    assert fast["AAM"] == pytest.approx(exact["AAM"], abs=1e-2)


@pytest.mark.parametrize("resident", ["always", "prebuilt", "auto"])
@pytest.mark.parametrize("binary", [True, False])
def test_resident_feed_bitidentical_to_streaming(tmp_path, resident, binary):
    ds = lattice_dataset(LAT_SIZES)
    if not binary:  # uint8 wire format instead of bitpacked rows
        ds = PD.ArrayDataset(ds.imgs * 200, lat_sizes=ds.lat_sizes,
                             lat_names=ds.lat_names)
    loader = PD.DataLoader(ds, batch_size=70)  # a ragged last batch
    model = _model()
    streamed, sev = _metrics(tmp_path, model, loader, resident="never")
    if resident == "prebuilt":
        resident = ResidentData(ds, "cpu")
    got, rev = _metrics(tmp_path, model, loader, resident=resident)
    # "auto" builds no upload of its own: it reads a handed-in one only
    assert (rev._resident is not None) == (resident != "auto")
    assert sev._resident is None
    assert got == streamed
    for k, v in sev.last_metrics_internals.items():
        assert np.array_equal(rev.last_metrics_internals[k], v), k


def test_prebuilt_upload_of_another_wire_format_raises(tmp_path):
    ds = lattice_dataset(LAT_SIZES)
    other = PD.ArrayDataset(ds.imgs * 255, lat_sizes=ds.lat_sizes,
                            lat_names=ds.lat_names)
    with pytest.raises(ValueError, match="wire shape"):
        _metrics(tmp_path, _model(), PD.DataLoader(ds, batch_size=100),
                 resident=ResidentData(other, "cpu"))


def test_cli_fast_metrics_eval(tmp_path, monkeypatch):
    """`--is-eval-only --is-metrics --fast-metrics --resident-data always`
    on a dsprites-format lattice cache writes metrics.log; no log_qz
    launch (and, on the CPU, none could happen)."""
    root = tmp_path / "data" / "dsprites"
    root.mkdir(parents=True)
    imgs = lattice_dataset((3, 6, 2, 2, 2)).imgs
    np.save(root / "dsprites_imgs.npy", imgs)
    np.save(root / "dsprites_latents.npy",
            np.zeros((len(imgs), 6), np.float32))
    monkeypatch.setattr(PD, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setattr(PD.DSprites, "lat_sizes", np.array([3, 6, 2, 2, 2]))
    run = tmp_path / "results" / "run"
    run.mkdir(parents=True)
    save_model(_model(), str(run), metadata=dict(
        dataset="dsprites", img_size=[1, 64, 64], latent_dim=6,
        model_type="Burgess"))
    monkeypatch.chdir(tmp_path)
    before = K.log_qz.launches
    _, evaluator = port_cli.main(port_cli.parse_arguments(
        ["run", "--no-cuda", "--is-eval-only", "--is-metrics",
         "--fast-metrics", "--no-test", "--resident-data", "always",
         "--eval-batchsize", "32", "-s", "1"]))
    assert evaluator.fast_entropies and evaluator._resident is not None
    assert K.log_qz.launches == before
    metrics = load_metadata(str(run), filename="metrics.log")
    assert set(metrics) == {"MIG", "AAM"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert os.path.exists(run / "metric_helpers.pth")
