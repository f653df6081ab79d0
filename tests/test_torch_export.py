"""`torch.export` serving artifacts and the synthetic factor lattice.

Export: the loaded encoder/decoder programs against eager on the CPU,
exactly (the same float32 ops in the same order). Lattice: the port's copy
renders the JAX package's sprites bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.data import synthetic as JS
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.utils import modelIO as JIO

from disvae_tpu_torch import serve
from disvae_tpu_torch.data import synthetic as PS
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops import precision
from disvae_tpu_torch.utils.modelIO import save_model


@pytest.mark.parametrize("img_size, latent_dim", [((1, 32, 32), 6),
                                                  ((3, 64, 64), 10)])
def test_export_round_trip_equals_eager(tmp_path, img_size, latent_dim):
    model = init_specific_model("Burgess", img_size, latent_dim,
                                generator=torch.Generator().manual_seed(0))
    save_model(model, str(tmp_path), metadata=dict(
        dataset="mnist", img_size=list(img_size), latent_dim=latent_dim,
        model_type="Burgess"))
    paths = serve.export_artifacts(str(tmp_path), batch_size=4,
                                   device="cpu")
    assert [os.path.basename(p) for p in paths] == ["encoder.pt2",
                                                    "decoder.pt2"]
    assert precision.current() == "highest"
    encode, decode = (serve.load_artifact(p) for p in paths)
    c, h, w = img_size
    x = torch.from_numpy(np.random.RandomState(1).rand(4, h, w, c).astype(
        np.float32))
    sm = serve.ServingModel.from_dir(str(tmp_path), device="cpu")
    with torch.no_grad():
        mu, logvar = encode(x)
        rec = decode(mu)
    r_mu, r_logvar = sm.encode(x.numpy())
    assert np.array_equal(mu.numpy(), r_mu)
    assert np.array_equal(logvar.numpy(), r_logvar)
    assert np.array_equal(rec.numpy(), sm.decode(r_mu))


def test_export_keeps_the_callers_policy_and_reads_npz(tmp_path,
                                                       capsys):
    """A JAX model.npz exports through the CLI entry; the export runs
    under `highest` and puts the caller's policy back."""
    model, params = jax_init("Burgess", (1, 32, 32), 4,
                             key=jax.random.PRNGKey(2))
    run = tmp_path / "res" / "run"
    run.mkdir(parents=True)
    JIO.save_model(model, params, str(run))
    precision.configure("default")
    try:
        serve._main(["run", "--res-dir", str(tmp_path / "res"), "-b", "2",
                     "--no-cuda"])
        assert precision.current() == "default"
    finally:
        precision.configure("highest")
    out = capsys.readouterr().out.split()
    assert out == [str(run / "encoder.pt2"), str(run / "decoder.pt2")]
    decode = serve.load_artifact(out[1])
    with torch.no_grad():
        img = decode(torch.zeros(2, 4))
    assert img.shape == (2, 32, 32, 1) and img.dtype == torch.float32


@pytest.mark.parametrize("lat_sizes, img_size", [((3, 6, 10, 8, 8), 64),
                                                 ((2, 3, 4, 5, 3), 32)])
def test_render_factor_lattice_matches_jax(lat_sizes, img_size):
    got = PS.render_factor_lattice(lat_sizes, img_size)
    assert np.array_equal(got, JS.render_factor_lattice(lat_sizes, img_size))
    ds, ref = PS.lattice_dataset(lat_sizes, img_size), JS.lattice_dataset(
        lat_sizes, img_size)
    assert ds.is_binary and ds.img_size == ref.img_size
    assert list(ds.lat_sizes) == list(ref.lat_sizes)
    assert ds.lat_names == ref.lat_names
    idcs = np.arange(0, len(ds), 7)
    assert np.array_equal(ds.get_batch_raw(idcs)[0],
                          ref.get_batch_raw(idcs)[0])
