"""The port's ServingModel against the JAX package's, on one checkpoint.

Tolerance: 1e-5 absolute, as the forward comparison in
tests/test_torch_models.py (float32 on both sides, summation order only).
The JAX bundle pads each request to a batch bucket; the port runs each
request at its own size, so ragged sizes also show that the padding never
leaked into the JAX outputs the port is held to.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import os

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.serve import ServingModel as JaxServingModel
from disvae_tpu.utils.modelIO import save_model

from disvae_tpu_torch.serve import ServingModel, export_artifacts

ATOL = 1e-5


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("serve"))
    model, params = jax_init("Burgess", (1, 32, 32), 6,
                             key=jax.random.PRNGKey(0))
    save_model(model, params, run_dir)
    assert os.path.exists(os.path.join(run_dir, "model.npz"))
    return JaxServingModel.from_dir(run_dir), ServingModel.from_dir(
        run_dir, device="cpu")


@pytest.mark.parametrize("n", [1, 7, 9])
def test_requests_match_jax(bundles, n):
    ref, port = bundles
    imgs = np.random.RandomState(n).rand(n, 32, 32, 1).astype(np.float32)
    mu, logvar = port.encode(imgs)
    r_mu, r_logvar = ref.encode(imgs)
    assert mu.shape == logvar.shape == (n, 6)
    np.testing.assert_allclose(mu, r_mu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logvar, r_logvar, atol=ATOL, rtol=0)
    rec = port.decode(mu)
    assert rec.shape == (n, 32, 32, 1) and rec.dtype == np.float32
    np.testing.assert_allclose(rec, ref.decode(r_mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.reconstruct(imgs), ref.reconstruct(imgs),
                               atol=ATOL, rtol=0)
    # the fused call equals the two-request path exactly
    assert np.array_equal(port.reconstruct(imgs), rec)


def test_sample_is_seeded(bundles):
    _, port = bundles
    a = port.sample(4, seed=3)
    assert a.shape == (4, 32, 32, 1) and np.isfinite(a).all()
    assert np.array_equal(a, port.sample(4, seed=3))
    assert not np.array_equal(a, port.sample(4, seed=4))


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(bundles,
                                                         monkeypatch,
                                                         tmp_path):
    """Without a device both entry points take CUDA, as the JAX ones take
    the default accelerator; with no GPU visible they raise instead of
    running on the CPU."""
    _, port = bundles
    run_dir = str(tmp_path)
    from disvae_tpu_torch.utils.modelIO import save_model
    save_model(port.model, run_dir, metadata=dict(
        dataset="mnist", img_size=[1, 32, 32], latent_dim=6,
        model_type="Burgess"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        ServingModel.from_dir(run_dir)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        export_artifacts(run_dir, batch_size=2)
    assert not os.path.exists(os.path.join(run_dir, "encoder.pt2"))
    assert ServingModel.from_dir(run_dir, device="cpu").device.type == "cpu"
