"""The port's eval-mode losses, eval step and batch decompression against
the JAX package's.

Tolerance: rtol 1e-5 (with atol 1e-6 for terms that cancel to ~0, such as
a per-dimension KL of a near-prior latent). Both sides compute in float32
and differ by summation order: the bernoulli term sums ~10^4 pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL
from disvae_tpu.ops import math as JM
from disvae_tpu.train.steps import _decompress_batch as jax_decompress
from disvae_tpu.train.steps import make_eval_step as jax_make_eval_step

from disvae_tpu_torch.models.vae import VAE
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.ops import math as PM
from disvae_tpu_torch.train.steps import _decompress_batch, make_eval_step
from disvae_tpu_torch.utils.torch_compat import from_jax_params

RTOL, ATOL = 1e-5, 1e-6
KWARGS = dict(rec_dist="bernoulli", reg_anneal=10000, betaH_B=4,
              betaB_initC=0, betaB_finC=25, betaB_G=100, btcvae_A=1,
              btcvae_B=6, btcvae_G=1, n_data=737280, latent_dim=6,
              factor_G=6, lr_disc=5e-5)


def _batch(seed, B=16, D=6, saturated=False):
    rng = np.random.RandomState(seed)
    data = (rng.rand(B, 32, 32, 1) > 0.5).astype(np.float32)
    recon = rng.uniform(0.02, 0.98, (B, 32, 32, 1)).astype(np.float32)
    if saturated:
        # exact 0/1 reconstructions against the opposite pixel: log(0)
        # clamps to -100 in both packages
        recon[:, :4] = 1.0 - data[:, :4]
        recon[:, 4:8] = data[:, 4:8]
    mu = rng.randn(B, D).astype(np.float32)
    logvar = (0.5 * rng.randn(B, D)).astype(np.float32)
    return data, recon, mu, logvar


def _assert_dicts_close(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(port[k]), float(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("loss,rec_dist,saturated", [
    ("VAE", "bernoulli", False),
    ("betaH", "bernoulli", True),
    ("betaB", "laplace", False),
    ("betaB", "bernoulli", True),
    ("btcvae", "gaussian", False),
    ("btcvae", "bernoulli", True),
])
def test_eval_loss_dicts_match_jax(loss, rec_dist, saturated):
    kwargs = dict(KWARGS, rec_dist=rec_dist)
    data, recon, mu, logvar = _batch(0, saturated=saturated)
    j_loss, j_metrics = JL.get_loss_f(loss, **kwargs)(
        jnp.asarray(data), jnp.asarray(recon),
        (jnp.asarray(mu), jnp.asarray(logvar)), False, 0,
        latent_sample=jnp.asarray(mu))
    t = [torch.from_numpy(a) for a in (data, recon, mu, logvar)]
    p_loss, p_metrics = PL.get_loss_f(loss, **kwargs)(
        t[0], t[1], (t[2], t[3]), False, 0, latent_sample=t[2])
    _assert_dicts_close(p_metrics, j_metrics)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL)
    if saturated and rec_dist == "bernoulli":
        # 4 rows of 32 wrong-and-saturated pixels per image at -100 each
        assert float(p_metrics["recon_loss"]) > 4 * 32 * 100


def test_coefs_and_key_order_match_jax():
    for loss in ["VAE", "betaH", "betaB", "btcvae"]:
        j = JL.get_loss_f(loss, **KWARGS)
        p = PL.get_loss_f(loss, **KWARGS)
        np.testing.assert_array_equal(PL.coef_vector(p).numpy(),
                                      np.asarray(JL.coef_vector(j)))
    for name in ["VAE", "betaB", "btcvae", "factor"]:
        assert PL.metric_key_order(name, 6) == JL.metric_key_order(name, 6)


def test_factor_loss_is_not_silently_substituted():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PL.get_loss_f("factor", **KWARGS)


def test_math_helpers_match_jax():
    _, _, mu, logvar = _batch(1)
    x = mu + 0.1
    t = [torch.from_numpy(a) for a in (x, mu, logvar)]
    np.testing.assert_allclose(
        PM.matrix_log_density_gaussian(*t).numpy(),
        np.asarray(JM.matrix_log_density_gaussian(x, mu, logvar)),
        rtol=RTOL, atol=ATOL)
    for B, N in [(16, 737280), (5, 24)]:
        np.testing.assert_array_equal(
            PM.log_importance_weight_matrix(B, N).numpy(),
            np.asarray(JM.log_importance_weight_matrix(B, N)))


@pytest.mark.parametrize("form", ["uint8", "bits"])
def test_decompress_batch_bit_equal_to_jax(form):
    rng = np.random.RandomState(2)
    img_size = (1, 32, 32)
    if form == "uint8":
        batch = rng.randint(0, 256, (5, 32, 32, 1)).astype(np.uint8)
    else:
        imgs = (rng.rand(5, 32 * 32) > 0.5).astype(np.uint8)
        batch = np.packbits(imgs, axis=1)
    ref = np.asarray(jax_decompress(jnp.asarray(batch), img_size))
    got = _decompress_batch(torch.from_numpy(batch), img_size).numpy()
    assert got.dtype == np.float32 and got.shape == (5, 32, 32, 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("loss", ["betaB", "btcvae"])
def test_eval_step_matches_jax(loss):
    """Model + loss under the eval step, from one set of weights, on a
    bitpacked wire batch."""
    kwargs = dict(KWARGS, n_data=100)
    model, params = jax_init("Burgess", (1, 32, 32), 6,
                             key=jax.random.PRNGKey(3))
    port = VAE((1, 32, 32), 6)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    imgs = (np.random.RandomState(4).rand(12, 32 * 32) > 0.5).astype(np.uint8)
    batch = np.packbits(imgs, axis=1)
    j_cfg = JL.get_loss_f(loss, **kwargs)
    ref = jax_make_eval_step(model, j_cfg)(params, None, jnp.asarray(batch),
                                           JL.coef_vector(j_cfg))
    p_cfg = PL.get_loss_f(loss, **kwargs)
    got = make_eval_step(port, p_cfg)(torch.from_numpy(batch),
                                      PL.coef_vector(p_cfg))
    _assert_dicts_close(got, ref)
