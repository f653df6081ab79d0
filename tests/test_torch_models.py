"""The port's Burgess VAE against the JAX package's, from one set of weights.

JAX `init_specific_model` params -> numpy -> the port's `from_jax_params`
-> the port's forward, on the same seeded images.

Tolerance: 1e-5 absolute on mu / logvar / reconstruction. Both sides run
float32 convolutions and matmuls at full precision (the JAX tests pin
`highest`; the port's CPU convs have no TF32), so they differ only by
summation order.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.utils.torch_compat import params_to_torch_state_dict

from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.utils.torch_compat import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _pair(img_size, latent_dim, seed=0):
    model, params = jax_init("Burgess", img_size, latent_dim,
                             key=jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.array, params)  # writable copies
    port = VAE(img_size, latent_dim)
    port.load_state_dict(from_jax_params(params))
    return model, params, port.eval()


@pytest.mark.parametrize("img_size", [(1, 32, 32), (3, 64, 64)])
def test_forward_matches_jax(img_size):
    model, params, port = _pair(img_size, 10)
    c, h, w = img_size
    x = np.random.RandomState(1).rand(5, h, w, c).astype(np.float32)
    recon, (mu, logvar), z = model.apply(params, x, rng=None, is_train=False)
    with torch.no_grad():
        p_recon, (p_mu, p_logvar), p_z = port(torch.from_numpy(x))
    np.testing.assert_allclose(p_mu.numpy(), mu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_logvar.numpy(), logvar, atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_recon.numpy(), recon, atol=ATOL, rtol=0)
    assert p_recon.shape == (5, h, w, c)
    assert torch.equal(p_z, p_mu)  # eval mode: z is the mean


@pytest.mark.parametrize("img_size", [(1, 32, 32), (3, 64, 64)])
def test_converter_round_trips_bit_exactly(img_size):
    _, params, port = _pair(img_size, 6)
    back = to_jax_params(port.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for k in path:
            got = got[k.key]
        assert got.dtype == leaf.dtype and np.array_equal(got, leaf)
    # and the JAX package's own converter builds the same state dict
    ref = params_to_torch_state_dict(params)
    sd = port.state_dict()
    assert set(ref) == set(sd)
    for k in ref:
        assert torch.equal(ref[k], sd[k]), k


def test_init_matches_torch_bounds():
    """Kaiming-uniform relu bounds with torch's fan rules, as
    tests/test_models.py::test_init_matches_torch_bounds checks them for
    the JAX init (transposed convs take fan_in from the OUT channels)."""
    gen = torch.Generator().manual_seed(0)
    model = init_specific_model("Burgess", (1, 32, 32), 10, generator=gen)
    sd = model.state_dict()
    w = sd["encoder.conv2.weight"].numpy()  # (32, 32, 4, 4)
    bound = np.sqrt(6.0 / (32 * 16))
    assert np.abs(w).max() <= bound
    assert abs(w.std() - bound / np.sqrt(3)) < 0.005
    wl = sd["encoder.lin1.weight"].numpy()  # (256, 512)
    assert np.abs(wl).max() <= np.sqrt(6.0 / 512)
    wt = sd["decoder.convT3.weight"].numpy()  # (32, 1, 4, 4)
    bound_t = np.sqrt(6.0 / (1 * 16))
    assert np.abs(wt).max() <= bound_t
    assert np.abs(wt).max() > bound_t * 0.9  # actually fills the range
    bt = sd["decoder.convT3.bias"].numpy()
    assert np.abs(bt).max() <= 1.0 / np.sqrt(16)
    # the same generator seed gives the same weights
    again = init_specific_model("Burgess", (1, 32, 32), 10,
                                generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_reparameterize_train_uses_generator_eval_returns_mean():
    model = init_specific_model("Burgess", (1, 32, 32), 4,
                                generator=torch.Generator().manual_seed(0))
    mean = torch.zeros(3, 4)
    logvar = torch.zeros(3, 4)
    model.train()
    a = model.reparameterize(mean, logvar,
                             torch.Generator().manual_seed(5))
    b = model.reparameterize(mean, logvar,
                             torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, mean)
    model.eval()
    assert torch.equal(model.reparameterize(mean, logvar), mean)


@pytest.mark.parametrize("img_size", [(1, 28, 28), (1, 64, 32)])
def test_unsupported_image_size_raises(img_size):
    with pytest.raises(RuntimeError, match="not supported"):
        VAE(img_size, 10)


def test_port_never_imports_jax():
    """Importing the port (CLI and serving included) leaves jax out of
    sys.modules."""
    code = ("import sys; import disvae_tpu_torch, disvae_tpu_torch.cli, "
            "disvae_tpu_torch.serve; "
            "print(sorted(m for m in sys.modules if m in ('jax', 'disvae_tpu') "
            "or m.startswith(('jax.', 'disvae_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("policy", ["highest", "high", "default"])
def test_precision_policies(policy):
    """Each policy's backend flags; under `default` the forward runs in
    bf16 autocast and still returns float32 (bf16 keeps ~3 significant
    digits, hence the 5e-2 bound against the float32 forward)."""
    from disvae_tpu_torch.ops import precision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.get_float32_matmul_precision())
    _, _, port = _pair((1, 32, 32), 4)
    x = torch.from_numpy(
        np.random.RandomState(2).rand(3, 32, 32, 1).astype(np.float32))
    with torch.no_grad():
        ref, _, _ = port(x)
    try:
        precision.configure(policy)
        assert precision.current() == policy
        tf32 = policy != "highest"
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
        assert torch.backends.cudnn.allow_tf32 == tf32
        assert torch.backends.cudnn.deterministic == (not tf32)
        with torch.no_grad():
            recon, (mu, logvar), _ = port(x)
        assert recon.dtype == mu.dtype == logvar.dtype == torch.float32
        np.testing.assert_allclose(recon.numpy(), ref.numpy(), atol=5e-2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved[:3]
        torch.set_float32_matmul_precision(saved[3])
