"""The port's final-convT backward (ops/convt_bwd.py) against the JAX
package's, on seeded numpy inputs.

* `convt3_bwd_plain` in float32 against JAX `convt3_bwd_pl(...,
  interpret=True, cdt=float32)` on the shapes of tests/test_models.py's
  Pallas check: max |d| / max |ref| <= 1e-5 (both sum float32 products in
  another order).
* The bfloat16 plain version against JAX autodiff in float32: <= 3e-2, the
  bound of test_models.py's bf16-policy check (bf16 keeps 8 mantissa bits).
* `conv_transpose2d_pl` under ``highest``: forward and all three grads
  bitwise equal to F.conv_transpose2d's; under ``default`` the backward
  is `convt3_bwd` (on the CPU its plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disvae_tpu.ops.convs import aligned_phase_s2d as jax_s2d
from disvae_tpu.ops.convs import conv2d_transpose
from disvae_tpu.ops.pallas_convt_bwd import convt3_bwd_pl

from disvae_tpu_torch.ops import convt_bwd as P
from disvae_tpu_torch.ops import precision

SHAPES = [(4, 16, 32, 3), (4, 16, 32, 1), (6, 4, 8, 5), (3, 2, 2, 2)]


def _inputs(seed, n, h, cin, cout):
    """JAX-layout (NHWC x, HWIO w, NHWC dy) and the port's layouts."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = rng.randn(4, 4, cin, cout).astype(np.float32)
    dy = rng.randn(n, 2 * h, 2 * h, cout).astype(np.float32)
    t = dict(x=torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             w=torch.from_numpy(
                 w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()),
             dy=torch.from_numpy(dy.transpose(0, 3, 1, 2).copy()))
    return (x, w, dy), t


def _to_jax_layout(dx, dw, db):
    return (dx.permute(0, 2, 3, 1).numpy(),
            dw.flip(2, 3).permute(2, 3, 0, 1).numpy(), db.numpy())


def _rel_err(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / (
        np.abs(ref).max() + 1e-30)


def test_aligned_phase_s2d_matches_jax():
    dy = np.random.RandomState(0).randn(2, 8, 6, 3).astype(np.float32)
    got = P.aligned_phase_s2d(torch.from_numpy(dy), torch.float32).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_s2d(jnp.asarray(dy),
                                                     jnp.float32)))


@pytest.mark.parametrize("n, h, cin, cout", SHAPES)
def test_plain_f32_matches_jax_pallas(n, h, cin, cout):
    (x, w, dy), t = _inputs(6, n, h, cin, cout)
    ref = convt3_bwd_pl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy),
                        interpret=True, cdt=jnp.float32)
    got = P.convt3_bwd_plain(t["x"], t["w"], t["dy"], torch.float32)
    assert [g.dtype for g in got] == [torch.float32] * 3
    for r, g, name in zip(ref, _to_jax_layout(*got), ("dx", "dw", "db")):
        assert g.shape == r.shape, name
        assert _rel_err(r, g) <= 1e-5, (name, _rel_err(r, g))


@pytest.mark.parametrize("n, h, cin, cout", SHAPES[:3])
def test_plain_bf16_close_to_jax_autodiff(n, h, cin, cout):
    (x, w, dy), t = _inputs(8, n, h, cin, cout)
    b = jnp.zeros((cout,), jnp.float32)
    ref = jax.grad(lambda x, w, b: jnp.sum(conv2d_transpose(x, w, b) * dy),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), b)
    got = P.convt3_bwd_plain(t["x"].bfloat16(), t["w"], t["dy"].bfloat16(),
                             torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    got = _to_jax_layout(got[0].float(), got[1], got[2])
    for r, g, name in zip(ref, got, ("dx", "dw", "db")):
        assert _rel_err(r, g) <= 3e-2, (name, _rel_err(r, g))


def test_wrapper_takes_plain_version_on_cpu():
    _, t = _inputs(1, 2, 4, 8, 3)
    before = (P.convt3_dw.launches, P.convt3_dx.launches)
    got = P.convt3_bwd(t["x"], t["w"], t["dy"])
    ref = P.convt3_bwd_plain(t["x"], t["w"], t["dy"], torch.float32)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (P.convt3_dw.launches, P.convt3_dx.launches) == before
    with pytest.raises(ValueError, match="do not fit"):
        P.convt3_bwd(t["x"], t["w"], t["dy"][:, :, :-2])
    with pytest.raises(TypeError):
        P.convt3_bwd(t["x"], t["w"], t["dy"].double())


def _grads(fn, t, b):
    x = t["x"].clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    b = b.clone().requires_grad_()
    y = fn(x, w, b)
    (y * t["target"]).sum().backward()
    return y.detach(), x.grad, w.grad, b.grad


@pytest.fixture
def policy():
    saved = precision.current()
    yield precision.configure
    precision.configure(saved)


def test_autograd_wrapper_bitwise_under_parity(policy):
    """Under ``highest`` the forward and the grads of x, w and b are those
    of the plain transposed conv, bit for bit (the port's mirror of
    test_models.py::test_convT_pallas_parity_policy_grads_identical)."""
    policy("highest")
    _, t = _inputs(7, 2, 16, 32, 3)
    t["target"] = torch.from_numpy(
        np.random.RandomState(9).randn(2, 3, 32, 32).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(3).randn(3).astype(np.float32))
    ref = _grads(lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2,
                                                    padding=1), t, b)
    got = _grads(P.conv_transpose2d_pl, t, b)
    for r, g, name in zip(ref, got, ("y", "dx", "dw", "db")):
        assert torch.equal(r, g), name


def test_autograd_wrapper_default_policy_runs_convt3_bwd(policy):
    """Under ``default`` (bf16 autocast) the backward is `convt3_bwd` on the
    bf16 operands: dx in bf16, dw and db in float32, each equal to the
    plain version on the same operands."""
    policy("default")
    _, t = _inputs(5, 2, 8, 32, 3)
    target = torch.from_numpy(
        np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(2).randn(3).astype(np.float32))
    x = t["x"].bfloat16().requires_grad_()
    w = t["w"].clone().requires_grad_()
    bb = b.clone().requires_grad_()
    with precision.autocast("cpu"):
        y = P.conv_transpose2d_pl(x, w, bb)
        y_ref = F.conv_transpose2d(x, w, bb, stride=2, padding=1)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_ref)
    dy = target.bfloat16()
    y.backward(dy)
    dx, dw, db = P.convt3_bwd_plain(x.detach(), w.detach(), dy,
                                    torch.bfloat16)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    assert torch.equal(bb.grad, db)
