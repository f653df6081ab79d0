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
  is `convt3_bwd` (on the CPU its plain version): on bf16-rounded float32
  operands with float32 dx, or in bf16 inside autocast.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

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


def _dw_bands(x, dy, rows, n_blocks):
    """dW as the bf16 K1 of csrc/convt3_bwd.cu computes it, in float64:
    bands of `rows` x rows of one image (the last one ragged), walked by
    `n_blocks` blocks with a stride of the grid. A band stages its x rows
    and the dy rows 2a0 - 1 .. 2a1 that lie on the image (the halo rows
    its neighbours stage too), rebuilds Q for rows a0 .. a1 with zeros off
    the image (tap (pi * Cout + co) * 2 + pj at each position), pads
    channels to 16s, taps to pairs of 8-tap tiles and its
    positions to 16-position steps (x zero there, Q repeating the band's
    last position), and adds, for each shift (du, dv), x against Q at
    (a + 1 - du, b + 1 - dv). Each block's partial is in the dW layout;
    the merge adds 32 interleaved groups of partials, then the groups."""
    n, cin, h, w = x.shape
    cout = dy.shape[1]
    mt, nt = (1 if cin <= 16 else 2), (2 if 4 * cout <= 16 else 4)
    per_image = -(-h // rows)
    taps, co = [(0, 0), (0, 1), (1, 0), (1, 1)], torch.arange(cout)
    x, dy = x.double(), dy.double()
    parts = torch.zeros(n_blocks, cin, cout, 4, 4, dtype=torch.float64)
    for blk in range(n_blocks):
        acc = torch.zeros(4, mt * 16, nt * 8, dtype=torch.float64)
        for band in range(blk, n * per_image, n_blocks):
            img, a0 = band // per_image, band % per_image * rows
            a1 = min(a0 + rows, h)
            length = (a1 - a0) * w
            steps = -(-length // 16)
            xs = torch.zeros(mt * 16, steps * 16, dtype=torch.float64)
            xs[:cin, :length] = x[img, :, a0:a1].reshape(cin, length)
            ds = torch.zeros(cout, 2 * rows + 2, 2 * w, dtype=torch.float64)
            r_lo, r_hi = max(2 * a0 - 1, 0), min(2 * a1, 2 * h - 1)
            ds[:, r_lo - 2 * a0 + 1:r_hi - 2 * a0 + 2] = dy[img, :,
                                                            r_lo:r_hi + 1]
            il = torch.arange(a1 - a0 + 1)[:, None]
            j = torch.arange(w + 1)[None, :]
            q = torch.zeros(a1 - a0 + 1, w + 1, nt * 8, dtype=torch.float64)
            for pi, pj in taps:  # tap (pi * Cout + co) * 2 + pj
                r, c = 2 * (a0 + il) - pi, 2 * j - pj
                on = (r >= 0) & (r < 2 * h) & (c >= 0) & (c < 2 * w)
                v = ds[:, (2 * il - pi + 1).clamp(0, 2 * rows + 1),
                       c.clamp(0, 2 * w - 1)] * on
                q[..., (pi * cout + co) * 2 + pj] = v.permute(1, 2, 0)
            k = torch.arange(steps * 16).clamp(max=length - 1)
            ka, kb = k // w, k % w
            for s in range(4):
                du, dv = divmod(s, 2)
                acc[s] += xs @ q[ka + 1 - du, kb + 1 - dv]
        for s in range(4):
            du, dv = divmod(s, 2)
            for pi, pj in taps:
                parts[blk, :, :, 3 - 2 * du - pi, 3 - 2 * dv - pj] = acc[
                    s, :cin, (pi * cout + co) * 2 + pj]
    groups = [parts[g::32].sum(0) for g in range(32)]
    return sum(groups[1:], groups[0])


# (n, h, cin, cout, rows, n_blocks): a band shorter than its 8 rows; whole
# bands walked by fewer blocks; ragged last bands of 1 and 4 rows; Cin = 8
# and Cout = 5 (channel and tap padding); W = 9 (a ragged 16-position step)
BAND_CASES = [(1, 4, 32, 3, 8, 1), (3, 16, 32, 3, 8, 4), (3, 4, 8, 5, 3, 2),
              (1, 16, 8, 5, 3, 5), (3, 12, 32, 1, 8, 3), (2, 9, 32, 3, 8, 3)]


@pytest.mark.parametrize("n, h, cin, cout, rows, n_blocks", BAND_CASES)
def test_dw_band_decomposition_matches_plain(n, h, cin, cout, rows,
                                             n_blocks):
    """The bf16 K1's band decomposition (staged rows, halo, padding of
    taps, channels and positions, fixed-order sum of per-block partials),
    re-enacted in torch, equals the plain K1 on the same bf16 operands to
    1e-6 of max |ref| (float32 sums against float64)."""
    rng = np.random.RandomState(n * 100 + h)
    x = torch.from_numpy(rng.randn(n, cin, h, h).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * h).astype(np.float32))
    x, dy = x.bfloat16(), dy.bfloat16()
    ref = P.convt3_dw_plain(x, dy, torch.bfloat16)
    got = _dw_bands(x, dy, rows, n_blocks)
    assert _rel_err(ref.numpy(), got.numpy()) <= 1e-6


def _dx_bands(dy, w, rows, n_blocks):
    """dx as the bf16 K2 of csrc/convt3_bwd.cu computes it, in float64:
    bands of `rows` dx rows of one image (the last one ragged), walked by
    `n_blocks` blocks with a stride of the grid. A block's Q starts as
    stale shared memory (NaN) and its taps 4 Cout .. 16 KT are zeroed
    once; a band stages the dy rows 2a0 - 1 .. 2a1 that lie on the image
    (the halo rows its neighbours stage too; the rest stale NaN), rebuilds
    Q for rows a0 .. a1 with zeros off the image, and multiplies, for each
    shift (du, dv), W2^T[shift] (channels padded to 16s, taps to 16 KT,
    the bf16-rounded weight zero there) by Q at (a + 1 - du, b + 1 - dv)
    for its positions in 16-position steps (positions past the band repeat
    its last one; their sums are discarded)."""
    n, cout, h2, w2 = dy.shape
    h, wd, cin = h2 // 2, w2 // 2, w.shape[0]
    mt, kt = (1 if cin <= 16 else 2), (1 if 4 * cout <= 16 else 2)
    per_image = -(-h // rows)
    taps, co, nan = kt * 16, torch.arange(cout), float("nan")
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    wb = w.bfloat16().double()
    a = torch.zeros(4, mt * 16, taps, dtype=torch.float64)
    for s in range(4):
        du, dv = divmod(s, 2)
        for pi, pj in pairs:
            a[s, :cin, (pi * cout + co) * 2 + pj] = wb[
                :, :, 3 - 2 * du - pi, 3 - 2 * dv - pj]
    dy = dy.double()
    dx = torch.full((n, cin, h, wd), nan, dtype=torch.float64)
    for blk in range(n_blocks):
        q = torch.full((rows + 1, wd + 1, taps), nan, dtype=torch.float64)
        q[..., 4 * cout:] = 0.0
        for band in range(blk, n * per_image, n_blocks):
            img, a0 = band // per_image, band % per_image * rows
            a1 = min(a0 + rows, h)
            ds = torch.full((cout, 2 * rows + 2, 2 * wd), nan,
                            dtype=torch.float64)
            r_lo, r_hi = max(2 * a0 - 1, 0), min(2 * a1, 2 * h - 1)
            ds[:, r_lo - 2 * a0 + 1:r_hi - 2 * a0 + 2] = dy[img, :,
                                                            r_lo:r_hi + 1]
            il = torch.arange(a1 - a0 + 1)[:, None]
            j = torch.arange(wd + 1)[None, :]
            for pi, pj in pairs:
                r, c = 2 * (a0 + il) - pi, 2 * j - pj
                on = (r >= 0) & (r < 2 * h) & (c >= 0) & (c < 2 * wd)
                v = ds[:, (2 * il - pi + 1).clamp(0, 2 * rows + 1),
                       c.clamp(0, 2 * wd - 1)]
                q[:a1 - a0 + 1, :, (pi * cout + co) * 2 + pj] = torch.where(
                    on, v, torch.zeros(())).permute(1, 2, 0)
            length = (a1 - a0) * wd
            k = torch.arange(-(-length // 16) * 16).clamp(max=length - 1)
            ka, kb = k // wd, k % wd
            tile = sum(a[s] @ q[ka + 1 - s // 2, kb + 1 - s % 2].t()
                       for s in range(4))
            dx[img, :, a0:a1] = tile[:cin, :length].reshape(cin, a1 - a0, wd)
    return dx


# BAND_CASES and: Cout = 8 (32 taps, two k-steps, no tap padding), Cin =
# 20 (two m-tiles, 12 padded channels) with Cout = 4 (16 taps, none
# padded), and two-row bands of W = 5 walked by more blocks than bands
DX_BAND_CASES = BAND_CASES + [(2, 8, 32, 8, 8, 3), (1, 6, 20, 4, 4, 2),
                              (2, 5, 16, 2, 2, 7)]


@pytest.mark.parametrize("n, h, cin, cout, rows, n_blocks", DX_BAND_CASES)
def test_dx_band_decomposition_matches_plain(n, h, cin, cout, rows,
                                             n_blocks):
    """The bf16 K2's band decomposition (staged rows with the halo, Q
    rebuilt with zeros off the image and its padded taps zeroed over
    stale NaN, channels and taps padded, positions past the band
    discarded), re-enacted in torch, equals the plain K2 on the same bf16
    operands to 1e-6 of max |ref| (float32 sums against float64): every
    dx element written, none NaN."""
    rng = np.random.RandomState(n * 100 + h + cout)
    w = torch.from_numpy(rng.randn(cin, cout, 4, 4).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * h).astype(
        np.float32)).bfloat16()
    ref = P.convt3_dx_plain(dy, w, torch.bfloat16)
    got = _dx_bands(dy, w, rows, n_blocks)
    assert not got.isnan().any()
    assert _rel_err(ref.numpy(), got.numpy()) <= 1e-6


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
    """Under ``default`` on float32 tensors the forward is the policy's
    transposed conv (bf16-rounded x and w, float32 sums, output and bias)
    and the backward is `convt3_bwd` on the bf16-rounded x and dy: dx, dw
    and db in float32, dx and dw equal to the plain version on the same
    operands, db the sum of the float32 dy."""
    policy("default")
    _, t = _inputs(5, 2, 8, 32, 3)
    target = torch.from_numpy(
        np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(2).randn(3).astype(np.float32))
    x = t["x"].clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    bb = b.clone().requires_grad_()
    y = P.conv_transpose2d_pl(x, w, bb)
    y_ref = precision.conv_transpose2d(x, w, bb)
    assert y.dtype == torch.float32 and torch.equal(y, y_ref)
    y.backward(target)
    dx, dw, _ = P.convt3_bwd_plain(precision.round_bf16(x.detach()),
                                   w.detach(), target, torch.bfloat16)
    assert x.grad.dtype == w.grad.dtype == bb.grad.dtype == torch.float32
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    assert torch.equal(bb.grad, target.sum(dim=(0, 2, 3)))


def test_autograd_wrapper_bf16_compute_dtype_runs_convt3_bwd_in_bf16(
        policy):
    """Under ``default`` inside bf16 autocast (the bf16 compute dtype,
    models/vae.py) the backward is `convt3_bwd` on the bf16 operands: dx
    in bf16, dw and db in float32, each equal to the plain version on the
    same operands."""
    policy("default")
    _, t = _inputs(5, 2, 8, 32, 3)
    target = torch.from_numpy(
        np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(2).randn(3).astype(np.float32))
    x = t["x"].bfloat16().requires_grad_()
    w = t["w"].clone().requires_grad_()
    bb = b.clone().requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16):
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
