"""K4 (ops/convt_bwd.py `thin_conv_dw`), the weight gradient of the
encoder's first conv on the card, where this machine can hold it: its
plain version against float64, which layers `ops/precision.py` sends to
it, and the layer's backward through it. The kernel itself runs only on
the card (tests/test_torch_gpu.py). torch only, no jax.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import numpy as np
import pytest
import torch

from disvae_tpu_torch.ops import convt_bwd as C
from disvae_tpu_torch.ops import precision as P

# (n, cin, h): conv1's x (N, Cin, H, H) at the b64 celeba, chairs and
# mnist/fashion settings, and a ragged batch
CONV1_SHAPES = [(64, 3, 64), (64, 1, 64), (64, 1, 32), (39, 3, 64)]


def _rel(ref, got):
    return ((got.double() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def _operands(n, cin, h, seed=0):
    """conv1's x and cotangent dy (N, 32, H/2, H/2), float32 holding bf16
    values, as the ``default`` backward gets them."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(n, cin, h, h), 0).astype(np.float32)
    dy = (1e-2 * rng.randn(n, 32, h // 2, h // 2)).astype(np.float32)
    return (P.round_bf16(torch.from_numpy(x)),
            P.round_bf16(torch.from_numpy(dy)))


@pytest.mark.parametrize("n, cin, h", CONV1_SHAPES)
def test_thin_conv_dw_plain_matches_float64(n, cin, h):
    """K4's plain version (K1's with the operands swapped) is the conv's
    weight gradient: against aten's convolution backward in float64 on
    the same bf16 values, max |d| / max |ref| <= 2e-6 (float32 sums of
    N H W / 4 exact products)."""
    x, dy = _operands(n, cin, h)
    w = torch.zeros((32, cin, 4, 4), dtype=torch.float64)
    _, ref, _ = torch.ops.aten.convolution_backward(
        dy.double(), x.double(), w, None, [2, 2], [1, 1], [1, 1], False,
        [0, 0], 1, [False, True, False])
    got = C.thin_conv_dw_plain(x, dy, torch.bfloat16)
    assert got.shape == (32, cin, 4, 4) and got.dtype == torch.float32
    assert _rel(ref, got) <= 2e-6


# (policy, autocast, kind, x shape, weight shape, device, weight wanted,
# K4 takes it)
ROUTES = {
    "conv1 celeba": ("default", False, "conv", (64, 3, 64, 64),
                     (32, 3, 4, 4), "cuda", True, True),
    "conv1 chairs": ("default", False, "conv", (64, 1, 64, 64),
                     (32, 1, 4, 4), "cuda", True, True),
    "conv1 mnist": ("default", False, "conv", (64, 1, 32, 32),
                    (32, 1, 4, 4), "cuda", True, True),
    "conv1 ragged tail": ("default", False, "conv", (39, 3, 64, 64),
                          (32, 3, 4, 4), "cuda", True, True),
    "conv1 b256": ("default", False, "conv", (256, 3, 64, 64),
                   (32, 3, 4, 4), "cuda", True, True),
    "conv2, 32 channels": ("default", False, "conv", (64, 32, 32, 32),
                           (32, 32, 4, 4), "cuda", True, False),
    "thin transposed conv": ("default", False, "convT", (64, 32, 32, 32),
                             (32, 3, 4, 4), "cuda", True, False),
    "no weight gradient": ("default", False, "conv", (64, 3, 64, 64),
                           (32, 3, 4, 4), "cuda", False, False),
    "CPU tensors": ("default", False, "conv", (64, 3, 64, 64),
                    (32, 3, 4, 4), "cpu", True, False),
    "3x3 kernel": ("default", False, "conv", (64, 3, 64, 64),
                   (32, 3, 3, 3), "cuda", True, False),
    "nine channels": ("default", False, "conv", (64, 9, 64, 64),
                      (32, 9, 4, 4), "cuda", True, False),
    "highest": ("highest", False, "conv", (64, 3, 64, 64), (32, 3, 4, 4),
                "cuda", True, False),
    "high": ("high", False, "conv", (64, 3, 64, 64), (32, 3, 4, 4),
             "cuda", True, False),
    "bf16 autocast": ("default", True, "conv", (64, 3, 64, 64),
                      (32, 3, 4, 4), "cuda", True, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_which_layers_take_k4(case):
    """conv1 under ``default`` on the card asks K4, at every batch size;
    everything else keeps cuDNN: the 32-channel convs, a conv with more
    than THIN_CHANNELS inputs or another kernel, the thin transposed conv
    (K1's, through the hook), a conv whose weight gradient is not wanted,
    CPU tensors, and ``highest``, ``high`` and bf16 autocast, which never
    reach the rounding layer (`_rounds`). Whether K4's geometry holds a
    shape is the library's to say (`thin_conv_dw_fits`, on the card)."""
    policy, autocast, kind, xs, ws, device, wanted, takes = ROUTES[case]
    P.configure(policy)
    try:
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            rounds = P._rounds(torch.zeros(1))
    finally:
        P.configure("highest")
    assert (rounds and P.takes_thin_conv_dw(kind, xs, ws, 2, 1, device,
                                            wanted)) == takes


@pytest.mark.parametrize("x_grad", [False, True], ids=["conv1", "with dx"])
def test_default_conv_backward_through_k4(monkeypatch, x_grad):
    """The ``default`` conv's backward with the K4 route taken and the
    shape inside its geometry (on the CPU here, K4 stood in for by its
    plain version): K4 gets the forward's
    bf16 copy of x and the bf16 cotangent, contiguous, once per backward;
    dw is cuDNN's float32 weight gradient within 1e-6 of scale, dx (when
    x wants one) and db are the unrouted layer's bit for bit."""
    calls = []

    def k4(x, dy):
        assert x.dtype == dy.dtype == torch.bfloat16
        assert x.is_contiguous() and dy.is_contiguous()
        calls.append((tuple(x.shape), tuple(dy.shape)))
        return C.thin_conv_dw_plain(x, dy)

    x, _ = _operands(8, 3, 32, seed=1)
    rng = np.random.RandomState(2)
    w = torch.from_numpy((0.1 * rng.randn(32, 3, 4, 4)).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    g = torch.from_numpy(rng.randn(8, 32, 16, 16).astype(np.float32))

    def grads():
        xs, ws, bs = (t.clone().requires_grad_(r)
                      for t, r in ((x, x_grad), (w, True), (b, True)))
        P.conv2d(xs, ws, bs).backward(g)
        return xs.grad, ws.grad, bs.grad

    P.configure("default")
    try:
        dx0, dw0, db0 = grads()
        monkeypatch.setattr(C, "thin_conv_dw", k4)
        monkeypatch.setattr(C, "thin_conv_dw_fits", lambda x, w: True)
        route = P.takes_thin_conv_dw
        monkeypatch.setattr(P, "takes_thin_conv_dw",
                            lambda *a: route(*a[:5], "cuda", *a[6:]))
        dx1, dw1, db1 = grads()
    finally:
        P.configure("highest")
    assert calls == [((8, 3, 32, 32), (8, 32, 16, 16))]
    assert _rel(dw0.double(), dw1) <= 1e-6
    assert torch.equal(db0, db1)
    if x_grad:
        assert torch.equal(dx0, dx1)
    else:
        assert dx0 is None and dx1 is None


def test_default_conv_backward_outside_k4_geometry_keeps_cudnn(
        monkeypatch):
    """A conv the route asks K4 for but whose shape K4's geometry does
    not hold (`thin_conv_dw_fits` false) takes cuDNN's gradients from the
    forward's bf16 copy of x: dx, dw and db bit for bit the unrouted
    layer's, and K4 is not called."""
    x, _ = _operands(4, 3, 16, seed=3)
    rng = np.random.RandomState(4)
    w = torch.from_numpy((0.1 * rng.randn(32, 3, 4, 4)).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 32, 8, 8).astype(np.float32))

    def grads():
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        P.conv2d(xs, ws, bs).backward(g)
        return xs.grad, ws.grad, bs.grad

    def k4(x, dy):
        raise AssertionError("K4 called outside its geometry")

    P.configure("default")
    try:
        before = grads()
        monkeypatch.setattr(C, "thin_conv_dw", k4)
        monkeypatch.setattr(C, "thin_conv_dw_fits", lambda x, w: False)
        route = P.takes_thin_conv_dw
        monkeypatch.setattr(P, "takes_thin_conv_dw",
                            lambda *a: route(*a[:5], "cuda", *a[6:]))
        after = grads()
    finally:
        P.configure("highest")
    for a, b in zip(before, after):
        assert torch.equal(a, b)
