"""K5 (ops/group_norm_silu.py), GroupNorm -> SiLU -> bf16 rounding with
its backward, where this machine can hold it: the plain version against
PyTorch's group norm and SiLU, which calls `ops/precision.py` sends to
it, the conv that takes its output as an already rounded operand, and
AutoencoderKL with the route taken (K5 stood in for by its plain
version). The kernel itself runs only on the card (tests/test_torch_gpu.py).
torch only, no jax.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import importlib.util
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops import group_norm_silu as K
from disvae_tpu_torch.ops import precision as P
from disvae_tpu_torch.ops.losses import get_loss_f
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
from disvae_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (n, c, h, w, groups): 4, 8 and 16 channels a group as kl-f8's 128-,
# 256- and 512-wide maps have them at 32 groups, and a ragged H W
SHAPES = [(2, 16, 8, 8, 4), (2, 64, 6, 6, 8), (3, 32, 4, 4, 2),
          (2, 12, 5, 7, 3)]


@pytest.fixture(autouse=True)
def _restore():
    yield
    P.configure("highest")
    trace.reset()


def _rel(ref, got):
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-30)).item()


def _inputs(n, c, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = (3 * rng.randn(n, c, h, w) + 1).astype(np.float32)
    weight = (1 + 0.5 * rng.randn(c)).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(n, c, h, w).astype(np.float32)
    return tuple(torch.from_numpy(t) for t in (x, weight, bias, dy))


@pytest.mark.parametrize("n, c, h, w, groups", SHAPES)
def test_plain_forward_is_pytorchs_rounded(n, c, h, w, groups):
    """The plain forward is round_bf16(silu(group_norm(x))) bit for bit,
    its values bf16's, and it keeps group_norm's mean and rstd (N, G)."""
    x, weight, bias, _ = _inputs(n, c, h, w)
    y, mean, rstd = K.group_norm_silu_fwd_plain(x, weight, bias, groups)
    ref = P.round_bf16(F.silu(F.group_norm(x, groups, weight, bias,
                                           K.EPS)))
    assert torch.equal(y, ref) and torch.equal(y, P.round_bf16(y))
    xg = x.double().view(n, groups, -1)
    assert _rel(xg.mean(-1), mean) <= 1e-6
    assert _rel((xg.var(-1, unbiased=False) + K.EPS).rsqrt(), rstd) <= 1e-5
    assert torch.equal(K.group_norm_silu_plain(x, weight, bias, groups), y)


@pytest.mark.parametrize("n, c, h, w, groups", SHAPES)
def test_plain_backward_matches_float64_autograd(n, c, h, w, groups):
    """The cotangent passes straight through the rounding: dx, dweight
    and dbias are autograd's of silu(group_norm(x)) in float64 within
    1e-6 of scale (float32 sums over a group)."""
    x, weight, bias, dy = _inputs(n, c, h, w, seed=1)
    ref = [t.double().requires_grad_() for t in (x, weight, bias)]
    F.silu(F.group_norm(ref[0], groups, ref[1], ref[2], K.EPS)).backward(
        dy.double())
    got = [t.clone().requires_grad_() for t in (x, weight, bias)]
    K.group_norm_silu_plain(*got, groups).backward(dy)
    for r, g in zip(ref, got):
        assert g.grad.dtype == torch.float32
        assert _rel(r.grad, g.grad) <= 1e-6


def test_on_the_cpu_the_entry_is_the_plain_version():
    """`group_norm_silu` on CPU tensors takes the plain version, forward
    and backward, and launches nothing; a kernel half refuses CPU
    tensors."""
    x, weight, bias, dy = _inputs(2, 16, 8, 8)
    before = K.group_norm_silu_fwd.launches, K.group_norm_silu_bwd.launches
    a = [t.clone().requires_grad_() for t in (x, weight, bias)]
    b = [t.clone().requires_grad_() for t in (x, weight, bias)]
    ya, yb = K.group_norm_silu(*a, 4), K.group_norm_silu_plain(*b, 4)
    ya.backward(dy)
    yb.backward(dy)
    assert torch.equal(ya, yb)
    assert all(torch.equal(s.grad, t.grad) for s, t in zip(a, b))
    assert (K.group_norm_silu_fwd.launches,
            K.group_norm_silu_bwd.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        K.group_norm_silu_fwd(x, weight, bias, 4)
    with pytest.raises(ValueError, match="groups"):
        K.group_norm_silu(x, weight, bias, 5)


@pytest.mark.parametrize("cpg", [4, 8, 16])
def test_plain_version_keeps_a_channels_last_layout(cpg):
    """K5's layouts on the CPU (kl-f8's 4, 8 and 16 channels a group at 32
    groups; 8 groups here): a channels-last x runs in the NHWC layout
    (counted as `norm.k5_nhwc`, no copy) and gets a channels-last y and
    dx, whose values, and dweight and dbias, are the NCHW call's bit for
    bit; an x that is neither takes one copy to NCHW (`norm.k5_copy`,
    once for the forward and the backward), and a dy that does not lie as
    the forward's x one more."""
    groups = 8
    x, weight, bias, dy = _inputs(2, groups * cpg, 6, 5, seed=cpg)
    assert K.layout(x, groups) == "nchw"
    last = x.contiguous(memory_format=torch.channels_last)
    assert K.layout(last, groups) == "nhwc"
    out = []
    for t, g in ((x, dy), (last, dy.contiguous(
            memory_format=torch.channels_last))):
        trace.reset()
        leaves = [t.clone(memory_format=torch.preserve_format)
                  .requires_grad_(), weight.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        y = K.group_norm_silu(*leaves, groups)
        # the backward's own dx, not a leaf's .grad (which takes the leaf's
        # strides)
        out.append((y, *torch.autograd.grad(y, leaves, g), trace.counts()))
    (y0, dx0, dw0, db0, c0), (y1, dx1, dw1, db1, c1) = out
    assert c0 == {} and c1 == {"norm.k5_nhwc": 1}
    for a in (y1, dx1):
        assert a.is_contiguous(memory_format=torch.channels_last)
        assert not a.is_contiguous()
    for a, b in ((y0, y1), (dx0, dx1), (dw0, dw1), (db0, db1)):
        assert torch.equal(a, b)
    # neither layout: a copy (the forward keeps it for the backward)
    trace.reset()
    odd = x.transpose(2, 3).contiguous().transpose(2, 3).requires_grad_()
    assert K.layout(odd, groups) is None
    y2 = K.group_norm_silu(odd, weight, bias, groups)
    (dx2,) = torch.autograd.grad(y2, odd, dy)
    assert trace.counts() == {"norm.k5_copy": 1}
    assert K.layout(y2, groups) == K.layout(dx2, groups) == "nchw"
    assert torch.equal(y2, y0) and torch.equal(dx2, dx0)
    # a channels-last forward given an NCHW cotangent copies it
    trace.reset()
    K.group_norm_silu(last.clone().requires_grad_(), weight, bias,
                      groups).backward(dy)
    assert trace.counts() == {"norm.k5_nhwc": 1, "norm.k5_copy": 1}


# (policy, autocast, dtype, device type, K5 takes it)
ROUTES = {
    "default on the card": ("default", False, torch.float32, "cuda", True),
    "CPU tensors": ("default", False, torch.float32, "cpu", False),
    "highest": ("highest", False, torch.float32, "cuda", False),
    "high": ("high", False, torch.float32, "cuda", False),
    "bf16 activations": ("default", False, torch.bfloat16, "cuda", False),
    "bf16 autocast on the CPU": ("default", True, torch.float32, "cpu",
                                 False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_which_calls_take_k5(case):
    """Only the ``default`` numerics on the card (float32, outside
    autocast) take K5; the CPU, ``highest``, ``high`` and the bf16 compute
    dtype (bf16 activations, autocast) keep PyTorch's group norm and
    SiLU."""
    policy, autocast, dtype, device, takes = ROUTES[case]
    P.configure(policy)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        assert P.takes_group_norm_silu(dtype, device) == takes


@pytest.mark.parametrize("x_grad", [False, True], ids=["dw", "with dx"])
def test_prerounded_conv_is_todays_conv(x_grad):
    """A ``default`` conv given an operand that already holds bf16 values
    with `rounded=True` gives today's output, dx, dw and db bit for bit,
    and keeps the operand itself for its backward (no rounded copy)."""
    rng = np.random.RandomState(3)
    x = P.round_bf16(torch.from_numpy(rng.randn(2, 8, 9, 9).astype(
        np.float32)))
    w = torch.from_numpy((0.1 * rng.randn(16, 8, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.randn(16).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 16, 9, 9).astype(np.float32))
    P.configure("default")
    out = []
    for rounded in (False, True):
        xs, ws, bs = (t.clone().requires_grad_(r)
                      for t, r in ((x, x_grad), (w, True), (b, True)))
        y = P.conv2d(xs, ws, bs, 1, 1, rounded=rounded)
        # the layer's node under the bias add; what it keeps of x
        kept = y.grad_fn.next_functions[0][0].saved_tensors[0]
        assert (kept.data_ptr() == xs.data_ptr()) == rounded
        y.backward(g)
        out.append((y, xs.grad, ws.grad, bs.grad))
    for a, r in zip(*out):
        assert (a is None and r is None) or torch.equal(a, r)


def _small_model(seed=0):
    return init_specific_model("AutoencoderKL", (3, 32, 32), 4 * 16 * 16,
                               generator=torch.Generator().manual_seed(seed),
                               block_out_channels=(64, 128))


def _step(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (2, 32, 32, 3), generator=g).float() / 255
    eps = torch.randn((2, 4 * 16 * 16), generator=g)
    loss_f = get_loss_f("betaH", rec_dist="laplace", reg_anneal=0,
                        betaH_B=1.5e-6)
    state = create_train_state(model, make_optimizer(model.parameters(),
                                                     8.64e-4),
                               torch.Generator(), loss_cfg=loss_f)
    metrics = make_train_step(loss_f)(state, x, {"eps": eps})
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_autoencoder_kl_through_the_route(monkeypatch):
    """AutoencoderKL's step under ``default`` with K5's route taken, K5
    stood in for by PyTorch's own group norm and SiLU, rounded with the
    cotangent passed straight through (on the CPU the encoder's maps are
    channels-last, on which PyTorch's CPU group norm sums in another order
    than any NCHW version): every GroupNorm -> SiLU before a conv goes
    through it (30 at these widths; the two attention norms do not),
    counted once each as `norm.k5`, and the step's loss and every
    gradient are the unrouted step's bit for bit, so the conv takes the
    rounded operand as its own rounding would have made it and the
    cotangent reaches the norm as before."""
    P.configure("default")
    model = _small_model()
    base = {k: v.clone() for k, v in model.state_dict().items()}
    trace.reset()
    m0, g0 = _step(model)
    assert "norm.k5" not in trace.counts()
    route = P.takes_group_norm_silu
    monkeypatch.setattr(P, "takes_group_norm_silu",
                        lambda dtype, device: route(dtype, "cuda"))
    calls = []

    def k5(x, weight, bias, groups, eps):
        calls.append(tuple(x.shape))
        assert eps == 1e-6 and groups == 32
        s = F.silu(F.group_norm(x, groups, weight, bias, eps))
        return s + (P.round_bf16(s) - s).detach()
    monkeypatch.setattr("disvae_tpu_torch.models.autoencoder_kl."
                        "group_norm_silu", k5)
    model.load_state_dict(base)
    trace.reset()
    m1, g1 = _step(model)
    assert trace.counts()["norm.k5"] == len(calls) == 30
    assert Counter(calls) == {(2, 64, 32, 32): 10, (2, 64, 16, 16): 1,
                              (2, 128, 16, 16): 18, (2, 128, 32, 32): 1}
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g, g1[n]) for n, g in g0.items())
    # the benchmark's K5 roofline counts these sites' bytes from the widths
    assert sorted(c * h * w for _, c, h, w in calls) == sorted(
        _k5_roofline().site_elements((3, 32, 32), block_out_channels=(64,
                                                                      128)))


def _k5_roofline():
    bench = os.path.join(ROOT, "bench_port")
    if bench not in sys.path:
        sys.path.insert(0, bench)  # its readers import devtrace
    spec = importlib.util.spec_from_file_location(
        "bench_metric_k5_roofline",
        os.path.join(bench, "metrics", "k5_roofline.klf8_train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_k5_roofline_counts_kl_f8s_sites():
    """At the published widths on 256^2 images the benchmark's K5 bytes
    come from 50 sites, 174,587,904 float32 inputs an image (8.38 GB at
    b12, five passes 41.9 GB a step); a traced cell without K5's kernels
    reads nothing."""
    R = _k5_roofline()
    sites = R.site_elements((3, 256, 256))
    assert len(sites) == 50 and sum(sites) == 174_587_904

    class Cell:
        summary = {"kernels": {"void at::native::GroupNorm": [0.01, 5]}}
        work = {"batches": {12: 4}}
        config = {"img_size": [3, 256, 256]}
    assert R.read(Cell) is None
    Cell.summary = {"kernels": {
        "void (anonymous namespace)::GroupNormSiLU_fwd_kernel<true>":
            [0.05, 200]}}
    assert abs(R.read(Cell) - 100 * 5 * 4 * 174_587_904 * 48 / 3.35e12
               / 0.05) < 1e-9
