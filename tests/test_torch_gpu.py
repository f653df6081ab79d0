"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and a train step through them. Needs a CUDA device and
nvcc; skips without a device.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: K3, 1e-4 absolute on log densities (the kernel sums in another
order than the plain version, and uses approximate exps), plus two float32
roundings of the result where |log q| is large enough that one ulp exceeds
1e-4; K1/K2, as each test states.
"""

import numpy as np
import pytest
import torch

from disvae_tpu_torch.ops import log_qz as port
from graph_cases import LOSSES as GRAPH_LOSSES
from graph_cases import (binary_wire, differences, graph_against_eager,
                         loss_config)
from log_qz_cases import CARD_EDGE_CASES, log_qz_inputs

ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from disvae_tpu_torch.ops.precision import configure
    configure("highest")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L, M, D, S", [(1, 700, 3, 300),
                                        (3, 5000, 10, 2000),
                                        (32, 257, 10, 513),
                                        (7000, 3, 10, 5)])
def test_log_qz_kernel_matches_plain(cuda, L, M, D, S):
    """Ragged M and S, marginal and batched, and L * D over 65,535 (no
    grid dimension of the launch spans L * D); one launch counted per
    call."""
    values, mu, logvar = (torch.from_numpy(x).to(cuda)
                          for x in log_qz_inputs(4, L, M, D, S))
    before = port.log_qz.launches
    got = port.log_qz(values, mu, logvar)
    torch.cuda.synchronize()
    assert port.log_qz.launches == before + 1
    ref = port.log_qz_plain(values, mu, logvar)
    assert (got - ref).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_EDGE_CASES))
def test_log_qz_kernel_edge_inputs(cuda, name):
    """Tight posteriors, ragged shapes and 50-sigma samples against the
    plain version: max |d| <= 1e-4 plus two float32 roundings of the
    result (one ulp is 1.2e-4 at the far case's |log q| ~ 1,250). The far
    case takes the recompute kernel for every entry, the others for none
    (`log_qz.last_recomputed`, the device's flag count); two calls give the
    same bits."""
    kind, shape, seed = CARD_EDGE_CASES[name]
    values, mu, logvar = (torch.from_numpy(x).to(cuda)
                          for x in log_qz_inputs(seed, *shape, kind=kind))
    got = port.log_qz(values, mu, logvar)
    n_rec = port.log_qz.last_recomputed.item()
    ref = port.log_qz_plain(values, mu, logvar)
    tol = ATOL + 2 * torch.finfo(torch.float32).eps * ref.abs()
    assert ((got - ref).abs() <= tol).all().item()
    assert n_rec == (got.numel() if name == "far" else 0)
    assert torch.equal(got, port.log_qz(values, mu, logvar))
    assert port.log_qz.last_recomputed.item() == n_rec


# (n, h, cin, cout): odd Cout, tiny and ragged spatial sizes, batches that
# leave a ragged last chunk of positions, the 64^2 and 32^2 grey datasets'
# Cout = 1, and the b64 mnist/fashion layer
CONVT_SHAPES = [(6, 4, 8, 5), (3, 2, 2, 2), (37, 16, 32, 3), (5, 32, 32, 1),
                (7, 9, 32, 3), (64, 16, 32, 1)]


def _rel(ref, got):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("n, h, cin, cout", CONVT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convt3_kernels_match_plain(cuda, n, h, cin, cout, dtype):
    """K1 (dW) and K2 (dx) against the plain version on the same operands,
    one launch counted per call. float32: max |d| / max |ref| <= 1e-5.
    bf16 operands: <= 1e-3 on the float32 sums; dx rounded to bf16 on both
    sides may differ by one bf16 step (2^-8 relative)."""
    from disvae_tpu_torch.ops import convt_bwd as C
    rng = np.random.RandomState(n * 100 + h)
    x = torch.from_numpy(rng.randn(n, cin, h, h).astype(np.float32))
    w = torch.from_numpy(rng.randn(cin, cout, 4, 4).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * h).astype(np.float32))
    x, w, dy = (t.to(cuda) for t in (x, w, dy))
    x, dy = x.to(dtype), dy.to(dtype)
    before = (C.convt3_dw.launches, C.convt3_dx.launches)
    dw = C.convt3_dw(x, dy)
    dx = C.convt3_dx(dy, w)
    torch.cuda.synchronize()
    assert (C.convt3_dw.launches, C.convt3_dx.launches) == (before[0] + 1,
                                                            before[1] + 1)
    assert dw.dtype == torch.float32 and dx.dtype == dtype
    # the plain version with float32 outputs on the same (rounded) operands
    ref_dx, ref_dw, _ = C.convt3_bwd_plain(x.float(), w, dy.float(), dtype)
    if dtype == torch.float32:
        assert _rel(ref_dw, dw) <= 1e-5 and _rel(ref_dx, dx) <= 1e-5
    else:
        assert _rel(ref_dw, dw) <= 1e-3
        assert _rel(ref_dx, C.convt3_dx(dy, w, torch.float32)) <= 1e-3
        assert _rel(ref_dx, dx) <= 2 ** -8
    # deterministic: a second launch gives the same bits
    assert torch.equal(dw, C.convt3_dw(x, dy))


# (n, h, cin, cout) of the bf16 K1's row bands (at most 8 rows a band):
# H = 4 (one band, shorter than 8 rows), 16 (two whole bands), 12 and 20
# (a ragged last band); Cin = 8 with Cout = 5 (channels padded to one
# 16-channel m-tile, 20 taps to four 8-tap n-tiles); n = 1 and n = 3
BAND_SHAPES = [(1, 4, 32, 3), (3, 4, 8, 5), (3, 16, 32, 3), (1, 16, 8, 5),
               (3, 12, 32, 1), (1, 20, 8, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("n, h, cin, cout", BAND_SHAPES)
def test_convt3_dw_bands_match_plain(cuda, n, h, cin, cout):
    """The bf16 K1 (row bands staged with cp.async, mma.sync tiles)
    against the plain version's float32 sums of the same bf16 operands:
    max |d| / max |ref| <= 1e-3; a second launch gives the same bits (no
    float atomics); one launch counted per call."""
    from disvae_tpu_torch.ops import convt_bwd as C
    rng = np.random.RandomState(n * 1000 + h * 10 + cout)
    x = torch.from_numpy(rng.randn(n, cin, h, h).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * h).astype(np.float32))
    x, dy = x.to(cuda).bfloat16(), dy.to(cuda).bfloat16()
    before = C.convt3_dw.launches
    dw = C.convt3_dw(x, dy)
    torch.cuda.synchronize()
    assert C.convt3_dw.launches == before + 1
    assert dw.shape == (cin, cout, 4, 4) and dw.dtype == torch.float32
    assert _rel(C.convt3_dw_plain(x, dy, torch.bfloat16), dw) <= 1e-3
    for _ in range(3):
        assert torch.equal(dw, C.convt3_dw(x, dy))


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", [(33, 3), (32, 9)])
def test_convt3_dw_bands_reject_wide_channels(cuda, cin, cout):
    """The bf16 K1's tiles hold Cin <= 32 and Cout <= 8: wider raises
    before any launch."""
    from disvae_tpu_torch.ops import convt_bwd as C
    x = torch.zeros((2, cin, 8, 8), device=cuda, dtype=torch.bfloat16)
    dy = torch.zeros((2, cout, 16, 16), device=cuda, dtype=torch.bfloat16)
    before = C.convt3_dw.launches
    with pytest.raises(ValueError, match="exceeds the launch geometry"):
        C.convt3_dw(x, dy)
    assert C.convt3_dw.launches == before


def _poison_shared_memory(device):
    """Every SM's shared memory set to NaN bits (csrc/convt3_bwd.cu
    `disvae_poison_smem`), on the current stream, before a launch."""
    import ctypes
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops import cuda_build
    lib = cuda_build.library("convt3_bwd", C._declare)
    lib.disvae_poison_smem.argtypes = [ctypes.c_int, ctypes.c_void_p]
    sm_count = torch.cuda.get_device_properties(
        device).multi_processor_count
    cuda_build.check(lib, lib.disvae_poison_smem(
        sm_count, torch.cuda.current_stream().cuda_stream), "poison_smem")


@pytest.mark.gpu
@pytest.mark.parametrize("n, h, cin, cout",
                         BAND_SHAPES + [(256, 32, 32, 3)])
def test_convt3_dx_bands_match_plain(cuda, n, h, cin, cout):
    """The bf16 K2 (row bands of dy staged with cp.async, Q rebuilt in
    shared memory, mma.sync tiles, dx out through a shared tile) against
    the plain version's float32 sums of the same bf16 operands, launched
    right after every SM's shared memory was set to NaN (Q's padded taps
    must be zeroed): dx in bf16 within one bf16 step (2^-8) of max |ref|,
    dx in float32 within 1e-3; three launches give the same bits; one
    launch counted per call."""
    from disvae_tpu_torch.ops import convt_bwd as C
    rng = np.random.RandomState(n * 1000 + h * 10 + cout)
    w = torch.from_numpy(rng.randn(cin, cout, 4, 4).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * h).astype(np.float32))
    w, dy = w.to(cuda), dy.to(cuda).bfloat16()
    ref = C.convt3_dx_plain(dy, w, torch.bfloat16)
    for out_dtype, tol in ((torch.bfloat16, 2 ** -8), (torch.float32, 1e-3)):
        _poison_shared_memory(cuda)
        before = C.convt3_dx.launches
        dx = C.convt3_dx(dy, w, out_dtype)
        torch.cuda.synchronize()
        assert C.convt3_dx.launches == before + 1
        assert dx.shape == (n, cin, h, h) and dx.dtype == out_dtype
        assert _rel(ref, dx) <= tol, out_dtype
        for _ in range(3):
            assert torch.equal(dx, C.convt3_dx(dy, w, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", [(33, 3), (32, 9)])
def test_convt3_dx_bands_reject_wide_channels(cuda, cin, cout):
    """The bf16 K2's tiles hold Cin <= 32 and Cout <= 8: wider raises
    before any launch."""
    from disvae_tpu_torch.ops import convt_bwd as C
    w = torch.zeros((cin, cout, 4, 4), device=cuda)
    dy = torch.zeros((2, cout, 16, 16), device=cuda, dtype=torch.bfloat16)
    before = C.convt3_dx.launches
    for out_dtype in (None, torch.float32):
        with pytest.raises(ValueError, match="exceeds the launch geometry"):
            C.convt3_dx(dy, w, out_dtype)
    assert C.convt3_dx.launches == before


@pytest.mark.gpu
def test_btcvae_train_step_default_policy_with_hook(cuda):
    """A batch-16 celeba-shaped btcvae step under ``default`` (bf16
    autocast) with the K1/K2 hook: both kernels launch once, the loss and
    every gradient are finite."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step

    cfg = PL.get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                        btcvae_A=1, btcvae_B=6.4, btcvae_G=1, n_data=202599)
    model = init_specific_model("Burgess", (3, 64, 64), 10,
                                generator=torch.Generator().manual_seed(0),
                                device=cuda)
    state = create_train_state(
        model, make_optimizer(model.parameters(), 5e-4),
        torch.Generator(device=cuda).manual_seed(1), loss_cfg=cfg)
    batch = torch.from_numpy((np.random.RandomState(2).rand(16, 64, 64, 3)
                              * 255).astype(np.uint8)).to(cuda)
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        before = (C.convt3_dw.launches, C.convt3_dx.launches)
        metrics = make_train_step(cfg)(state, batch)
        torch.cuda.synchronize()
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    assert (C.convt3_dw.launches, C.convt3_dx.launches) == (before[0] + 1,
                                                            before[1] + 1)
    assert torch.isfinite(metrics["loss"]).item()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all().item(), \
            name


@pytest.mark.gpu
@pytest.mark.parametrize("img_size", [(1, 64, 64), (3, 64, 64)])
def test_viz_grids_on_card_match_cpu(cuda, tmp_path, img_size):
    """Traversals, reconstructions and posterior-gif frames rendered on the
    card against the CPU, within 1 in uint8, under ``highest``."""
    import copy
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.utils.visualize import Visualizer
    model = init_specific_model("Burgess", img_size, 10,
                                generator=torch.Generator().manual_seed(0))
    with open(tmp_path / "train_losses.log", "w") as f:
        f.write("Epoch,Loss,Value\n" + "".join(
            "0,kl_loss_{},{}\n".format(d, (3 * d) % 10) for d in range(10)))
    c, h, w = img_size
    data = np.random.RandomState(1).rand(8, h, w, c).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        viz = Visualizer(copy.deepcopy(model).to(dev), "celeba",
                         str(tmp_path), save_images=False,
                         loss_of_interest="kl_loss_", max_traversal=2)
        out[dev] = [viz.traversals(is_reorder_latents=True, n_per_latent=7,
                                   n_latents=6),
                    viz.traversals(data=data[:1], n_per_latent=7),
                    viz.reconstruct(data, size=(2, 4))]
        out[dev] += viz.gif_traversals(data[:3], n_latents=4, n_per_gif=5)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def _fast_error_bound(values, mu, logvar):
    """The bf16 error bound of `log_qz_fast` (its docstring), weighted by
    the mixture: with |e_m| <= (2^-7 + 2^-16) T_m, T_m = sum_k |A_k F_k|,
    |logsumexp(ld + e) - logsumexp(ld)| <= log sum_m w_m exp(|e_m|), w the
    softmax of the exact ld. Float64 over the (L, M, D, S) brick."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("logvar_shift", [0.0, -2.0])
def test_log_qz_fast_on_card_near_kernel(cuda, logvar_shift):
    """The bf16 estimator on the card against itself on the CPU to 1e-5
    (the same bf16-rounded operands, float32 sums in another order), and
    against K3 within its bf16 error bound at every point, plus ATOL for
    K3's own error. Unit-scale posteriors (the largest error about 0.020
    on the CPU, past the JAX docstring's 2e-2) and tight ones (about
    0.20: the bound grows with v^2 / var)."""
    rng = np.random.RandomState(2)
    mu = torch.from_numpy(rng.randn(2, 1000, 3).astype(np.float32))
    logvar = torch.from_numpy((rng.randn(2, 1000, 3) * 0.3
                               + logvar_shift).astype(np.float32))
    values = torch.from_numpy(rng.randn(2, 3, 300).astype(np.float32))
    args = [t.to(cuda) for t in (values, mu, logvar)]
    got = port.log_qz_fast(*args, chunk=256)
    cpu = port.log_qz_fast(values, mu, logvar, chunk=256)
    assert (got.cpu() - cpu).abs().max().item() <= 1e-5
    err = (got - port.log_qz(*args)).abs().cpu().double()
    assert (err <= _fast_error_bound(values, mu, logvar) + ATOL).all()


def _resume_runs(tmp_path, device):
    """btcvae on 64 celeba-shaped images, b32, through the Trainer (resident
    feed, one super-step of two steps an epoch, so every epoch after a
    Trainer's first replays its CUDA graph): 4 epochs straight, and 2
    epochs, a resumed Trainer, 2 more. Returns the two Trainers."""
    from disvae_tpu_torch.data import datasets as PD
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.train.trainer import Trainer
    cfg = PL.get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                        btcvae_A=1, btcvae_B=6.4, btcvae_G=1, n_data=64)
    ds = PD.ArrayDataset((np.random.RandomState(2).rand(64, 64, 64, 3)
                          * 255).astype(np.uint8))

    def trainer(name, **kw):
        model = init_specific_model(
            "Burgess", (3, 64, 64), 10,
            generator=torch.Generator().manual_seed(0), device=device)
        return Trainer(model, cfg, lr=5e-4, seed=1, is_progress_bar=False,
                       save_dir=str(tmp_path / name), steps_per_dispatch=2,
                       **kw)

    def loader():
        return PD.DataLoader(ds, batch_size=32, shuffle=True, seed=0)

    straight = trainer("straight")
    straight(loader(), epochs=4, checkpoint_every=1)
    trainer("resumed")(loader(), epochs=2, checkpoint_every=1)
    resumed = trainer("resumed", resume=True)
    assert resumed._start_epoch == 2
    resumed(loader(), epochs=4, checkpoint_every=1)
    torch.cuda.synchronize()
    return straight, resumed


def _resume_diff(a, b):
    """max |d| over the parameters and Adam's moments of two train states;
    their step counters and Adam's step counts must be equal."""
    assert a.step == b.step == 8
    worst = 0.0
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        worst = max(worst, (x - y).abs().max().item())
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert float(sa[i]["step"]) == float(sb[i]["step"]) == 8
        for k in ("exp_avg", "exp_avg_sq"):
            worst = max(worst, (sa[i][k] - sb[i][k]).abs().max().item())
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_resume_on_card_bitexact(cuda, tmp_path, precision):
    """`--resume` on the card: 4 epochs straight equal 2 epochs + resume +
    2 epochs bit for bit in the parameters, Adam's moments and the step
    counters; under ``highest`` (deterministic cuDNN) and under
    ``default`` (bf16 autocast, cuDNN's own algorithm choice) with the
    K1/K2 hook, as the flagship trains. The super-steps replay as CUDA
    graphs: 3 replays straight, 1 after the resume (which captures
    again)."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops.precision import configure
    configure(precision)
    if precision == "default":
        burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        before = C.convt3_dw.launches
        straight, resumed = _resume_runs(tmp_path, cuda)
        hooked = C.convt3_dw.launches - before
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    # the wrapper launches in eager steps and in captures, not in replays:
    # 16 steps, 10 of them replayed, 3 captures of 2
    assert hooked == (12 if precision == "default" else 0)
    assert (straight._resident_step.replays,
            resumed._resident_step.replays) == (3, 1)
    assert _resume_diff(straight.state, resumed.state) == 0.0
    assert int(resumed.state.device_step) == resumed.state.step == 8


# ----------------------------------------------------------------------
# the resident super-step replayed as one CUDA graph
# ----------------------------------------------------------------------

def _graph_against_eager(cuda, loss):
    """Four super-steps of K = 4 b64 steps at dsprites shapes, eager and
    graphed, from one seed (graph_cases.graph_against_eager)."""
    idx = torch.from_numpy(np.random.RandomState(1).randint(
        0, 1024, (16, 64))).to(cuda)
    return graph_against_eager(loss, binary_wire(1024, cuda), idx, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", GRAPH_LOSSES)
def test_graphed_super_step_is_the_eager_one(cuda, loss):
    """Under ``highest``, four K = 4 super-steps at b64 dsprites shapes:
    the first runs eagerly, the second captures, three replay. Every
    metric, parameter, gradient, Adam state tensor, the generator's state
    and both step counters equal four eager super-steps bit for bit."""
    m_eager, m_graph, s_eager, s_graph, step = _graph_against_eager(
        cuda, loss)
    assert step.captured and step.replays == 3
    assert torch.equal(m_eager, m_graph)
    assert differences(s_eager, s_graph) == []
    assert int(s_graph.device_step) == s_graph.step == 16


@pytest.mark.gpu
def test_graphed_super_step_with_hook_under_default(cuda):
    """btcvae under ``default`` with the K1/K2 hook: the graph captures one
    K1 and one K2 launch per step, and the graphed super-steps equal the
    eager ones bit for bit. The wrappers count 24 launches of each: the
    eager run's 16 steps, the graphed run's eager super-step and its
    capture (the replays call no wrapper)."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops.precision import configure
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        before = (C.convt3_dw.launches, C.convt3_dx.launches)
        m_eager, m_graph, s_eager, s_graph, step = _graph_against_eager(
            cuda, "btcvae")
        launches = (C.convt3_dw.launches - before[0],
                    C.convt3_dx.launches - before[1])
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    assert step.replays == 3 and launches == (24, 24)
    assert torch.equal(m_eager, m_graph)
    assert differences(s_eager, s_graph) == []


@pytest.mark.gpu
def test_graphed_trainer_ragged_epoch(cuda, tmp_path):
    """The Trainer on 9 batches of 64 and a ragged tail of 37, K = 4, 2
    epochs: each epoch has two graph-sized super-steps, a short one of one
    step and the tail, the last two eager on the graph's state. The
    graphed Trainer's log, epoch losses and state equal the eager
    Trainer's bit for bit."""
    from disvae_tpu_torch.data import datasets as PD
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.train.trainer import Trainer
    n = 9 * 64 + 37
    imgs = (np.random.RandomState(3).rand(n, 64, 64, 1) < 0.1).astype(
        np.uint8)
    ds = PD.ArrayDataset(imgs)
    ds.is_binary, ds._scale = True, 1.0
    lr, cfg = loss_config("btcvae", n_data=n)
    runs = {}
    for graph in (False, True):
        model = init_specific_model(
            "Burgess", (1, 64, 64), 10,
            generator=torch.Generator().manual_seed(0), device=cuda)
        save_dir = tmp_path / ("graph" if graph else "eager")
        trainer = Trainer(model, cfg, lr=lr, seed=1, is_progress_bar=False,
                          save_dir=str(save_dir), steps_per_dispatch=4,
                          cuda_graph=graph)
        trainer(PD.DataLoader(ds, batch_size=64, shuffle=True, seed=0),
                epochs=2, checkpoint_every=1)
        torch.cuda.synchronize()
        runs[graph] = (trainer, (save_dir / "train_losses.log").read_text())
    (eager, eager_log), (graphed, graphed_log) = runs[False], runs[True]
    assert graphed._resident_step.replays == 3
    assert eager.state.step == graphed.state.step == 20
    assert graphed_log == eager_log
    assert [e["loss"] for e in graphed.epoch_stats] == \
        [e["loss"] for e in eager.epoch_stats]
    assert differences(eager.state, graphed.state) == []


@pytest.mark.gpu
def test_gif_frame_leaves_train_steps_unchanged(cuda, tmp_path):
    """step, gif frame, step gives the parameters of step, step, bit for
    bit (``highest``: deterministic cuDNN), and the model stays in train
    mode."""
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
    from disvae_tpu_torch.utils.visualize import GifTraversalsTraining
    cfg = PL.get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                        btcvae_A=1, btcvae_B=6.4, btcvae_G=1, n_data=1000)
    batch = torch.from_numpy((np.random.RandomState(2).rand(32, 64, 64, 3)
                              * 255).astype(np.uint8)).to(cuda)
    states = []
    for _ in range(2):
        model = init_specific_model(
            "Burgess", (3, 64, 64), 10,
            generator=torch.Generator().manual_seed(0), device=cuda)
        states.append(create_train_state(
            model, make_optimizer(model.parameters(), 5e-4),
            torch.Generator(device=cuda).manual_seed(1), loss_cfg=cfg))
    step = make_train_step(cfg)
    gif = GifTraversalsTraining(states[0].model, "celeba", str(tmp_path))
    for i, state in enumerate(states):
        step(state, batch)
        if i == 0:
            gif(state.model)
            assert state.model.training
        step(state, batch)
    torch.cuda.synchronize()
    for (k, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert len(gif.images) == 1 and gif.images[0].shape == (662, 662, 3)


# ----------------------------------------------------------------------
# data parallelism at world size 1 over NCCL
# ----------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda, monkeypatch):
    """A one-rank NCCL group formed from a launcher's environment, as
    `torchrun --nproc_per_node 1` gives it; destroyed afterwards."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from disvae_tpu_torch.parallel import distributed
    from disvae_tpu_torch.parallel.mesh import create_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize(cuda=True, timeout=timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        yield create_mesh()
    finally:
        distributed.shutdown()


@pytest.mark.gpu
def test_collectives_on_card_at_world_size_1(nccl_mesh, cuda):
    """The row gather's forward is a copy and its backward this rank's
    slice; the differentiable sum and the flat gradient all-reduce leave
    one rank's values as they are."""
    from disvae_tpu_torch.parallel.mesh import (all_reduce_sum, gather_rows,
                                                reduce_gradients)
    x = torch.randn(256, 30, device=cuda, requires_grad=True)
    w = torch.randn(256, 30, device=cuda)
    y = gather_rows(x, nccl_mesh)
    assert y.device == x.device and torch.equal(y, x)
    total = all_reduce_sum((y * w).sum(), nccl_mesh)
    assert torch.equal(total, (x * w).sum())
    total.backward()
    assert torch.equal(x.grad, w)
    lin = torch.nn.Linear(30, 4).to(cuda)
    lin(x.detach()).square().sum().backward()
    before = [p.grad.clone() for p in lin.parameters()]
    reduce_gradients(lin.parameters(), nccl_mesh)
    for a, p in zip(before, lin.parameters()):
        assert torch.equal(a, p.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["btcvae", "factor"])
def test_dp_step_on_card_is_the_plain_step(nccl_mesh, cuda, loss):
    """At world size 1 under ``highest`` one DP step from the plain step's
    state, on the same batch and pinned noise, leaves the parameters and
    Adam's moments within 1e-6 of their scale (celeba shapes, b64)."""
    from dp_cases import celeba_batch, celeba_state, pinned_noise, state_diff

    from disvae_tpu_torch.train.steps import make_train_step
    batch = celeba_batch(64, cuda)
    cfg, plain = celeba_state(loss, cuda)
    _, dp = celeba_state(loss, cuda)
    noise = pinned_noise(cfg, 64, cuda)
    want = make_train_step(cfg)(plain, batch, noise)
    got = make_train_step(cfg, nccl_mesh)(dp, batch, noise)
    torch.cuda.synchronize()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6,
                                              abs=1e-6), k
    assert state_diff(plain, dp)[0] <= 1e-6


@pytest.mark.gpu
def test_padded_step_on_card_with_hook(nccl_mesh, cuda):
    """btcvae at b256 under ``default`` with the K1/K2 hook: 255 real rows
    padded to 256 through the DP padded step, against the plain step on
    the 255 rows, the bounds of tests/test_train.py::
    test_padded_step_matches_unpadded (metrics rel 1e-4, abs 1e-4;
    parameters atol 2e-4, where the gradient is at least 1% of its
    tensor's largest). The padded step launches K1 and K2 once each."""
    from dp_cases import celeba_batch, celeba_state, settled_param_diff

    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.parallel.mesh import pad_to_multiple
    from disvae_tpu_torch.train.steps import (make_padded_train_step,
                                              make_train_step)
    batch = celeba_batch(255, cuda)
    cfg, plain = celeba_state("btcvae", cuda)
    _, dp = celeba_state("btcvae", cuda)
    padded, n_valid = pad_to_multiple(batch.cpu().numpy(), 256)
    padded = torch.from_numpy(padded).to(cuda)
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        want = make_train_step(cfg)(plain, batch)
        before = (C.convt3_dw.launches, C.convt3_dx.launches)
        got = make_padded_train_step(cfg, nccl_mesh)(dp, padded, n_valid)
        launched = (C.convt3_dw.launches - before[0],
                    C.convt3_dx.launches - before[1])
        torch.cuda.synchronize()
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    assert n_valid == 255 and padded.shape[0] == 256
    assert launched == (1, 1)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4,
                                              abs=1e-4), k
    assert settled_param_diff(plain, dp) <= 2e-4


# ----------------------------------------------------------------------
# tensor parallelism at model size 1 over NCCL, and the native gather
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_tp_step_on_card_at_model_size_1(nccl_mesh, cuda):
    """`make_tp_train_step` at M = 1 runs every discriminator layer
    column-parallel over the one-rank model group; under ``highest`` one
    FactorVAE step from the plain step's state, on the same batch and
    pinned noise, leaves the parameters and Adam's moments within 1e-6 of
    their scale (celeba shapes, b64), and the checkpoint's discriminator
    is the whole one."""
    from functools import partial

    from dp_cases import celeba_batch, celeba_state, pinned_noise, state_diff

    from disvae_tpu_torch.parallel.mesh import (ColumnParallelLinear,
                                                make_tp_train_step)
    from disvae_tpu_torch.train.steps import (_factor_train_step,
                                              make_train_step)
    batch = celeba_batch(64, cuda)
    cfg, plain = celeba_state("factor", cuda)
    _, tp = celeba_state("factor", cuda)
    noise = pinned_noise(cfg, 64, cuda)
    want = make_train_step(cfg)(plain, batch, noise)
    step = make_tp_train_step(partial(_factor_train_step, cfg), nccl_mesh, tp)
    got = step(tp, batch, noise)
    torch.cuda.synchronize()
    assert all(isinstance(getattr(tp.disc, "lin{}".format(i)),
                          ColumnParallelLinear) for i in range(1, 7))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6,
                                              abs=1e-6), k
    assert state_diff(plain, tp)[0] <= 1e-6
    whole, ref = tp.state_dict()["disc"], plain.state_dict()["disc"]
    assert {k: v.shape for k, v in whole.items()} == \
        {k: v.shape for k, v in ref.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("binary", [False, True], ids=["bytes", "bits"])
def test_native_gather_feeds_the_card(cuda, binary):
    """A batch gathered by the native gather (one call), copied to the
    card and decompressed there, equals numpy's float batch bit for
    bit."""
    from disvae_tpu_torch import native
    from disvae_tpu_torch.data.datasets import ArrayDataset
    from disvae_tpu_torch.train.steps import _decompress_batch
    rng = np.random.RandomState(0)
    c = 1 if binary else 3
    imgs = rng.randint(0, 2 if binary else 256, (300, 64, 64, c)).astype(
        np.uint8)
    ds = ArrayDataset(imgs)
    if binary:
        ds.is_binary, ds._scale = True, 1.0
    idcs = rng.randint(0, 300, 256)
    fn = native.gather_u8 if binary else native.gather_u8_mul
    before = fn.calls
    wire, _ = ds.get_batch_raw(idcs)
    assert fn.calls == before + 1
    got = _decompress_batch(torch.from_numpy(wire).to(cuda), (c, 64, 64))
    want = np.asarray(imgs[idcs], np.float32) * ds._scale
    assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert np.array_equal(ds.get_batch(idcs)[0], want)
