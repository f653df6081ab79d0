"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and a train step through them. Needs a CUDA device and
nvcc; skips without a device.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: K3, 1e-4 absolute on log densities (the kernel sums in another
order than the plain version, and uses the fast exp); K1/K2, as each test
states.
"""

import numpy as np
import pytest
import torch

from disvae_tpu_torch.ops import log_qz as port

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
                                        (32, 257, 10, 513)])
def test_log_qz_kernel_matches_plain(cuda, L, M, D, S):
    """Ragged M and S, marginal and batched; one launch counted per call."""
    rng = np.random.RandomState(4)
    mu = torch.from_numpy(rng.randn(L, M, D).astype(np.float32)).to(cuda)
    logvar = torch.from_numpy(
        (0.3 * rng.randn(L, M, D)).astype(np.float32)).to(cuda)
    values = torch.from_numpy(rng.randn(L, D, S).astype(np.float32)).to(cuda)
    before = port.log_qz.launches
    got = port.log_qz(values, mu, logvar)
    torch.cuda.synchronize()
    assert port.log_qz.launches == before + 1
    ref = port.log_qz_plain(values, mu, logvar)
    assert (got - ref).abs().max().item() <= ATOL


# (n, h, cin, cout): odd Cout, tiny and ragged spatial sizes, batches that
# leave a ragged last chunk of positions, and the 32^2 datasets' Cout = 1
CONVT_SHAPES = [(6, 4, 8, 5), (3, 2, 2, 2), (37, 16, 32, 3), (5, 32, 32, 1),
                (7, 9, 32, 3)]


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
