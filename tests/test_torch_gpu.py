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
