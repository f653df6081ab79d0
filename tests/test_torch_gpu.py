"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Needs a CUDA device and nvcc; skips without a device.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance: 1e-4 absolute on log densities (the kernel sums in another
order than the plain version, and uses the fast exp).
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
