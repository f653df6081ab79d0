"""The klf8 cell at a size the CPU runs in seconds: its reference against
the program, its frozen FLOP count against torch's counter, and whole
runs (`harness.run_cell`) in which a sound run is correct and each
planted fault (`calibrate_klf8.FAULTS`) is not: the mid-block attention
left out, GroupNorm's eps at 1e-2 in place of 1e-6, a thin layer's
weight gradient (the float32 route) doubled, the loss over half of each
batch, and no parameter changed by a step. (GroupNorm's eps at 1e-5 is
not asked to fail: its effect is inside the sound runs' spread on the
card, PERF.md section 2.) On the card, at the cell's own size, the
control, a doubled thin wgrad and the attention left out are not correct
and a sound run is (`-m gpu`).

    python -m pytest bench_port/tests/test_bench_port_klf8.py -q
"""

import json
import os

import pytest
import torch

from tiny import ROOT, restore_program, tiny_root

import harness
import roofline_klf8
from calibrate_klf8 import FAULTS
from reference import autoencoder_kl as plain

CELL = "klf8_train"
# the configuration cut to the CPU: the tests' small widths and images,
# batch 2, the real K = 16; the checked steps take 2 x 16 batches, the
# window (at least 4 super-steps) and its warm-up 5 x 16 more
SMALL = {"block_out_channels": [64, 128], "img_size": [3, 32, 32],
         "latent_dim": 4 * 16 * 16, "n_images": 256, "batch_size": 2}


def _small_root(tmp_path):
    root, bench = tiny_root(tmp_path)
    path = os.path.join(root, "bench_port", "configs", "klf8_celebahq.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, bench


def _run(tmp_path, seed=2 ** 31 + 7, trace=False):
    root, bench = _small_root(tmp_path)
    try:
        return harness.run_cell(bench, CELL, seed, 0.2, trace,
                                torch.device("cpu"), root=root)
    finally:
        restore_program()


def test_reference_step_matches_the_program_at_the_small_size():
    """One step under `default` against the reference's bf16_operands:
    the same bf16 products summed in float32 by the same kernels."""
    from disvae_tpu_torch.models.vae import VAE
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
    cfg = dict(SMALL, betaH_B=1.5e-6, lr=8.64e-4)
    arch, img = plain.architecture(cfg), tuple(SMALL["img_size"])
    weights = plain.init_params(img, 3, torch.device("cpu"), arch)
    g = torch.Generator().manual_seed(4)
    x = torch.rand((2, 32, 32, 3), generator=g)
    eps = torch.randn((2, SMALL["latent_dim"]), generator=g)
    configure("default")
    try:
        model = VAE(img, SMALL["latent_dim"], "AutoencoderKL", **arch)
        model.load_state_dict(weights)
        loss_f = get_loss_f("betaH", rec_dist="laplace", reg_anneal=0,
                            betaH_B=1.5e-6)
        state = create_train_state(model, make_optimizer(
            model.parameters(), 8.64e-4), torch.Generator(),
            loss_cfg=loss_f)
        got = make_train_step(loss_f)(state, x, {"eps": eps})
    finally:
        restore_program()
    ref = plain.train_steps(weights, [x], [eps], cfg, "bf16_operands")
    assert float(got["loss"]) == pytest.approx(ref["losses"][0], rel=1e-6)
    assert float(got["kl_loss"]) == pytest.approx(ref["kls"][0], rel=1e-6)


@pytest.mark.parametrize("img_size, arch", [
    ((3, 256, 256), {}),
    ((3, 32, 32), {"block_out_channels": (64, 128)})])
def test_frozen_flops_are_torchs_count_of_the_reference(img_size, arch):
    """A training image's FLOPs (forward, input and weight gradients, no
    input gradient of conv_in) as torch's flop counter counts the
    reference's step on meta tensors; 2.684 TFLOP at 256 x 256."""
    from torch.utils.flop_counter import FlopCounterMode
    a = plain.architecture(arch)
    cfg = {"img_size": img_size, "betaH_B": 1.5e-6}
    d = plain.latent_shape(img_size, a)
    with torch.device("meta"):
        p = {n: torch.empty(s, requires_grad=True)
             for n, s, _ in plain.param_spec(img_size, a)}
        x = torch.empty((2, img_size[1], img_size[2], img_size[0]))
        eps = torch.empty((2, d[0] * d[1] * d[2]))
        counter = FlopCounterMode(display=False)
        with counter:
            value, _ = plain.loss(p, x, eps, dict(cfg, **arch), "float32")
            torch.autograd.grad(value, list(p.values()))
    assert counter.get_total_flops() == 2 * \
        roofline_klf8.train_flops_per_image(img_size, **arch)
    if not arch:
        assert roofline_klf8.forward_flops(img_size) == 894_909_448_192
        assert roofline_klf8.train_flops_per_image(img_size) \
            == 2_684_275_359_744


def test_a_sound_run_is_correct(tmp_path):
    result, checks = _run(tmp_path)
    assert result["correct"], checks
    assert result["attempted"] == 4 * 16 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_images_per_s", "setup_s"}


def test_a_traced_run_reads_its_metrics(tmp_path):
    """On the CPU the device metrics find no device events and are left
    out; the share of the peak is read from the host clock."""
    result, checks = _run(tmp_path, trace=True)
    assert result["correct"], checks
    assert result["metrics"]["klf8_train_mfu"]["value"] > 0


@pytest.mark.parametrize("fault", ["no_attention", "norm_eps_1e-2",
                                   "thin_wgrad_doubled", "half_batch",
                                   "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    result, checks = _run(tmp_path)
    assert not result["correct"], checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    restore_program()


def _card_run(seed, device, control=False):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return harness.run_cell(bench, CELL, seed, 2.0, False, device, ROOT,
                            control)


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(cuda):
    result, checks = _card_run(2 ** 31 + 201, cuda, control=True)
    assert not result["correct"], checks


@pytest.mark.gpu
def test_a_sound_run_is_correct_on_the_card(cuda):
    result, checks = _card_run(2 ** 31 + 202, cuda)
    assert result["correct"], checks


@pytest.mark.gpu
@pytest.mark.parametrize("fault, seed", [("thin_wgrad_doubled", 203),
                                         ("no_attention", 204)])
def test_a_planted_fault_is_not_correct_on_the_card(cuda, monkeypatch,
                                                    fault, seed):
    FAULTS[fault](monkeypatch.setattr)
    result, checks = _card_run(2 ** 31 + seed, cuda)
    assert not result["correct"], checks
