"""Stable Diffusion's kl-f8 autoencoder in the port
(disvae_tpu_torch/models/autoencoder_kl.py) against the plain reference,
the benchmark's (bench_port/reference/autoencoder_kl.py, loaded from its
file), on seeded weights at a small size on the CPU: block_out_channels (64,
128), 32 groups, 32 x 32 x 3 images, batch 2, latent 4 x 16 x 16.

Under `highest` both sides compute in float32 and differ only in the
order of float32 sums (F.linear adds its bias inside the product, the
reference after it): 1e-5 of scale in the forward and the loss, 1e-4 in
the gradients, which pass through some 40 such layers. One Adam step is
compared by each leaf's change, the norm of the two changes' difference
over the reference change's norm: the first step is lr * g / (|g| +
1e-8), so an element whose gradient is within rounding of zero may step
2 lr the other way, against a change of norm about lr sqrt(n) (5.2e-3
measured under `highest`, allowed 2e-2; 7.2e-7 under `default`, allowed
1e-5). Under `default`
both multiply the same bf16-rounded operands and sum in float32 with the
same kernels, and round the same cotangents: they agree to float32's
last bits (2e-7 of scale allowed in the forward and the loss, 1e-6 in
the gradients). Computing the attention's two
products on float32 operands under `default` moves the loss by about
1e-4 and fails these tolerances. Gradients are compared on the leaves
whose reference gradient is at least a thousandth of the median leaf's:
the attention's key bias has a zero gradient in exact arithmetic (the
softmax over keys ignores a shift common to them), so both sides hold
rounding noise there.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models import autoencoder_kl as A
from disvae_tpu_torch.models.vae import VAE, init_specific_model
from disvae_tpu_torch.ops import precision
from disvae_tpu_torch.ops.losses import get_loss_f
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
from disvae_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(ROOT, "bench_port", "reference", "autoencoder_kl.py")
    spec = importlib.util.spec_from_file_location(
        "bench_reference_autoencoder_kl", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R = _load_reference()
SMALL = {"block_out_channels": (64, 128)}
IMG = (3, 32, 32)
LATENT = 4 * 16 * 16
CFG = {"block_out_channels": [64, 128], "img_size": list(IMG),
       "betaH_B": 1.5e-6, "lr": 8.64e-4}
# (policy, reference numerics, forward and loss, gradients, Adam step)
POLICIES = {"highest": ("float32", 1e-5, 1e-4, 2e-2),
            "default": ("bf16_operands", 2e-7, 1e-6, 1e-5)}


@pytest.fixture(autouse=True)
def _restore():
    yield
    precision.configure("highest")
    trace.reset()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _model(seed=5):
    arch = R.architecture(CFG)
    weights = R.init_params(IMG, seed, torch.device("cpu"), arch)
    model = VAE(IMG, LATENT, "AutoencoderKL", **SMALL)
    model.load_state_dict(weights)
    return model, weights, arch


def _batches(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randint(0, 256, (2, 32, 32, 3), generator=g).float() / 255
          for _ in range(n)]
    return xs, [torch.randn((2, LATENT), generator=g) for _ in range(n)]


def _loss_f():
    return get_loss_f("betaH", rec_dist="laplace", reg_anneal=0,
                      betaH_B=CFG["betaH_B"])


def _step(model, x, eps):
    """One train step of the program: (its metrics, each leaf's gradient,
    the state)."""
    loss_f = _loss_f()
    state = create_train_state(model, make_optimizer(model.parameters(),
                                                     CFG["lr"]),
                               torch.Generator(), loss_cfg=loss_f)
    metrics = make_train_step(loss_f)(state, x, {"eps": eps})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads, state


def _moving(ref_grads):
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    median = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def test_parameter_names_and_count_are_diffusers():
    with torch.device("meta"):
        model = VAE((3, 256, 256), 4096, "AutoencoderKL")
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    # sd-vae-ft-mse: 83,653,863 parameters in 248 tensors
    assert sum(int(np.prod(s)) for s in shapes.values()) == 83_653_863
    assert len(shapes) == 248
    spec = R.param_spec((3, 256, 256), R.architecture())
    assert shapes == {n: s for n, s, _ in spec}
    for name, shape in [
            ("encoder.down_blocks.0.resnets.0.norm1.weight", (128,)),
            ("encoder.down_blocks.1.resnets.0.conv_shortcut.weight",
             (256, 128, 1, 1)),
            ("encoder.down_blocks.2.downsamplers.0.conv.weight",
             (512, 512, 3, 3)),
            ("encoder.mid_block.attentions.0.to_out.0.weight", (512, 512)),
            ("decoder.up_blocks.3.resnets.2.conv2.weight",
             (128, 128, 3, 3)),
            ("decoder.up_blocks.0.upsamplers.0.conv.bias", (512,)),
            ("quant_conv.weight", (8, 8, 1, 1)),
            ("post_quant_conv.weight", (4, 4, 1, 1))]:
        assert shapes[name] == shape, name


def test_model_names_match_case_aside_and_sizes_are_checked():
    gen = torch.Generator().manual_seed(0)
    for name in ("autoencoderkl", "AUTOENCODERKL", "AutoencoderKL"):
        assert init_specific_model(name, IMG, LATENT, generator=gen,
                                   **SMALL).model_type == "AutoencoderKL"
    assert init_specific_model("burgess", (1, 32, 32), 10).model_type \
        == "Burgess"
    with pytest.raises(ValueError, match="Unknown model_type"):
        init_specific_model("VQModel", IMG, LATENT)
    with pytest.raises(ValueError, match="latent_dim"):
        VAE(IMG, 10, "AutoencoderKL", **SMALL)
    with pytest.raises(RuntimeError, match="not supported"):
        VAE((3, 33, 33), LATENT, "AutoencoderKL", **SMALL)
    assert A.latent_dim((3, 256, 256)) == 4096


def test_default_init_is_torchs():
    model = init_specific_model("AutoencoderKL", IMG, LATENT,
                                generator=torch.Generator().manual_seed(3),
                                **SMALL)
    for name, p in model.named_parameters():
        if "norm" in name:
            assert torch.all(p == (1.0 if name.endswith("weight") else 0.0))
            continue
        layer = model.get_submodule(name.rsplit(".", 1)[0])
        bound = 1 / np.sqrt(layer.weight[0].numel())
        top = float(p.detach().abs().max())
        assert top <= bound * (1 + 1e-6)  # the bound in float32
        if name.endswith("weight"):  # 16 draws or more
            assert top > 0.5 * bound


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_forward_matches_the_reference(policy):
    numerics, tol, _, _ = POLICIES[policy]
    precision.configure(policy)
    model, weights, arch = _model()
    with torch.no_grad():
        # push one latent channel's log-variance past each end of the clamp
        for m in (model.quant_conv.bias, weights["quant_conv.bias"]):
            m[5] += 60.0
            m[6] -= 60.0
    x, _ = _batches(1)
    with torch.no_grad():
        mu, logvar = model.encode(x[0])
        rmu, rlogvar = R.encode(weights, x[0], numerics, arch)
        assert mu.shape == logvar.shape == (2, LATENT)
        assert _rel(mu, rmu) <= tol and _rel(logvar, rlogvar) <= tol
        # channels 1 and 2 of the log-variance (quant_conv's 5 and 6)
        lv = logvar.view(2, 4, 16, 16)
        assert torch.all(lv[:, 1] == 20.0) and torch.all(lv[:, 2] == -30.0)
        recon = model.decode(mu)
        assert recon.shape == (2, 32, 32, 3)
        assert _rel(recon, R.decode(weights, rmu, IMG, numerics, arch)) \
            <= tol


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_train_step_matches_the_reference(policy):
    """The betaH-laplace loss and its KL, every moving leaf's gradient,
    and the parameters after one Adam step."""
    numerics, tol, grad_tol, step_tol = POLICIES[policy]
    precision.configure(policy)
    model, weights, _ = _model()
    xs, eps = _batches(1)
    metrics, grads, _ = _step(model, xs[0], eps[0])
    ref = R.train_steps(weights, xs, eps, CFG, numerics)
    assert abs(float(metrics["loss"]) - ref["losses"][0]) \
        <= tol * ref["losses"][0]
    assert abs(float(metrics["kl_loss"]) - ref["kls"][0]) \
        <= tol * ref["kls"][0]
    moving = _moving(ref["first_grads"])
    assert len(moving) >= len(grads) - 8  # the four key biases at most
    for n in moving:
        assert _rel(grads[n], ref["first_grads"][n]) <= grad_tol, n
    for n, p in model.named_parameters():
        if n in moving:
            change = ref["params"][n] - weights[n]
            assert float((p.detach() - ref["params"][n]).norm()
                         / change.norm()) <= step_tol, n


def test_float32_attention_under_default_fails_the_tolerance(monkeypatch):
    """The control: the attention's products on float32 operands."""
    numerics, tol, _, _ = POLICIES["default"]
    precision.configure("default")
    monkeypatch.setattr(precision, "matmul", torch.matmul)
    model, weights, _ = _model()
    xs, eps = _batches(1)
    metrics, _, _ = _step(model, xs[0], eps[0])
    ref = R.train_steps(weights, xs, eps, CFG, numerics)
    assert abs(float(metrics["loss"]) - ref["losses"][0]) \
        > 10 * tol * ref["losses"][0]


def test_activation_product_rounds_operands_and_cotangent():
    precision.configure("default")
    g = torch.Generator().manual_seed(2)
    a = torch.randn((3, 5, 7), generator=g, requires_grad=True)
    b = torch.randn((3, 7, 4), generator=g, requires_grad=True)
    dy = torch.randn((3, 5, 4), generator=g)
    y = precision.matmul(a, b)
    y.backward(dy)
    ra, rb, rdy = (precision.round_bf16(t.detach()) for t in (a, b, dy))
    assert torch.equal(y, ra @ rb)
    assert torch.equal(a.grad, rdy @ rb.transpose(1, 2))
    assert torch.equal(b.grad, ra.transpose(1, 2) @ rdy)
    precision.configure("highest")
    assert torch.equal(precision.matmul(a, b), a @ b)


def _conv_layers(model):
    return [m for m in model.modules()
            if isinstance(m, (precision.Conv2d, precision.Linear))]


@pytest.mark.parametrize("policy", ["default", "highest"])
def test_spans_and_wgrad_route_counts(policy):
    """Under a profiler an eager step shows the encode, the decode and the
    two mid blocks' attention as spans. The route counter counts each
    layer's weight gradient once a step: on the CPU the four thin convs
    (encoder conv_in, post_quant_conv, decoder conv_in and conv_out) take
    the float32 route, the rest TF32's; `highest` runs no `default`
    layer and counts none."""
    precision.configure(policy)
    model, _, _ = _model()
    xs, eps = _batches(2)
    loss_f = _loss_f()
    state = create_train_state(model, make_optimizer(model.parameters(),
                                                     CFG["lr"]),
                               torch.Generator(), loss_cfg=loss_f)
    step = make_train_step(loss_f)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for x, e in zip(xs, eps):
            step(state, x, {"eps": e})
    calls = {k: v[0] for k, v in trace.tally().items()}
    assert calls["vae.encode"] == calls["vae.decode"] == 2
    assert calls["vae.mid_attn"] == 4
    counts = trace.counts()
    if policy == "highest":
        assert counts == {}
        return
    n_layers = len(_conv_layers(model))
    assert counts == {"wgrad.f32": 2 * 4, "wgrad.tf32": 2 * (n_layers - 4)}
    # counted without a profiler too
    trace.reset()
    step(state, xs[0], {"eps": eps[0]})
    assert trace.tally() == {} and trace.counts()["wgrad.f32"] == 4


def test_maps_stay_channels_last_where_k5_runs(monkeypatch):
    """Where K5 takes the GroupNorms (here its route forced on CPU
    tensors, its plain version standing in, as on the card) every conv of
    the encoder and of the decoder gets a channels-last input, forward:
    the decoder's latent is turned channels-last once and no layer turns
    it back. 16 groups keep 4 and 8 channels a group, which K5's NHWC
    layout takes, so K5 counts each of the 30 sites channels-last and
    makes no copy. Without the route the maps keep the layout they come
    in (the decoder NCHW, as the plain reference's)."""
    precision.configure("default")
    model = init_specific_model("AutoencoderKL", IMG, LATENT,
                                generator=torch.Generator().manual_seed(0),
                                norm_num_groups=16, **SMALL)
    xs, eps = _batches(1)
    seen = {}

    def hook(name):
        def pre(module, args):
            seen[name] = args[0].is_contiguous(
                memory_format=torch.channels_last)
        return pre
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, precision.Conv2d)}
    for n, m in convs.items():
        m.register_forward_pre_hook(hook(n))
    _step(model, xs[0], eps[0])
    assert not seen["post_quant_conv"] and not seen["decoder.conv_in"]
    route = precision.takes_group_norm_silu
    monkeypatch.setattr(precision, "takes_group_norm_silu",
                        lambda dtype, device: route(dtype, "cuda"))
    monkeypatch.setattr(A, "channels_last", lambda x: route(x.dtype, "cuda"))
    seen.clear()
    trace.reset()
    _step(model, xs[0], eps[0])
    assert sorted(seen) == sorted(convs)
    assert any(n.startswith("encoder.") for n in seen)
    assert any(n.startswith("decoder.") for n in seen)
    assert [n for n, last in seen.items() if not last] == []
    counts = trace.counts()
    assert counts["norm.k5"] == counts["norm.k5_nhwc"] == 30
    assert "norm.k5_copy" not in counts


def _hq_dataset(n=24):
    imgs = (np.random.RandomState(4).rand(n, 32, 32, 3) * 255).astype(
        np.uint8)

    class SmallHQ(PD.ArrayDataset):
        img_size = IMG
        name = "celebahq"
        background_color = PD.COLOUR_WHITE

        def __init__(self, root=None, logger=None):
            super().__init__(imgs)
    return SmallHQ


def test_cli_trains_autoencoder_kl_on_cpu(tmp_path, monkeypatch):
    """`python -m disvae_tpu_torch <name> -m AutoencoderKL -d celebahq
    --precision default` through the normal Trainer (the resident feed,
    super-steps, logs, checkpoints), then the test losses of the saved
    model: at the small widths on a seeded ArrayDataset in place of
    CelebA-HQ."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.utils.modelIO import load_metadata
    monkeypatch.setattr(A, "BLOCK_OUT_CHANNELS", SMALL["block_out_channels"])
    monkeypatch.setitem(PD.DATASETS_DICT, "celebahq", _hq_dataset())
    monkeypatch.chdir(tmp_path)
    flags = ["-m", "AutoencoderKL", "-d", "celebahq", "-l", "betaH", "-r",
             "laplace", "--betaH-B", "1.5e-6", "-a", "0", "-b", "4", "-e",
             "2", "--lr", "8.64e-4", "--precision", "default",
             "--checkpoint-every", "1", "--no-viz-gif", "--no-progress-bar",
             "-s", "3", "--eval-batchsize", "8", "--resident-data",
             "always", "--no-cuda"]
    with pytest.raises(SystemExit):
        cli.parse_arguments(["bad"] + flags + ["-z", "10"])
    args = cli.parse_arguments(["run"] + flags)
    assert args.latent_dim == LATENT
    try:
        trainer, evaluator = cli.main(args)
    finally:
        precision.configure("highest")
    run = tmp_path / "results" / "run"
    for f in ["model.pt", "specs.json", "train_state.pt", "model-0.pt",
              "model-1.pt", "train_losses.log", "test_losses.log"]:
        assert (run / f).exists(), f
    assert trainer.resident_data is not None
    assert trainer.state.step == 2 * 6
    assert isinstance(trainer.model, VAE) \
        and trainer.model.model_type == "AutoencoderKL"
    specs = load_metadata(str(run))
    assert specs["model_type"] == "AutoencoderKL"
    assert specs["latent_dim"] == LATENT and specs["img_size"] == list(IMG)
    log = (run / "train_losses.log").read_text()
    assert "kl_loss_{}".format(LATENT - 1) in log
    losses = load_metadata(str(run), filename="test_losses.log")
    assert all(np.isfinite(v) for v in losses.values())
