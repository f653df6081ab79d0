"""One layer under the ``default`` precision policy against float64 on
the same bf16-rounded operands: shared by the card tests
(tests/test_torch_gpu.py) and chip_smoke.py. torch only, no jax."""

import torch.nn.functional as F


def layer_against_float64(kind, fn, x, w, b, g):
    """Run `fn(x, w, b)` (a conv, transposed conv or linear of `kind`:
    "conv", "convT" or "linear") under the current policy with cotangent
    `g`, and return {y, dx, dw, db: (float64 reference, result)}: the
    reference runs on x and w rounded to bf16 values with the rounded
    cotangent, its db from the unrounded one, its bias added in float64."""
    from disvae_tpu_torch.ops.precision import round_bf16
    x = x.detach().clone().requires_grad_()
    w = w.detach().clone().requires_grad_()
    b = b.detach().clone().requires_grad_()
    y = fn(x, w, b)
    y.backward(g)
    xd = round_bf16(x.detach()).double().requires_grad_()
    wd = round_bf16(w.detach()).double().requires_grad_()
    if kind == "linear":
        ref, dims = F.linear(xd, wd), (0,)
    else:
        op = F.conv2d if kind == "conv" else F.conv_transpose2d
        ref, dims = op(xd, wd, None, stride=2, padding=1), (0, 2, 3)
    ref.backward(round_bf16(g).double())
    shape = (-1,) + (1,) * (ref.dim() - 2)
    return {"y": (ref.detach() + b.detach().double().view(shape), y.detach()),
            "dx": (xd.grad, x.grad), "dw": (wd.grad, w.grad),
            "db": (g.double().sum(dim=dims), b.grad)}


def relative_errors(pairs):
    """{name: max |result - reference| / max |reference|}."""
    return {k: ((got.double() - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30)).item()
            for k, (ref, got) in pairs.items()}
