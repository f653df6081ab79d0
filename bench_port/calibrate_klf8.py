"""Readings for the `klf8_train` cell's correctness limits, at the cell's
own size, on the chip.

    python3 bench_port/calibrate_klf8.py [--seeds <s1,s2,...>]
        [--control-seeds <...>] [--faults <name:seed,...>]
        [--seconds <s>] [--out <file>] [--leaves <dir>]

Each seed is one whole run of the cell (`harness.run_cell`, a short
window): the program's for `--seeds`, the control's (the program's
lower compute dtype) for `--control-seeds`, and the program with a fault
of `FAULTS` planted for `--faults`. A line gives every number the
driver's check computes, and the largest and median first-step gradient
gap of each group of leaves (`GROUPS`). A program run adds, with no
further run of the program:

* "half_batch": the reference's steps over the first half of each batch
  against the reference's own;
* "loss_1pct": the program's readings with its first loss 1% off;
* "state_unchanged": the program's readings with no parameter changed;
* "ulp": how far one ulp of the parameters moves the reference's
  gradients, per group: at the seeded weights on the first batch under
  the configuration's numerics ("step1") and in float32 ("step1_f32"),
  and at the reference's parameters after the K steps on the last batch
  ("stepK").

One JSON line per reading, on standard output and appended to `--out`;
`--leaves` keeps each run's per-leaf gaps. The benchmark's runs never
run this: it sets `limits/klf8_train.json`.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

import harness  # noqa: E402

WORKLOAD = "klf8_train"
# a leaf's group, by the first of these its name holds; "other" else
GROUPS = ("attentions", "norm")


def no_attention(setattr):
    """The mid blocks' attention left out (its residual alone)."""
    from disvae_tpu_torch.models import autoencoder_kl
    setattr(autoencoder_kl.Attention, "forward", lambda self, x: x)


def _norm_eps(eps):
    def fault(setattr):
        from disvae_tpu_torch.models import autoencoder_kl
        setattr(autoencoder_kl, "NORM_EPS", eps)
    fault.__doc__ = "GroupNorm's eps {:g} in place of 1e-6.".format(eps)
    return fault


def thin_wgrad_doubled(setattr):
    """The thin layers' weight gradients (the float32 route) doubled."""
    from disvae_tpu_torch.ops import precision
    orig = precision._conv_backward

    def backward(dy, x, w, kind, stride, padding, mask):
        dx, dw = orig(dy, x, w, kind, stride, padding, mask)
        if dw is not None and precision._is_thin(w):
            dw = 2 * dw
        return dx, dw
    setattr(precision, "_conv_backward", backward)


def half_batch(setattr):
    """The loss of each step over the first half of its batch only."""
    from disvae_tpu_torch.ops.losses import BetaHLoss
    orig = BetaHLoss.__call__

    def call(self, data, recon, latent_dist, *args, **kwargs):
        h = data.shape[0] // 2
        return orig(self, data[:h], recon[:h],
                    tuple(t[:h] for t in latent_dist), *args, **kwargs)
    setattr(BetaHLoss, "__call__", call)


def state_unchanged(setattr):
    """Every optimizer step leaves the parameters as they were."""
    import torch
    orig = torch.optim.Adam.step

    def step(self, *args, **kwargs):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        out = orig(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out
    setattr(torch.optim.Adam, "step", step)


FAULTS = {"no_attention": no_attention,
          "norm_eps_1e-5": _norm_eps(1e-5),
          "norm_eps_1e-2": _norm_eps(1e-2),
          "thin_wgrad_doubled": thin_wgrad_doubled,
          "half_batch": half_batch,
          "state_unchanged": state_unchanged}


class Patches:
    """`setattr` that remembers what it replaced; `undo()` puts it back."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())


def group(name):
    return next((g for g in GROUPS if g in name), "other")


def by_group(gaps):
    """{group: {"max", "median", "worst"}} of {leaf: gap}."""
    import numpy as np
    out = {}
    for g in GROUPS + ("other",):
        leaves = {n: v for n, v in gaps.items() if group(n) == g}
        if leaves:
            worst = max(leaves, key=leaves.get)
            out[g] = {"max": leaves[worst], "worst": worst,
                      "median": float(np.median(list(leaves.values())))}
    return out


def ulp_gaps(driver, cell, kept, ref):
    """Per group, how far one ulp of every parameter (up or down, at
    random) moves the reference's gradient (module docstring)."""
    import torch
    from reference import autoencoder_kl as plain
    cfg, dev = cell.config, cell.device
    weights, batches, noises = driver.inputs_of(cell, kept)
    gen = torch.Generator(device=dev).manual_seed(kept["train_seed"])

    def nudged(params):
        return {n: torch.nextafter(t, torch.where(
            torch.rand(t.shape, generator=gen, device=dev) < 0.5,
            -torch.inf, torch.inf)) for n, t in params.items()}

    def gap(params, x, eps, numerics):
        a = plain.gradients(params, x, eps, cfg, numerics)
        b = plain.gradients(nudged(params), x, eps, cfg, numerics)
        moving = driver._moving({n: t.cpu() for n, t in a.items()})
        return by_group({n: float((b[n] - a[n]).norm() / a[n].norm())
                         for n in moving})
    after = {n: weights[n] + ref["change"][n].to(dev) for n in weights}
    numerics = cfg["reference_numerics"]
    return {"step1": gap(weights, batches[0], noises[0], numerics),
            "step1_f32": gap(weights, batches[0], noises[0], "float32"),
            "stepK": gap(after, batches[-1], noises[-1], numerics)}


def readings(bench, seed, seconds, device, control=False, fault=None,
             leaves=None, root=ROOT):
    """{mode: readings} of one run (module docstring)."""
    import torch
    out = {}
    mode = "control" if control else fault or "program"

    def extra(cell, driver, kept, got):
        ref = driver.reference(cell, kept)
        gaps = driver.leaf_gaps(kept, ref)
        out[mode] = dict(got, groups=by_group(gaps["grad"]))
        if leaves:
            os.makedirs(leaves, exist_ok=True)
            with open(os.path.join(leaves, "{}_{}.json".format(mode, seed)),
                      "w") as f:
                json.dump(gaps, f, indent=0)
        if control or fault:
            return
        half = driver.reference(cell, kept, half=True)
        half_got = {"loss_step1": half["losses"][0],
                    "kl_step1": half["kls"][0],
                    "first_grads": half["first_grads"],
                    "change": half["change"]}
        out["half_batch"] = dict(driver.compare(half_got, ref), groups=by_group(
            driver.leaf_gaps(half_got, ref)["grad"]))
        out["loss_1pct"] = driver.compare(
            dict(kept, loss_step1=1.01 * kept["loss_step1"]), ref)
        out["state_unchanged"] = driver.compare(
            dict(kept, change={n: torch.zeros_like(t)
                               for n, t in kept["change"].items()}), ref)
        out["ulp"] = ulp_gaps(driver, cell, kept, ref)

    patches = Patches()
    if fault:
        FAULTS[fault](patches)
    try:
        result, _ = harness.run_cell(bench, WORKLOAD, seed, seconds, False,
                                     device, root, control, extra=extra)
    finally:
        patches.undo()
    out["correct"] = result["correct"]
    out["memory_peak_bytes"] = result["device"]["memory_peak_bytes"]
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="",
                   help="name:seed,... with names from FAULTS")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    p.add_argument("--leaves")
    args = p.parse_args(argv)
    import torch
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    runs = ([(int(s), False, None) for s in args.seeds.split(",") if s]
            + [(int(s), True, None)
               for s in args.control_seeds.split(",") if s]
            + [(int(f.split(":")[1]), False, f.split(":")[0])
               for f in args.faults.split(",") if f])
    for seed, control, fault in runs:
        t0 = time.perf_counter()
        got = readings(bench, seed, args.seconds, device, control, fault,
                       args.leaves)
        correct, peak = got.pop("correct"), got.pop("memory_peak_bytes")
        for mode, values in got.items():
            line = json.dumps({"workload": WORKLOAD, "mode": mode,
                               "seed": seed, "correct": correct,
                               "memory_peak_bytes": peak,
                               "readings": values,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
