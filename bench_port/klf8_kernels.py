"""The device kernels of the klf8 configuration's train step, by what
launched them, for the readers of its per-layer metrics.

    python3 bench_port/klf8_kernels.py [--batch 12] [--out FILE]

On the card, at the configuration's widths and image size under its
`default` numerics: one eager train step of the program under the
profiler, each kernel credited to the program span (utils/trace.py) that
was open when its launching op began (`vae.encode`, `vae.decode`,
`vae.mid_attn`; the backward runs outside them) and to that op; then
GroupNorm's forward and backward alone at the widest map, (B, 128, 256,
256), and the weight gradient of each thin conv alone (the float32
route, `wgrad.f32`), with the route counters' counts.
Prints one JSON document (the step's time and memory, kernels by span
and op, the isolated kernels) and writes it to `--out`.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import harness  # noqa: E402
from reference import autoencoder_kl as plain  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _profiled(fn):
    """Run fn() under the profiler; its raw events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def _kernels(events):
    """{kernel name: [seconds, count]}."""
    out = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type() == CUDA and not e.is_user_annotation():
            out[e.name()][0] += (e.end_ns() - e.start_ns()) * 1e-9
            out[e.name()][1] += 1
    return {k: v for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def _by_launcher(events):
    """{span: {op: {kernel: [seconds, count]}}}: each kernel under the op
    that launched it and the innermost program span open at that op's
    start."""
    ops = {e.correlation_id(): e for e in events
           if e.device_type() == CPU and e.correlation_id()}
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                   if e.device_type() == CPU
                   and e.name().startswith("disvae::"))
    out = defaultdict(lambda: defaultdict(lambda: defaultdict(
        lambda: [0.0, 0])))
    for e in events:
        if e.device_type() != CUDA or e.is_user_annotation():
            continue
        op = ops.get(getattr(e, "linked_correlation_id", lambda: 0)())
        t = op.start_ns() if op is not None else e.start_ns()
        inside = [s for s in spans if s[0] <= t <= s[1]]
        span = max(inside)[2] if inside else "(no span)"
        k = out[span][op.name() if op is not None else "?"][e.name()]
        k[0] += (e.end_ns() - e.start_ns()) * 1e-9
        k[1] += 1
    return {s: {o: dict(ks) for o, ks in d.items()} for s, d in out.items()}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from disvae_tpu_torch.models.vae import VAE
    from disvae_tpu_torch.ops import precision
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
    from disvae_tpu_torch.utils import trace

    dev = torch.device("cuda")
    bench = harness.load_json(os.path.join(os.path.dirname(BENCH_DIR),
                                           "BENCHMARK.json"))
    conf = next(c for c in bench["configs"] if c["name"] == "klf8_celebahq")
    cfg = harness.load_json(os.path.join(os.path.dirname(BENCH_DIR),
                                         conf["file"]))
    precision.configure(cfg["precision"])
    img, arch, B = tuple(cfg["img_size"]), plain.architecture(cfg), args.batch
    model = VAE(img, cfg["latent_dim"], cfg["model"], **arch).to(dev)
    model.load_state_dict(plain.init_params(img, 1, dev, arch))
    loss_f = get_loss_f(cfg["loss"], n_data=cfg["n_images"], **cfg)
    state = create_train_state(model, make_optimizer(model.parameters(),
                                                     cfg["lr"]),
                               torch.Generator(device=dev), loss_cfg=loss_f)
    step = make_train_step(loss_f)
    batch = torch.randint(0, 256, (B, img[1], img[2], img[0]),
                          dtype=torch.uint8, device=dev)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trace.reset()
    t0 = time.perf_counter()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t0) / 3
    counts = trace.counts()
    events = _profiled(lambda: step(state, batch))
    report = {"device": torch.cuda.get_device_name(dev), "batch": B,
              "eager_step_s": eager_s,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
              "route_counts_3_steps": counts,
              "step_kernels": _kernels(events),
              "step_by_launcher": _by_launcher(events),
              "tally": trace.tally()}
    del state, model
    torch.cuda.empty_cache()

    x = torch.randn((B, arch["block_out_channels"][0], img[1], img[2]),
                    device=dev, requires_grad=True)
    norm = torch.nn.GroupNorm(arch["norm_num_groups"], x.shape[1],
                              eps=1e-6).to(dev)
    report["group_norm_kernels"] = _kernels(_profiled(
        lambda: norm(x).backward(torch.ones_like(x))))
    f = 2 ** (len(arch["block_out_channels"]) - 1)
    lc = arch["latent_channels"]
    thin = {"encoder.conv_in": (img[0], arch["block_out_channels"][0], 1),
            "decoder.conv_out": (arch["block_out_channels"][0], img[0], 1),
            "post_quant_conv": (lc, lc, f),
            "decoder.conv_in": (lc, arch["block_out_channels"][-1], f)}
    report["thin_wgrad_kernels"] = {}
    for name, (cin, cout, down) in thin.items():
        k = 1 if name == "post_quant_conv" else 3
        conv = precision.Conv2d(cin, cout, k, padding=k // 2).to(dev)
        xin = torch.randn((B, cin, img[1] // down, img[2] // down),
                          device=dev)
        y = conv(xin)
        dy = torch.randn_like(y)
        trace.reset()
        report["thin_wgrad_kernels"][name] = {
            "kernels": _kernels(_profiled(lambda: y.backward(
                dy, retain_graph=True))),
            "counts": trace.counts()}
    text = json.dumps(report, indent=1, default=list)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main(sys.argv[1:])
