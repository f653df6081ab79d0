"""Whether the program's spans share the device trace's clock, and what a
span costs on this host.

    python3 bench_port/span_clock.py [--workload dsprites_mig] [--seed N]
        [--seconds 15]

Runs the cell's set-up and its window under the traced run's profiler
(`devtrace.Profile`), as `--trace 1` does, then checks that every K3
launch (a device operation whose name holds `log_qz_`) starts after the
start of a `disvae::eval.entropy` host range and ends before that range's
end: the Evaluator waits for the sweep's sums inside the phase, so a K3
launch outside every range means the two clocks disagree. Then it times
one span with no profiler recording and one under the profiler, over many
calls. Prints one JSON line: the K3 launches and the entropy ranges
counted, those inside, the least margins at both ends, the window's idle
gaps by host event, the span tally, and the costs. Exits with 1 when a
K3 launch lies outside every range (a cell without K3, such as the
training cell, reads 0 launches and exits with 0).
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


def _per_span_ns(span, calls):
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        with span("clock"):
            pass
    return (time.perf_counter_ns() - t0) / calls


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="dsprites_mig")
    p.add_argument("--seed", type=int, default=2 ** 31 + 977)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--root", default=ROOT,
                   help="the checkout whose BENCHMARK.json and benchmark "
                        "files to run (a small copy for a dry run on the "
                        "CPU)")
    args = p.parse_args(argv)

    import torch
    from devtrace import _DEVICE, Profile, summarize
    from disvae_tpu_torch.utils import trace

    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    bench = harness.load_json(os.path.join(args.root, "BENCHMARK.json"))
    cell = harness.Cell(bench, args.workload, args.seed, args.seconds, True,
                        device, root=args.root)
    try:
        driver = cell.driver()
        state = driver.setup(cell)
        harness._sync(device)
        trace.reset()
        with Profile(device) as prof:
            driver.window(cell, state)
        events = prof.events
        tally = trace.tally()
    finally:
        cell.close()

    phases, k3 = [], []
    for e in events:
        if e.device_type() == _DEVICE:
            if "log_qz_" in e.name() and not e.is_user_annotation():
                k3.append((e.start_ns(), e.end_ns()))
        elif e.name() == trace.PREFIX + "eval.entropy":
            phases.append((e.start_ns(), e.end_ns()))
    inside, lead, tail = 0, [], []
    for a, b in k3:
        home = [(r0, r1) for r0, r1 in phases if r0 <= a and b <= r1]
        if home:
            inside += 1
            lead.append(a - home[0][0])
            tail.append(home[0][1] - b)
    summary = summarize(events)
    del events, prof

    off_ns = _per_span_ns(trace.span, 200_000)
    enabled = torch._C._autograd._profiler_enabled
    t0 = time.perf_counter_ns()
    for _ in range(200_000):
        enabled()
    check_ns = (time.perf_counter_ns() - t0) / 200_000
    with Profile(device):
        on_ns = _per_span_ns(trace.span, 20_000)
    trace.reset()

    line = {"workload": args.workload, "seed": args.seed,
            "evals": cell.work.get("evals"),
            "k3_launches": len(k3), "entropy_ranges": len(phases),
            "k3_inside": inside,
            "least_lead_us": min(lead) / 1e3 if lead else None,
            "least_tail_us": min(tail) / 1e3 if tail else None,
            "busy_s": summary["busy_s"], "window_s": cell.window_s,
            "idle_gaps": summary["idle_gaps"],
            "tally": {k: list(v) for k, v in tally.items()},
            "span_off_ns": off_ns, "profiler_enabled_ns": check_ns,
            "span_on_ns": on_ns,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}
    print(json.dumps(line), flush=True)
    return 0 if inside == len(k3) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
