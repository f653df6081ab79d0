"""Run one benchmark cell once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds the program (disvae_tpu_torch)
and BENCHMARK.json. The run makes its inputs and weights from the seed,
builds and warms the program up (set-up), measures for about `--seconds`
(with `--trace 1` under the profiler, reporting the cell's per-layer
metrics instead of its end-to-end ones), checks what the window produced
against the plain reference, and prints one JSON line last on standard
output. The numbers compared, each beside its limit, are the last lines
on standard error and the `checks` key of the result. It exits with
another code than 0, and prints no result, without the CUDA devices the
cell asks for, when the program cannot be imported, or when JAX or the
JAX package is loaded in the process once the window has closed.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [BENCH_DIR, ROOT]

import harness  # noqa: E402


def main(argv):
    started = harness.process_seconds()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print("no workload {!r} in BENCHMARK.json".format(args.workload),
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print("the cell needs {} CUDA device(s); {} visible".format(
            entry["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    import disvae_tpu_torch  # noqa: F401  (fails without the program)

    result, checks = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), ROOT, started=started)
    bad = harness.forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package are loaded: {}".format(
            ", ".join(bad)), file=sys.stderr)
        return 3
    for name, c in checks.items():
        print("check {} {!r} limit {!r}".format(name, c["value"],
                                               c["limit"]), file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
