"""Readings for the correctness limits, at a cell's own size, on the chip.

    python3 bench_port/calibrate.py --workload <cell> --seeds <s1,s2,...>
        [--control-seeds <...>] [--seconds <s>] [--out <file>]

Each seed is one whole run of the cell (`harness.run_cell`, a short
window), the program's for `--seeds` and the control's (the program's
lower-precision path in its place) for `--control-seeds`; a line gives
every number the cell's check computes, those its limits name and the
rest. For the training cell it adds the per-leaf gaps and the fault of a
step that leaves out half of each batch, read as the reference with that
fault against the reference. One JSON line per reading, on standard
output and appended to `--out`. The benchmark's runs never run this: it
sets the limits in `limits/<cell>.json`.
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


def readings(bench, workload, seed, seconds, device, control=False,
             root=ROOT):
    """{mode: readings} of one run: "program" (or "control"), and for the
    training cell "half_batch"."""
    out = {}

    def extra(cell, driver, kept, got):
        mode = "control" if control else "program"
        out[mode] = dict(got)
        if cell.traffic["kind"] == "train_epochs":
            ref = driver.reference(cell, kept)
            out[mode]["leaves"] = driver.leaf_gaps(cell, kept, ref)
            if not control:
                half = driver.reference(cell, kept, half=True)
                out["half_batch"] = dict(driver.compare(cell, half, ref),
                                         leaves=driver.leaf_gaps(
                                             cell, half, ref))

    result, _ = harness.run_cell(bench, workload, seed, seconds, False,
                                 device, root, control, extra=extra)
    out["correct"] = result["correct"]
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    runs = ([(int(s), False) for s in args.seeds.split(",") if s]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    for seed, control in runs:
        t0 = time.perf_counter()
        got = readings(bench, args.workload, seed, args.seconds, device,
                       control)
        correct = got.pop("correct")
        for mode, values in got.items():
            line = json.dumps({"workload": args.workload, "mode": mode,
                               "seed": seed, "correct": correct,
                               "readings": values,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
