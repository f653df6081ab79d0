"""Drive a complete evidence set for one predefined experiment through the
port's own CLIs, then snapshot it into an output directory.

    python -m disvae_tpu_torch.evidence <name> <experiment> [-s SEED]
        --out DIR [--train-flags "..."] [--skip-metrics] [--no-cuda]

Counterpart of tools/evidence_run.sh and tools/snapshot_artifacts.sh. The
legs run as subprocesses, in the current directory (the run lands in
`results/<name>/`), in this order:

1. train: `python -m disvae_tpu_torch <name> -x <experiment>
   --no-progress-bar -s <seed> <train flags>` (then the test losses);
2. metrics, reference-faithful: `--is-eval-only --is-metrics --no-test`;
3. metrics, corrected: the same with `--corrected-mig`;
4. plots: `python -m disvae_tpu_torch.cli_viz <name> all -s 1`.

After legs 2 and 3, and after the plots, every `*.json`, `*.log`, `*.png`
and `*.gif` of the run directory is copied to DIR, with `metrics.log`
renamed to `metrics.reference-faithful.log`, then `metrics.corrected.log`;
`MANIFEST.txt` lists the run directory, and a canonical file the run
lacks is reported on stderr. `device.json` records the card (nvidia-smi's
name and power limit), the torch and CUDA versions and each leg's
seconds. Each leg's output goes to DIR/legs/<leg>.log; a leg that exits
non-zero raises with the tail of its log. `--skip-metrics` leaves out
legs 2 and 3 (datasets without a factor lattice). Every leg runs on the
card unless `--no-cuda` is passed.
"""

import argparse
import json
import os
import shlex
import shutil
import stat
import subprocess
import sys
import time

import torch

from disvae_tpu_torch.cli import RES_DIR

# the package's parent directory: the legs import the package from here
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# files a complete run directory holds (tools/snapshot_artifacts.sh)
CANONICAL = ("specs.json", "train_losses.log", "test_losses.log",
             "metrics.log")
SNAPSHOT_SUFFIXES = (".json", ".log", ".png", ".gif")
TAIL_LINES = 20


class LegFailed(RuntimeError):
    """A leg of the evidence run exited non-zero."""


def parse_arguments(argv):
    parser = argparse.ArgumentParser(
        prog="python -m disvae_tpu_torch.evidence",
        description=__doc__.split("\n")[0])
    parser.add_argument("name", help="run name (results/<name>/)")
    parser.add_argument("experiment", help="predefined experiment of "
                        "hyperparam.ini, e.g. btcvae_dsprites")
    parser.add_argument("-s", "--seed", type=int, default=1234)
    parser.add_argument("--out", required=True,
                        help="directory the evidence set is copied into")
    parser.add_argument("--train-flags", default="",
                        help="extra flags for the train leg only")
    parser.add_argument("--skip-metrics", action="store_true",
                        help="leave out both MIG/AAM legs")
    parser.add_argument("--no-cuda", action="store_true",
                        help="run every leg on the CPU")
    return parser.parse_args(argv)


def legs(args):
    """[(leg name, argv, metrics suffix of the snapshot taken after it, or
    None for no snapshot)] in run order."""
    cli = [sys.executable, "-m", "disvae_tpu_torch", args.name, "-x",
           args.experiment, "--no-progress-bar"]
    cuda = ["--no-cuda"] if args.no_cuda else []
    eval_only = cli + ["--is-eval-only", "--is-metrics", "--no-test"] + cuda
    out = [("train", cli + ["-s", str(args.seed)]
            + shlex.split(args.train_flags) + cuda, None)]
    if not args.skip_metrics:
        out += [("metrics-reference-faithful", eval_only,
                 "reference-faithful"),
                ("metrics-corrected", eval_only + ["--corrected-mig"],
                 "corrected")]
    # the last snapshot: metrics.log holds the corrected mode by then
    out.append(("viz", [sys.executable, "-m", "disvae_tpu_torch.cli_viz",
                        args.name, "all", "-s", "1"] + cuda, "corrected"))
    return out


def run_leg(name, argv, log_path):
    """Run one leg with its output in `log_path`; returns its seconds.
    Raises LegFailed with the log's tail if it exits non-zero."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    print("== {}: {}".format(name, " ".join(argv)), file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(argv, stdout=log, stderr=subprocess.STDOUT,
                            env=env).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as log:
            tail = log.readlines()[-TAIL_LINES:]
        raise LegFailed("leg {} exited with {} after {:.1f} s; the last "
                        "lines of {}:\n{}".format(name, rc, seconds,
                                                  log_path, "".join(tail)))
    print("== {} done in {:.1f} s".format(name, seconds), file=sys.stderr,
          flush=True)
    return seconds


def manifest(run_dir):
    """A listing of the run directory: mode, bytes, modification time and
    name of each entry."""
    lines = []
    for name in sorted(os.listdir(run_dir)):
        st = os.stat(os.path.join(run_dir, name))
        lines.append("{} {:>12} {} {}".format(
            stat.filemode(st.st_mode), st.st_size,
            time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(st.st_mtime)),
            name))
    return "\n".join(lines) + "\n"


def snapshot(run_dir, out, suffix=None):
    """Copy the run's evidence files to `out` (metrics.log renamed to
    metrics.<suffix>.log when `suffix` is given), write MANIFEST.txt, and
    report the canonical files the run lacks on stderr. Returns them."""
    os.makedirs(out, exist_ok=True)
    for name in sorted(os.listdir(run_dir)):
        if not name.endswith(SNAPSHOT_SUFFIXES):
            continue
        dest = name
        if name == "metrics.log" and suffix:
            dest = "metrics.{}.log".format(suffix)
        shutil.copyfile(os.path.join(run_dir, name), os.path.join(out, dest))
    with open(os.path.join(out, "MANIFEST.txt"), "w") as f:
        f.write(manifest(run_dir))
    missing = [f for f in CANONICAL
               if not os.path.exists(os.path.join(run_dir, f))]
    if missing:
        print("WARNING: the snapshot of {} is missing: {}".format(
            run_dir, " ".join(missing)), file=sys.stderr, flush=True)
    return missing


def device_record(no_cuda):
    """The card as nvidia-smi names it, with its power limit (None on the
    CPU), and the torch and CUDA versions."""
    smi = None
    if not no_cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return {"device": "cpu" if no_cuda else "cuda", "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def main(argv=None):
    args = parse_arguments(sys.argv[1:] if argv is None else argv)
    if not args.no_cuda and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is visible; pass --no-cuda to "
                           "run the evidence legs on the CPU.")
    record = device_record(args.no_cuda)
    run_dir = os.path.join(RES_DIR, args.name)
    log_dir = os.path.join(args.out, "legs")
    os.makedirs(log_dir, exist_ok=True)
    seconds = {}
    for name, argv, suffix in legs(args):
        seconds[name] = run_leg(name, argv,
                                os.path.join(log_dir, name + ".log"))
        if suffix is not None:
            snapshot(run_dir, args.out, suffix)
    record.update(experiment=args.experiment, seed=args.seed,
                  train_flags=args.train_flags, leg_seconds=seconds)
    with open(os.path.join(args.out, "device.json"), "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    print("evidence set complete: {}".format(args.out), file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
