"""Drive a complete evidence set for one predefined experiment through the
port's own CLIs, then snapshot it into an output directory.

    python -m disvae_tpu_torch.evidence <name> <experiment> [-s SEED]
        --out DIR [--train-flags "..."] [--init-from DIR] [--skip-metrics]
        [--final-convt {cudnn,kernels}] [--profile-epoch E] [--no-cuda]

Counterpart of tools/evidence_run.sh and tools/snapshot_artifacts.sh. The
legs run as subprocesses, in the current directory (the run lands in
`results/<name>/`), in this order:

1. train: the training CLI's `parse_arguments` and `main` on `<name> -x
   <experiment> --no-progress-bar -s <seed> <train flags>` (then the test
   losses), in a process of this module (`train_leg`) that sets the final
   decoder convT's backward first;
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

`--final-convt` picks that backward for the train leg alone (the other
legs run no backward): `cudnn`, the default, keeps `F.conv_transpose2d`'s
own; `kernels` hands `burgess.set_final_convt_impl` the K1/K2 wrapper
`convt_bwd.conv_transpose2d_pl`, whose backward launches K1 and K2 under
`--precision default`. The train leg writes DIR/legs/train.json, which
device.json takes as `train_leg`: the optimizer steps, the resident feed
and the CUDA graph's captured and replayed steps, each epoch's
images/sec, and per kernel its wrapper's launches, those made during a
capture, and its executions: the launches outside a capture, plus each
captured one once per replayed step. `convt3_bwd_calls` counts the
backward's calls through `convt_bwd.convt3_bwd` on either device (on the
CPU it takes the plain version and launches nothing). With
`--profile-epoch E` the E-th epoch the leg trains (from 0) runs under
torch.profiler (after a device synchronize, so that no earlier epoch's
work is in the window), and `profiled_epoch` holds its steps, K1's and
K2's executions among the device events, the device's busy seconds and
the kernels by device time.

`--init-from DIR` trains from the weights of the model saved in DIR (a
`model.pt`, or the JAX package's `model.npz`, with its `specs.json`)
instead of the init the CLI draws: before the train leg, `results/<name>/`
is created as the CLI creates it and given a step-0 `train_state.pt`
holding those weights and everything else as the CLI builds it at `-s
<seed>` (a fresh Adam, the training noise's generator, both step counters
at 0, next epoch 0); the train leg then runs with `--resume`. With the
seed's own init in DIR the run is the plain `-s <seed>` run, bit for bit.
`device.json` names DIR and the SHA-256 of its weights file under
`init_from` (null without the option).
"""

import argparse
import contextlib
import hashlib
import json
import os
import shlex
import shutil
import stat
import subprocess
import sys
import time

import torch

from disvae_tpu_torch import cli
from disvae_tpu_torch.cli import RES_DIR

# the package's parent directory: the legs import the package from here
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# files a complete run directory holds (tools/snapshot_artifacts.sh)
CANONICAL = ("specs.json", "train_losses.log", "test_losses.log",
             "metrics.log")
SNAPSHOT_SUFFIXES = (".json", ".log", ".png", ".gif")
TAIL_LINES = 40
FINAL_CONVT = ("cudnn", "kernels")
TRAIN_LEG = "train-leg"  # argv[0] of the train leg's process
TOP_KERNELS = 12  # the profiled epoch's kernels kept, by device time


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
    parser.add_argument("--init-from", metavar="DIR",
                        help="train from the weights of the model saved in "
                        "DIR (model.pt or model.npz, and specs.json)")
    parser.add_argument("--skip-metrics", action="store_true",
                        help="leave out both MIG/AAM legs")
    _final_convt_arguments(parser)
    parser.add_argument("--no-cuda", action="store_true",
                        help="run every leg on the CPU")
    return parser.parse_args(argv)


def _final_convt_arguments(parser):
    parser.add_argument("--final-convt", choices=FINAL_CONVT,
                        default="cudnn",
                        help="the final decoder convT's backward in the "
                        "train leg: F.conv_transpose2d's own (cudnn) or "
                        "K1/K2 (kernels, under --precision default)")
    parser.add_argument("--profile-epoch", type=int, metavar="E",
                        help="count K1/K2's device executions under "
                        "torch.profiler over the E-th epoch trained")


def train_cli_argv(args):
    """The train leg's argv for the training CLI."""
    return ([args.name, "-x", args.experiment, "--no-progress-bar", "-s",
             str(args.seed)] + shlex.split(args.train_flags)
            + (["--no-cuda"] if args.no_cuda else [])
            + (["--resume"] if args.init_from else []))


def legs(args):
    """[(leg name, argv, metrics suffix of the snapshot taken after it, or
    None for no snapshot)] in run order."""
    base = [sys.executable, "-m", "disvae_tpu_torch", args.name, "-x",
            args.experiment, "--no-progress-bar"]
    cuda = ["--no-cuda"] if args.no_cuda else []
    eval_only = base + ["--is-eval-only", "--is-metrics", "--no-test"] + cuda
    train = [sys.executable, "-m", "disvae_tpu_torch.evidence", TRAIN_LEG,
             "--final-convt", args.final_convt, "--record",
             os.path.join(args.out, "legs", "train.json")]
    if args.profile_epoch is not None:
        train += ["--profile-epoch", str(args.profile_epoch)]
    out = [("train", train + ["--"] + train_cli_argv(args), None)]
    if not args.skip_metrics:
        out += [("metrics-reference-faithful", eval_only,
                 "reference-faithful"),
                ("metrics-corrected", eval_only + ["--corrected-mig"],
                 "corrected")]
    # the last snapshot: metrics.log holds the corrected mode by then
    out.append(("viz", [sys.executable, "-m", "disvae_tpu_torch.cli_viz",
                        args.name, "all", "-s", "1"] + cuda, "corrected"))
    return out


def write_init_state(init_from, train_argv):
    """Create the train leg's run directory as its CLI would and write a
    step-0 train_state.pt into it: the weights of the model saved in
    `init_from`, and the rest of the state from the CLI's own Trainer build
    for `train_argv` (the leg's argv after `-m disvae_tpu_torch`, which
    resumes from this state). Returns `init_from`'s record for
    device.json."""
    from disvae_tpu_torch.data.datasets import get_img_size
    from disvae_tpu_torch.utils.helpers import (create_safe_directory,
                                                derive_seeds, get_device)
    from disvae_tpu_torch.utils.modelIO import (JAX_MODEL_FILENAME,
                                                MODEL_FILENAME, load_model)

    args = cli.parse_arguments(train_argv)
    args.resume = False  # there is nothing to resume from yet
    device = get_device(args.no_cuda)
    model = load_model(init_from, device=device).train()
    want = (args.model_type, get_img_size(args.dataset), args.latent_dim)
    have = (model.model_type, tuple(model.img_size), model.latent_dim)
    if have != want:
        raise ValueError("the model in {} is {}, the run trains {}".format(
            init_from, have, want))
    run_dir = os.path.join(RES_DIR, args.name)
    create_safe_directory(run_dir)
    _, trainer = cli.build_trainer(args, device, run_dir,
                                   derive_seeds(args.seed, 2), model=model)
    trainer.save_checkpoint(-1)  # next_epoch 0
    weights = next(f for f in (MODEL_FILENAME, JAX_MODEL_FILENAME)
                   if os.path.exists(os.path.join(init_from, f)))
    with open(os.path.join(init_from, weights), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"dir": init_from, "weights": weights, "sha256": digest}


def _device_events(prof):
    """The device events of a torch.profiler window, from its raw events:
    building its FunctionEvent tree for thousands of steps takes minutes.
    GPU-side annotation ranges span kernels and gaps: not device work."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]


def _busy_seconds(events):
    """The union of the events' intervals on the device, in seconds."""
    busy, end = 0, -1
    for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9


@contextlib.contextmanager
def _profiled_epoch(epoch, record):
    """Run the `epoch`-th epoch dispatch of the Trainer's resident feed in
    this process under torch.profiler, and fill `record` with its steps,
    K1's and K2's executions among the device events (their band
    kernels, whether launched or replayed in a graph), the device's busy
    seconds and the kernels by device time. No epoch: nothing."""
    if epoch is None:
        yield record
        return
    from disvae_tpu_torch.train.trainer import Trainer
    dispatch = Trainer._dispatch_epoch_resident
    seen = [0]

    def profiled(self, data_loader):
        n, seen[0] = seen[0], seen[0] + 1
        if n != epoch:
            return dispatch(self, data_loader)
        cuda = self.device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU]
        if cuda:
            torch.cuda.synchronize(self.device)
        step0, t0 = self.state.step, time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            out = dispatch(self, data_loader)
            if cuda:
                torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        events = _device_events(prof)
        by_name = {}
        for e in events:
            ns, calls = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), calls + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        record.update(
            epoch=epoch, steps=self.state.step - step0, seconds=seconds,
            convt3_dw=sum("convt3_dw_band" in e.name() for e in events),
            convt3_dx=sum("convt3_dx" in e.name() for e in events),
            device_busy_seconds=_busy_seconds(events),
            kernels=[[name, ns / 1e6, calls]
                     for name, (ns, calls) in top[:TOP_KERNELS]])
        return out

    Trainer._dispatch_epoch_resident = profiled
    try:
        yield record
    finally:
        Trainer._dispatch_epoch_resident = dispatch


def _executions(wrapper, graph):
    """A kernel wrapper's executions: its launches outside a capture ran
    once each, and each captured one runs once per replayed step of the
    graph (every capture records the same step)."""
    eager = wrapper.launches - wrapper.captured
    if not wrapper.captured:
        return eager
    return eager + wrapper.captured * graph.replayed_steps \
        // graph.captured_steps


def train_leg(argv):
    """The train leg's process: set the final decoder convT's backward,
    run the training CLI's `parse_arguments` and `main` on the argv after
    `--`, then write the leg's record (the optimizer steps, the feed, the
    graph, the K1/K2 counts, each epoch's images/sec and the profiled
    epoch) as JSON to `--record`."""
    parser = argparse.ArgumentParser(
        prog="python -m disvae_tpu_torch.evidence " + TRAIN_LEG)
    parser.add_argument("--record", required=True)
    _final_convt_arguments(parser)
    split = argv.index("--")
    opts = parser.parse_args(argv[:split])

    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops import convt_bwd
    from disvae_tpu_torch.train.steps import GraphedSuperStep
    if opts.final_convt == "kernels":
        burgess.set_final_convt_impl(convt_bwd.conv_transpose2d_pl)
    profiled = {}
    with _profiled_epoch(opts.profile_epoch, profiled):
        trainer, _ = cli.main(cli.parse_arguments(argv[split + 1:]))
    step = trainer._resident_step
    graph = step if isinstance(step, GraphedSuperStep) else None
    record = dict(
        final_convt=opts.final_convt, steps=trainer.state.step,
        resident=trainer.resident_data is not None,
        graph=None if graph is None else dict(
            k=graph.k, captured_steps=graph.captured_steps,
            replayed_steps=graph.replayed_steps),
        convt3_bwd_calls=convt_bwd.convt3_bwd.calls,
        epoch_images_per_sec=[e["images_per_sec"]
                              for e in trainer.epoch_stats],
        profiled_epoch=profiled or None)
    for wrapper in (convt_bwd.convt3_dw, convt_bwd.convt3_dx):
        record[wrapper.__name__] = dict(
            launches=wrapper.launches, captured=wrapper.captured,
            executions=_executions(wrapper, graph))
    with open(opts.record, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    return record


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
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == [TRAIN_LEG]:
        return train_leg(argv[1:])
    args = parse_arguments(argv)
    if not args.no_cuda and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is visible; pass --no-cuda to "
                           "run the evidence legs on the CPU.")
    record = device_record(args.no_cuda)
    run_dir = os.path.join(RES_DIR, args.name)
    log_dir = os.path.join(args.out, "legs")
    os.makedirs(log_dir, exist_ok=True)
    seconds = {}
    init_from = None
    if args.init_from:
        init_from = write_init_state(args.init_from, train_cli_argv(args))
    for name, leg_argv, suffix in legs(args):
        seconds[name] = run_leg(name, leg_argv,
                                os.path.join(log_dir, name + ".log"))
        if suffix is not None:
            snapshot(run_dir, args.out, suffix)
    with open(os.path.join(log_dir, "train.json")) as f:
        train = json.load(f)
    record.update(experiment=args.experiment, seed=args.seed,
                  init_from=init_from, train_flags=args.train_flags,
                  leg_seconds=seconds, final_convt=args.final_convt,
                  train_leg=train)
    with open(os.path.join(args.out, "device.json"), "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    print("evidence set complete: {}".format(args.out), file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
