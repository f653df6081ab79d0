"""The JAX package's full-length zoo runs that the port trains on the card,
and a runner that trains some of them through the evidence CLI.

    python -m disvae_tpu_torch.zoo <run> [<run> ...] --out DIR
        [--final-convt {kernels,cudnn}] [--no-cuda]
    python -m disvae_tpu_torch.zoo --report DIR [DIR ...]

Counterpart of tools/complete_zoo.sh. RUNS holds one entry per JAX run
under artifacts/<jax_run>/ that tests/test_artifacts.py gates at full
length: the port's run name, the experiment and the train flags that give
the JAX run's specs.json (tests/test_torch_zoo.py holds them to it). Each
named run is one `python -m disvae_tpu_torch.evidence <name> <experiment>
-s 1234 --out DIR/<name> --skip-metrics --final-convt kernels
--profile-epoch 1 --train-flags "--no-viz-gif --precision default
<flags>"`, run in the current directory, one at a time; with `cudnn` the
name and the output directory get a `_cudnn` suffix. The datasets the runs
need are fabricated first (tools/fabricate_chairs.py,
tools/fabricate_mnist.py) where the data root lacks their cache. A run
that fails is reported and the next one runs; the runner then exits 1.

After each run, and for every directory given to `--report`, one JSON line
summarizes the set beside its JAX run: the epoch-0 and last-epoch means of
loss, recon_loss and kl_loss (and their gaps to JAX's), the lowest epoch
loss over epoch 0's, the test loss, the optimizer steps, K1's and K2's
executions and the profiled epoch's device events, the legs' seconds, the
images/sec quartiles over the steady epochs (every epoch but epoch 0 and
the profiled one) and the step ms at their median, the device's busy ms a
step in the profiled epoch, with its share of that step, and how many
latents carry more than 1 nat of KL at epochs 0, 5, 10, 25, every 50th
and the last, beside JAX's. `--report` also reads sets of a run at
another seed, named `<run name without _h100>_s<seed>_h100`.
"""

import argparse
import collections
import json
import os
import re
import shlex
import statistics
import subprocess
import sys
import time

from disvae_tpu_torch.evidence import FINAL_CONVT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
SEED = 1234
# a latent is active in an epoch whose mean KL in it exceeds this (nats)
ACTIVE_NATS = 1.0
# what every run adds to its train leg, and to the evidence CLI
TRAIN_FLAGS = "--no-viz-gif --precision default"
EVIDENCE_FLAGS = ["--skip-metrics", "--profile-epoch", "1"]
# every setting of the two `custom` JAX runs but dataset and loss ([Custom]
# would train 100 epochs and checkpoint every 30)
_CUSTOM = ("-m Burgess -z 10 -r bernoulli -a 10000 -b 64 -e 400 "
           "--lr 0.0005 --checkpoint-every 100 ")

Run = collections.namedtuple("Run", "name experiment flags jax_run")

# In the order of the chip calls that run them: the chairs, then two
# groups of mnist/fashion.
RUNS = [
    Run("VAE_chairs_h100", "VAE_chairs", "", "VAE_chairs_tpu"),
    Run("betaB_chairs_h100", "betaB_chairs", "", "betaB_chairs_tpu"),
    Run("btcvae_chairs_h100", "btcvae_chairs", "", "btcvae_chairs_tpu"),
    Run("VAE_mnist_full_h100", "custom", _CUSTOM + "-d mnist -l VAE",
        "VAE_mnist_full_tpu"),
    Run("betaH_fashion_full_h100", "custom",
        _CUSTOM + "-d fashion -l betaH --betaH-B 4", "betaH_fashion_full_tpu"),
    Run("betaH_mnist_h100", "betaH_mnist", "", "betaH_mnist_tpu"),
    Run("betaB_mnist_h100", "betaB_mnist", "", "betaB_mnist_tpu"),
    Run("btcvae_mnist_h100", "btcvae_mnist", "", "btcvae_mnist_tpu"),
    Run("factor_mnist_full_h100", "factor_mnist", "", "factor_mnist_full_tpu"),
]
BY_NAME = {r.name: r for r in RUNS}

# dataset -> (fabricator under tools/, its flags, the cache it writes)
FABRICATORS = {
    "chairs": ("fabricate_chairs.py", [], "chairs_64.npy"),
    "mnist": ("fabricate_mnist.py", ["--dataset", "mnist"], "train32.npz"),
    "fashion": ("fabricate_mnist.py", ["--dataset", "fashion"],
                "train32.npz"),
}


def jax_specs(run):
    """The specs.json of the JAX run `run` is compared with."""
    with open(os.path.join(ARTIFACTS, run.jax_run, "specs.json")) as f:
        return json.load(f)


def train_flags(run):
    """The evidence CLI's --train-flags for `run`."""
    return " ".join(f for f in (TRAIN_FLAGS, run.flags) if f)


def set_name(run, final_convt="kernels"):
    """The name of `run`'s evidence set with `final_convt`."""
    return run.name + ("" if final_convt == "kernels" else "_" + final_convt)


def evidence_argv(run, out, final_convt="kernels", no_cuda=False):
    """The evidence CLI's argv (after `-m disvae_tpu_torch.evidence`) for
    `run`, its set written to `out`."""
    return ([set_name(run, final_convt), run.experiment, "-s", str(SEED),
             "--out", out]
            + EVIDENCE_FLAGS + ["--final-convt", final_convt,
                                "--train-flags", train_flags(run)]
            + (["--no-cuda"] if no_cuda else []))


def fabricate(datasets):
    """Fabricate each of `datasets` whose cache the data root lacks, at
    once; returns {dataset: seconds or None when it was there}."""
    from disvae_tpu_torch.data.datasets import DATA_ROOT
    procs, out, t0 = {}, {}, time.perf_counter()
    for ds in datasets:
        script, flags, cache = FABRICATORS[ds]
        root = os.path.join(DATA_ROOT, ds)
        out[ds] = None
        if not os.path.exists(os.path.join(root, cache)):
            procs[ds] = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tools", script),
                 "--root", root] + flags, stdout=subprocess.DEVNULL)
    for ds, p in procs.items():
        if p.wait():
            raise RuntimeError("fabricating {} exited {}".format(
                ds, p.returncode))
        out[ds] = time.perf_counter() - t0
    return out


def _epoch_means(path):
    """{key: {epoch: value}} of a train_losses.log."""
    out = collections.defaultdict(dict)
    with open(path) as f:
        for line in f.readlines()[1:]:
            epoch, key, value = line.strip().split(",")
            out[key][int(epoch)] = float(value)
    return out


def active_latents(means, epochs):
    """{epoch: how many latents carry more than ACTIVE_NATS of KL} at
    `epochs` (those the log has), from `_epoch_means`' kl_loss_<i>."""
    keys = [k for k in means if re.fullmatch(r"kl_loss_\d+", k)]
    return {e: sum(means[k][e] > ACTIVE_NATS for k in keys)
            for e in epochs if e in means["loss"]}


def summarize(out_dir, run=None):
    """The summary of the evidence set in `out_dir` beside its JAX run
    (`run`, or the RUNS entry its specs name, `_cudnn` and a seed's
    `_s<seed>` stripped)."""
    with open(os.path.join(out_dir, "specs.json")) as f:
        specs = json.load(f)
    run = run or BY_NAME[re.sub(r"_s\d+(?=_h100)", "", specs["name"]
                                .replace("_cudnn", ""))]
    ours = _epoch_means(os.path.join(out_dir, "train_losses.log"))
    ref = _epoch_means(os.path.join(ARTIFACTS, run.jax_run,
                                    "train_losses.log"))
    last = max(ours["loss"])
    s = dict(name=specs["name"], jax_run=run.jax_run, epochs=last + 1,
             min_loss_over_epoch0=min(ours["loss"].values())
             / ours["loss"][0])
    for key in ("loss", "recon_loss", "kl_loss"):
        for tag, epoch in (("epoch0", 0), ("last", last)):
            s["{}_{}".format(tag, key)] = ours[key][epoch]
            s["jax_{}_{}".format(tag, key)] = ref[key][epoch]
        s["last_{}_gap".format(key)] = (ours[key][last] / ref[key][last]
                                        - 1)
    epochs = sorted({0, 5, 10, 25, last} | set(range(50, last, 50)))
    s["active_latents"] = active_latents(ours, epochs)
    s["jax_active_latents"] = active_latents(ref, epochs)
    for tag, d in (("", out_dir), ("jax_", os.path.join(ARTIFACTS,
                                                         run.jax_run))):
        with open(os.path.join(d, "test_losses.log")) as f:
            s[tag + "test_loss"] = json.load(f)["loss"]
    with open(os.path.join(out_dir, "device.json")) as f:
        device = json.load(f)
    leg = device["train_leg"]
    prof = leg["profiled_epoch"] or {}
    ips = leg["epoch_images_per_sec"]
    steady = [v for i, v in enumerate(ips) if i not in (0, prof.get("epoch"))]
    quartiles = statistics.quantiles(steady, n=4) if len(steady) > 1 \
        else steady * 3
    # a batch at the median rate (the ragged tail is under 0.1% of these
    # epochs)
    step_ms = specs["batch_size"] / quartiles[1] * 1e3
    busy_ms = (prof["device_busy_seconds"] / prof["steps"] * 1e3
               if prof.get("steps") else None)
    s.update(
        nvidia_smi=device["nvidia_smi"], final_convt=device["final_convt"],
        steps=leg["steps"], resident=leg["resident"],
        replayed_steps=(leg["graph"] or {}).get("replayed_steps"),
        k1_executions=leg["convt3_dw"]["executions"],
        k2_executions=leg["convt3_dx"]["executions"],
        profiled_epoch=prof.get("epoch"), profiled_steps=prof.get("steps"),
        profiled_k1=prof.get("convt3_dw"), profiled_k2=prof.get("convt3_dx"),
        leg_seconds=device["leg_seconds"],
        images_per_sec_quartiles=quartiles, step_ms=step_ms,
        profiled_busy_ms=busy_ms,
        busy_share=busy_ms / step_ms if busy_ms is not None else None)
    return s


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m disvae_tpu_torch.zoo",
        description=__doc__.split("\n")[0])
    parser.add_argument("runs", nargs="*", metavar="RUN",
                        help="runs of RUNS, in turn: " + " ".join(BY_NAME))
    parser.add_argument("--out", help="directory the sets are written to")
    parser.add_argument("--final-convt", choices=FINAL_CONVT,
                        default="kernels")
    parser.add_argument("--no-cuda", action="store_true")
    parser.add_argument("--report", nargs="+", metavar="DIR",
                        help="summarize these evidence sets, run nothing")
    args = parser.parse_args(argv)
    if args.report:
        for d in args.report:
            print(json.dumps(summarize(d)), flush=True)
        return 0
    if not args.runs or not args.out:
        parser.error("name the runs and --out, or --report sets")
    unknown = [n for n in args.runs if n not in BY_NAME]
    if unknown:
        parser.error("unknown runs: {}".format(" ".join(unknown)))
    runs = [BY_NAME[n] for n in args.runs]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    seconds = fabricate(sorted({jax_specs(r)["dataset"] for r in runs}))
    print("zoo: fabricated {}".format(seconds), file=sys.stderr, flush=True)
    failed = []
    for run in runs:
        out = os.path.join(args.out, set_name(run, args.final_convt))
        cmd = evidence_argv(run, out, args.final_convt, args.no_cuda)
        print("zoo: {} ({})".format(cmd[0], shlex.join(cmd)),
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m",
                             "disvae_tpu_torch.evidence"] + cmd,
                            env=env).returncode
        print("zoo: {} exited {} after {:.1f} s".format(
            cmd[0], rc, time.perf_counter() - t0), file=sys.stderr,
            flush=True)
        if rc:
            failed.append(cmd[0])
            continue
        print(json.dumps(summarize(out, run)), flush=True)
    if failed:
        print("zoo: failed: {}".format(" ".join(failed)), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
