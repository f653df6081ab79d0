"""The port's zoo runs, held on the CPU to the JAX runs they are compared
with: chip_smoke.py phase 17's flags and phase 18's FactorVAE flags, and
the declared full-length runs of disvae_tpu_torch.zoo, parsed by the
port's CLI, give that run's specs.json in every field that defines it;
and the committed H100 sets of those runs against their JAX runs' gates."""

import json
import os
import sys

import pytest

from disvae_tpu_torch import cli, evidence, zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports only torch and numpy at the top)

FIELDS = ("dataset", "loss", "lr", "batch_size", "latent_dim", "model_type",
          "rec_dist", "reg_anneal", "precision", "seed", "betaH_B", "betaB_G",
          "betaB_initC", "betaB_finC")


@pytest.mark.parametrize("name, jax_run, gif", chip_smoke.ZOO_RUNS)
def test_zoo_flags_reproduce_the_jax_run(name, jax_run, gif):
    with open(os.path.join(REPO, "artifacts", jax_run, "specs.json")) as f:
        specs = json.load(f)
    args = cli.parse_arguments(chip_smoke.zoo_flags(name, jax_run, gif))
    for field in FIELDS:
        assert getattr(args, field) == specs[field], field
        assert type(getattr(args, field)) in (type(specs[field]), float), \
            field
    assert (args.name, args.epochs, args.experiment) == (name, 2, "custom")
    assert args.no_viz_gif is not gif


def test_zoo_covers_the_untested_losses_and_datasets():
    """The three runs train VAE, betaH and betaB once each, on mnist,
    fashion and chairs once each."""
    specs = [chip_smoke.zoo_specs(jax_run)
             for _, jax_run, _ in chip_smoke.ZOO_RUNS]
    assert sorted(s["loss"] for s in specs) == ["VAE", "betaB", "betaH"]
    assert sorted(s["dataset"] for s in specs) == ["chairs", "fashion",
                                                   "mnist"]
    assert set(chip_smoke.ZOO_DATA) == {"mnist", "fashion", "chairs"}


# The declared full-length runs of disvae_tpu_torch.zoo, each against the
# JAX run under artifacts/ that tests/test_artifacts.py gates.

N_TINY = {"mnist": 40, "fashion": 40, "chairs": 32}


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """Small fabricated mnist, fashion and chairs caches."""
    from tools import fabricate_chairs, fabricate_mnist
    root = tmp_path_factory.mktemp("data")
    for ds, n in N_TINY.items():
        argv = ["--root", str(root / ds), "--n", str(n)]
        if ds == "chairs":
            fabricate_chairs.main(argv)
        else:
            fabricate_mnist.main(argv + ["--dataset", ds])
    return root


def _trained_specs(argv, data_root, tmp_path, monkeypatch):
    """The specs.json the training CLI writes for `argv`: its parsed
    arguments after `build_trainer` (FactorVAE's doubling, the image
    size) on the small caches, through JSON."""
    import torch
    from disvae_tpu_torch.data import datasets
    monkeypatch.setattr(datasets, "DATA_ROOT", str(data_root))
    args = cli.parse_arguments(argv)
    cli.build_trainer(args, torch.device("cpu"), str(tmp_path), (0, 1))
    return args, json.loads(json.dumps(vars(args)))


@pytest.mark.parametrize("run", zoo.RUNS, ids=lambda r: r.name)
def test_zoo_evidence_run_gives_the_jax_runs_specs(run, tiny_data, tmp_path,
                                                   monkeypatch):
    """Each declared run's train leg, as the evidence CLI builds it from
    the zoo's argv, parsed by the port's CLI and through build_trainer,
    writes the JAX run's specs.json but for the name: loss, coefficients,
    lr and lr_disc, the batch and epochs after FactorVAE's doubling,
    rec_dist, reg_anneal, checkpoint_every, no_viz_gif, seed and
    precision among them."""
    ev = evidence.parse_arguments(zoo.evidence_argv(run, str(tmp_path)))
    assert (ev.name, ev.experiment, ev.seed, ev.final_convt,
            ev.profile_epoch, ev.skip_metrics) \
        == (run.name, run.experiment, 1234, "kernels", 1, True)
    args, specs = _trained_specs(evidence.train_cli_argv(ev), tiny_data,
                                 tmp_path, monkeypatch)
    ref = zoo.jax_specs(run)
    assert (specs.pop("name"), ref.pop("name")) == (run.name, run.jax_run)
    assert specs == ref
    for field in FIELDS + ("epochs", "checkpoint_every", "no_viz_gif",
                           "lr_disc", "factor_G", "experiment"):
        assert type(getattr(args, field)) in (type(ref[field]), float), \
            field


def test_zoo_runs_are_the_jax_package_full_length_runs():
    """The nine runs are tests/test_artifacts.py's full-length chairs and
    mnist/fashion runs, each named after its JAX run with `_h100`; the
    ones that are no `custom` run name their JAX run's experiment."""
    assert sorted(r.jax_run for r in zoo.RUNS) == sorted(
        list(JAX_GATE))
    for run in zoo.RUNS:
        assert run.name == run.jax_run.replace("_tpu", "_h100")
        assert run.experiment == zoo.jax_specs(run)["experiment"]
        assert bool(run.flags) == (run.experiment == "custom")


def test_phase18_factor_flags_give_the_jax_runs_specs(tiny_data, tmp_path,
                                                      monkeypatch):
    """chip_smoke.py phase 18's FactorVAE run trains with the settings of
    artifacts/factor_mnist_full_tpu/ but for the name, the experiment
    (`custom`) and the epochs: `-e 1`, doubled to 2, at b64 doubled to
    b128."""
    _, specs = _trained_specs(["-"] + chip_smoke.factor_evidence_flags(),
                              tiny_data, tmp_path, monkeypatch)
    ref = chip_smoke.zoo_specs(chip_smoke.FACTOR_EVIDENCE)
    for key in ("name", "experiment", "epochs"):
        specs.pop(key), ref.pop(key)
    assert specs == ref and specs["batch_size"] == 128


# tests/test_artifacts.py's gate of each JAX run: the lowest epoch-mean
# loss below `drop` times epoch 0's; the dataset's images
JAX_GATE = {"VAE_chairs_tpu": 0.45, "betaB_chairs_tpu": 0.47,
            "btcvae_chairs_tpu": 1 / 3, "VAE_mnist_full_tpu": 0.65,
            "betaH_fashion_full_tpu": 0.72, "betaH_mnist_tpu": 0.70,
            "betaB_mnist_tpu": 0.55, "btcvae_mnist_tpu": 0.0,
            "factor_mnist_full_tpu": 0.40}
N_IMAGES = {"chairs": 86366, "mnist": 60000, "fashion": 60000}
# the last epoch's mean recon_loss and kl_loss against the JAX run's
RECON_TOL, KL_TOL = 0.02, 0.15
# K1's and K2's executions per optimizer step (FactorVAE's included: only
# the first half batch goes through the decoder)
CONVT_PER_STEP = 1
# the declared sets that met the gate, committed as artifacts/<name>/
COMMITTED = ["VAE_chairs_h100", "btcvae_chairs_h100", "VAE_mnist_full_h100",
             "betaH_fashion_full_h100", "betaH_mnist_h100", "btcvae_mnist_h100",
             "factor_mnist_full_h100"]
PLOTS = ("samples.png", "data_samples.png", "reconstruct.png",
         "prior_traversals.png", "reconstruct_traverse.png",
         "posterior_traversals.gif", "test_losses.log", "MANIFEST.txt")


def _means(path):
    """{(key, epoch): value} of a train_losses.log."""
    with open(path) as f:
        return {(k, int(e)): float(v) for e, k, v in
                (line.strip().split(",") for line in f.readlines()[1:])}


def test_committed_zoo_sets_are_the_ones_held():
    """Every zoo set under artifacts/ is one the gate test holds."""
    have = {d for d in os.listdir(os.path.join(REPO, "artifacts"))
            if d in zoo.BY_NAME}
    assert have == set(COMMITTED)


@pytest.mark.parametrize("name", COMMITTED)
def test_h100_zoo_set_meets_the_jax_runs_gate(name):
    """A declared zoo run on the H100 with K1/K2 in every step, against
    the gate fixed before it ran: (1) its JAX run's own gate
    (tests/test_artifacts.py): every plot it lists, test_losses.log and
    MANIFEST.txt, the specs' epochs, dataset and loss, every epoch in
    train_losses.log, the lowest epoch loss below `drop` times epoch 0's,
    an animated posterior gif; (2) the JAX run's specs.json but for the
    name; (3) the last epoch's recon_loss within 2% and kl_loss within
    15% of the JAX run's; (4) device.json naming an H100 and `kernels`,
    the resident feed and a replayed graph, the optimizer steps of the
    whole run, K1's and K2's executions equal to them and, in the
    profiled epoch, to its steps."""
    from PIL import Image
    run = zoo.BY_NAME[name]
    d = os.path.join(REPO, "artifacts", name)
    ref_dir = os.path.join(REPO, "artifacts", run.jax_run)
    for f in PLOTS:
        assert os.path.exists(os.path.join(d, f)), f
    with open(os.path.join(d, "specs.json")) as f:
        spec = json.load(f)
    ref = zoo.jax_specs(run)
    n_epochs = ref["epochs"]
    assert (spec["epochs"], spec["dataset"], spec["loss"]) \
        == (n_epochs, ref["dataset"], ref["loss"])
    ours = _means(os.path.join(d, "train_losses.log"))
    loss = {e: v for (k, e), v in ours.items() if k == "loss"}
    assert sorted(loss) == list(range(n_epochs))
    assert min(loss.values()) < JAX_GATE[run.jax_run] * loss[0], \
        (loss[0], min(loss.values()))
    with Image.open(os.path.join(d, "posterior_traversals.gif")) as im:
        assert getattr(im, "n_frames", 1) > 1
    assert spec.pop("name") == name and ref.pop("name") == run.jax_run
    assert spec == ref
    theirs = _means(os.path.join(ref_dir, "train_losses.log"))
    last = n_epochs - 1
    for key, tol in (("recon_loss", RECON_TOL), ("kl_loss", KL_TOL)):
        assert abs(ours[key, last] - theirs[key, last]) \
            <= tol * abs(theirs[key, last]), key
    with open(os.path.join(d, "device.json")) as f:
        device = json.load(f)
    leg = device["train_leg"]
    steps = n_epochs * -(-N_IMAGES[ref["dataset"]] // ref["batch_size"])
    assert "H100" in device["nvidia_smi"]
    assert device["final_convt"] == leg["final_convt"] == "kernels"
    assert leg["resident"] and leg["graph"]["replayed_steps"] > 0
    assert leg["steps"] == steps
    prof = leg["profiled_epoch"]
    assert prof["steps"] == steps // n_epochs
    for k in ("convt3_dw", "convt3_dx"):
        assert leg[k]["executions"] == CONVT_PER_STEP * steps, k
        assert prof[k] == CONVT_PER_STEP * prof["steps"], k


def test_zoo_runner_on_the_cpu(tmp_path):
    """`python -m disvae_tpu_torch.zoo VAE_mnist_full_h100 --no-cuda` on a
    fabricated mnist of 64 images (one b64 step an epoch, 400 epochs):
    the evidence set with its plots, test losses and device.json, and the
    summary line, which `--report` prints again from the set."""
    import subprocess
    from tools import fabricate_mnist
    fabricate_mnist.main(["--root", str(tmp_path / "data" / "mnist"),
                          "--n", "64"])
    env = dict(os.environ, DISVAE_DATA_ROOT=str(tmp_path / "data"),
               PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    argv = [sys.executable, "-m", "disvae_tpu_torch.zoo"]
    proc = subprocess.run(argv + ["VAE_mnist_full_h100", "--out",
                                  str(tmp_path / "out"), "--no-cuda"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "out" / "VAE_mnist_full_h100"
    assert set(PLOTS) | {"device.json", "specs.json", "train_losses.log",
                         "legs"} <= set(os.listdir(out))
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (summary["name"], summary["jax_run"], summary["steps"],
            summary["final_convt"], summary["profiled_epoch"]) \
        == ("VAE_mnist_full_h100", "VAE_mnist_full_tpu", 400, "kernels", 1)
    assert summary["jax_last_recon_loss"] > 0 and summary["step_ms"] > 0
    report = subprocess.run(argv + ["--report", str(out)], cwd=str(tmp_path),
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert json.loads(report.stdout) == summary
