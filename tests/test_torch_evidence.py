"""`python -m disvae_tpu_torch.evidence` on the CPU: all four legs through
the port's CLIs on a small fabricated dsprites lattice, the snapshot they
leave, a failing leg, `--init-from`, and `--final-convt` with its counts
on a small fabricated celeba cache; and the port's committed H100
evidence sets (artifacts/btcvae_dsprites_h100/, and the btcvae_celeba
flagship's) against the JAX runs' gates.

The lattice is (shape, scale, orientation, posX, posY) = (3, 2, 2, 4, 4),
192 images, with the dsprites latents columns and the file that names its
factor sizes, so that the port's DSprites scores it on them.
"""

from torch_threads import child_env  # first: the thread budget

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disvae_tpu.utils.viz_helpers import read_loss_from_file

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.data.synthetic import render_factor_lattice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EVIDENCE = os.path.join(REPO, "artifacts", "btcvae_dsprites_tpu")
LAT_SIZES = (3, 2, 2, 4, 4)
LEGS = ["train", "metrics-reference-faithful", "metrics-corrected", "viz"]


def _fabricate(root, lat_sizes=LAT_SIZES):
    """A dsprites cache of the reduced lattice: images in row-major factor
    order, the (color, shape, scale, orientation, posX, posY) latents of
    each, and the lattice's factor sizes."""
    os.makedirs(root)
    imgs = render_factor_lattice(lat_sizes)
    grid = np.stack(np.meshgrid(*[np.arange(n, dtype=np.float32)
                                  for n in lat_sizes], indexing="ij"), -1)
    latents = np.concatenate([np.ones((len(imgs), 1), np.float32),
                              grid.reshape(len(imgs), -1)], 1)
    np.save(os.path.join(root, "dsprites_imgs.npy"), imgs)
    np.save(os.path.join(root, "dsprites_latents.npy"), latents)
    with open(os.path.join(root, PD.LAT_SIZES_FILE), "w") as f:
        json.dump(list(lat_sizes), f)


def _evidence(tmp_path, *argv, cwd=None):
    """The evidence CLI on the caches under tmp_path/data, run in `cwd`
    (default tmp_path)."""
    env = child_env(DISVAE_DATA_ROOT=str(tmp_path / "data"), PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "disvae_tpu_torch.evidence"] + list(argv),
        cwd=str(cwd or tmp_path), env=env, capture_output=True, text=True,
        timeout=600)


def test_reduced_lattice_is_scored_on_its_own_sizes(tmp_path):
    """A cache that names its factor sizes is scored on them; one that
    names none keeps dsprites' sizes, and scoring it raises unless it
    holds the whole lattice (a cache cut at a factor boundary included);
    sizes that are no lattice of the image count raise."""
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.train.evaluate import Evaluator
    _fabricate(str(tmp_path / "lattice"))
    assert tuple(PD.DSprites(root=str(tmp_path / "lattice")).lat_sizes) \
        == LAT_SIZES
    root = tmp_path / "cut"
    _fabricate(str(root))
    os.remove(root / PD.LAT_SIZES_FILE)
    ds = PD.DSprites(root=str(root))
    assert tuple(ds.lat_sizes) == (3, 6, 40, 32, 32)
    model = init_specific_model("Burgess", (1, 64, 64), 10,
                                generator=torch.Generator().manual_seed(0))
    evaluator = Evaluator(model, get_loss_f(
        "btcvae", rec_dist="bernoulli", reg_anneal=0, btcvae_A=1,
        btcvae_B=6, btcvae_G=1, n_data=len(ds)), save_dir=str(tmp_path))
    with pytest.raises(ValueError, match="not the 737280 of its factor"):
        evaluator.compute_metrics(PD.DataLoader(ds, batch_size=64))
    (root / PD.LAT_SIZES_FILE).write_text(json.dumps([3, 2, 2, 4, 2]))
    with pytest.raises(ValueError, match="factor sizes"):
        PD.DSprites(root=str(root))


N_MNIST = 408  # 25 b16 steps and a ragged tail of 8 per epoch: 52 steps,
# so that each epoch holds a step the log records (one in 50)


@pytest.mark.parametrize("loss", ["btcvae", "factor"])
def test_evidence_cli_on_the_cpu(tmp_path, loss):
    """btcvae: the four legs on 192 dsprites images (1 epoch at b16): the
    output holds every file of the JAX run's evidence set, the JAX
    package's reader parses its train_losses.log, both metric logs are
    {MIG, AAM} in [0, 1], and device.json records the CPU and each leg's
    seconds. factor: the train and viz legs (mnist has no factors for the
    metric legs) of FactorVAE on a fabricated mnist of 408 images, `-e 1
    -b 8`, with `--final-convt kernels --profile-epoch 1`: the CLI doubles
    them to 2 epochs at b16, the log holds the discriminator's rows in
    both, and device.json's steps are the doubled run's, with one call of
    K1/K2's route a step."""
    if loss == "factor":
        return _factor_evidence(tmp_path)
    _fabricate(str(tmp_path / "data" / "dsprites"))
    out = tmp_path / "evidence"
    proc = _evidence(tmp_path, "tiny", "custom", "-s", "3", "--out",
                     str(out), "--no-cuda", "--train-flags",
                     "-d dsprites -l btcvae -e 1 -b 16")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "evidence set complete" in proc.stderr
    have = set(os.listdir(out))
    assert set(os.listdir(JAX_EVIDENCE)) <= have, \
        set(os.listdir(JAX_EVIDENCE)) - have
    assert {"device.json", "legs"} <= have
    assert sorted(os.listdir(out / "legs")) == sorted(
        [l + ".log" for l in LEGS] + ["train.json"])
    spec = json.loads((out / "specs.json").read_text())
    assert (spec["dataset"], spec["loss"], spec["epochs"],
            spec["batch_size"], spec["seed"]) == ("dsprites", "btcvae", 1,
                                                  16, 3)
    kls = read_loss_from_file(str(out / "train_losses.log"), "kl_loss_")
    assert len(kls) == spec["latent_dim"] and np.isfinite(kls).all()
    for mode in ("reference-faithful", "corrected"):
        metrics = json.loads((out / "metrics.{}.log".format(mode))
                             .read_text())
        assert set(metrics) == {"MIG", "AAM"}
        assert all(0 <= v <= 1 for v in metrics.values())
    manifest = (out / "MANIFEST.txt").read_text()
    assert "model.pt" in manifest and "metrics.log" in manifest
    device = json.loads((out / "device.json").read_text())
    assert device["device"] == "cpu" and device["nvidia_smi"] is None
    assert device["seed"] == 3 and device["init_from"] is None
    assert sorted(device["leg_seconds"]) == sorted(LEGS)
    assert all(v > 0 for v in device["leg_seconds"].values())


def _factor_evidence(tmp_path):
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "fabricate_mnist.py"),
                    "--root", str(tmp_path / "data" / "mnist"), "--n",
                    str(N_MNIST)], check=True, capture_output=True)
    out = tmp_path / "evidence"
    proc = _evidence(tmp_path, "tiny", "custom", "-s", "3", "--out",
                     str(out), "--no-cuda", "--skip-metrics",
                     "--final-convt", "kernels", "--profile-epoch", "1",
                     "--train-flags", "-d mnist -l factor -e 1 -b 8 "
                     "--precision default")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(out / "legs")) \
        == ["train.json", "train.log", "viz.log"]
    spec = json.loads((out / "specs.json").read_text())
    assert (spec["dataset"], spec["loss"], spec["epochs"],
            spec["batch_size"]) == ("mnist", "factor", 2, 16)
    rows = _log_rows(out / "train_losses.log")
    for key in ("loss", "discrim_loss", "tc_loss"):
        values = {e: float(v) for e, k, v in rows if k == key}
        assert sorted(values) == ["0", "1"], key
        assert np.isfinite(list(values.values())).all(), key
    device = json.loads((out / "device.json").read_text())
    leg = device["train_leg"]
    steps = 2 * -(-N_MNIST // 16)
    assert leg["steps"] == leg["convt3_bwd_calls"] == steps
    assert len(leg["epoch_images_per_sec"]) == 2
    assert (leg["profiled_epoch"]["epoch"], leg["profiled_epoch"]["steps"]) \
        == (1, steps // 2)
    assert sorted(device["leg_seconds"]) == ["train", "viz"]


def test_init_from_the_seeds_own_init_is_the_plain_run(tmp_path):
    """`--init-from` a directory holding the init the CLI draws at -s 3
    trains the plain -s 3 run bit for bit (2 epochs at b16 on the 192
    images): train_losses.log, model.pt and train_state.pt are the same
    bytes, and device.json names the directory and its weights' SHA-256."""
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.utils.helpers import derive_seeds
    from disvae_tpu_torch.utils.modelIO import save_model
    _fabricate(str(tmp_path / "data" / "dsprites"))
    init_dir = tmp_path / "seed3_init"
    os.makedirs(init_dir)
    save_model(init_specific_model(
        "Burgess", (1, 64, 64), 10,
        generator=torch.Generator().manual_seed(derive_seeds(3, 2)[0])),
        str(init_dir))
    runs = {}
    for kind, extra in (("plain", []), ("init", ["--init-from",
                                                 str(init_dir)])):
        cwd = tmp_path / kind
        os.makedirs(cwd)
        proc = _evidence(tmp_path, "tiny", "custom", "-s", "3", "--out",
                         str(cwd / "evidence"), "--no-cuda",
                         "--skip-metrics", "--train-flags",
                         "-d dsprites -l btcvae -e 2 -b 16", *extra,
                         cwd=cwd)
        assert proc.returncode == 0, proc.stderr[-3000:]
        train_argv = proc.stderr.split("== train: ")[1].split("\n")[0]
        assert ("--resume" in train_argv) == bool(extra)
        runs[kind] = cwd
    for f in ("train_losses.log", "model.pt", "train_state.pt"):
        plain, init = [(runs[k] / "results" / "tiny" / f).read_bytes()
                       for k in ("plain", "init")]
        assert plain == init, f
    device = json.loads((runs["init"] / "evidence" / "device.json")
                        .read_text())
    digest = hashlib.sha256((init_dir / "model.pt").read_bytes()).hexdigest()
    assert device["init_from"] == {"dir": str(init_dir),
                                   "weights": "model.pt", "sha256": digest}


@pytest.mark.parametrize("leg", ["train", "metrics-reference-faithful"])
def test_a_failing_leg_raises(tmp_path, leg):
    """A leg that exits non-zero stops the run with its name, its exit
    code and the tail of its log: the train leg without a dataset cache,
    and the first metrics leg on a cache that is no lattice (24 images,
    flat latents, no factor sizes)."""
    root = tmp_path / "data" / "dsprites"
    if leg != "train":
        os.makedirs(root)
        np.save(root / "dsprites_imgs.npy",
                render_factor_lattice(LAT_SIZES)[:24])
        np.save(root / "dsprites_latents.npy", np.zeros((24, 6), np.float32))
    proc = _evidence(tmp_path, "bad", "custom", "--out",
                     str(tmp_path / "evidence"), "--no-cuda",
                     "--train-flags", "-d dsprites -l btcvae -e 1 -b 8")
    assert proc.returncode != 0
    assert "LegFailed: leg {} exited with".format(leg) in proc.stderr
    assert "Traceback" in proc.stderr.split("LegFailed")[-1]
    assert not os.path.exists(tmp_path / "evidence" / "device.json")


H100_EVIDENCE = os.path.join(REPO, "artifacts", "btcvae_dsprites_h100")
JAX_INIT = os.path.join(REPO, "tests", "data",
                        "jax_init_btcvae_dsprites_s1234")


def _log_rows(path):
    with open(path) as f:
        return [line.strip().split(",") for line in f.readlines()[1:]]


def test_h100_evidence_set_meets_the_jax_runs_gate():
    """The port's declared btcvae_dsprites run on the H100, trained from
    the JAX run's own init, against the JAX run's gate: corrected MIG >
    0.25 and AAM > 0.4, and the last epoch's logged loss within 5% of the
    JAX run's; its specs (btcvae, dsprites, b64, 30 epochs, `highest`,
    seed 1234), 30 epochs logged, and device.json naming the committed
    init (by SHA-256) and an H100."""
    metrics = json.loads(open(os.path.join(
        H100_EVIDENCE, "metrics.corrected.log")).read())
    assert metrics["MIG"] > 0.25 and metrics["AAM"] > 0.4, metrics
    rows = _log_rows(os.path.join(H100_EVIDENCE, "train_losses.log"))
    ref = _log_rows(os.path.join(JAX_EVIDENCE, "train_losses.log"))
    assert sorted({int(r[0]) for r in rows}) == list(range(30))
    last = [float(v) for e, k, v in rows if e == "29" and k == "loss"]
    ref_last = [float(v) for e, k, v in ref if e == "29" and k == "loss"]
    assert abs(last[0] - ref_last[0]) <= 0.05 * abs(ref_last[0])
    spec = json.loads(open(os.path.join(H100_EVIDENCE,
                                        "specs.json")).read())
    assert (spec["loss"], spec["dataset"], spec["batch_size"],
            spec["epochs"], spec["precision"], spec["seed"]) \
        == ("btcvae", "dsprites", 64, 30, "highest", 1234)
    device = json.loads(open(os.path.join(H100_EVIDENCE,
                                          "device.json")).read())
    with open(os.path.join(JAX_INIT, "model.npz"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert device["init_from"]["sha256"] == digest
    assert os.path.normpath(device["init_from"]["dir"]) \
        == os.path.join("tests", "data", "jax_init_btcvae_dsprites_s1234")
    assert "H100" in device["nvidia_smi"] and device["seed"] == 1234


N_CELEBA = 72  # four b16 steps and a ragged tail of 8 per epoch (the
# viz leg draws 42 samples)
CELEBA_FLAGS = "-d celeba -l btcvae -e 2 -b 16 --precision default"


def _fabricate_celeba(tmp_path):
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "fabricate_celeba.py"),
                    "--root", str(tmp_path / "data" / "celeba"), "--n",
                    str(N_CELEBA)], check=True, capture_output=True)


def _train_leg_argv(stderr):
    return stderr.split("== train: ")[1].split("\n")[0].split()


@pytest.mark.parametrize("final_convt", ["cudnn", "kernels"])
def test_final_convt_sets_the_hook_in_the_train_leg_only(tmp_path,
                                                         final_convt):
    """`--final-convt kernels` runs the train leg through K1/K2's route,
    `convt_bwd.convt3_bwd`, once per optimizer step (on the CPU its plain
    version: no kernel launches, no graph), and `cudnn` never; the eval
    and viz legs carry no hook. device.json records the option, the
    steps, the counts, each epoch's images/sec and the profiled epoch
    (epoch 1: its five steps, no device events on the CPU)."""
    _fabricate_celeba(tmp_path)
    out = tmp_path / "evidence"
    proc = _evidence(tmp_path, "tiny", "custom", "-s", "5", "--out",
                     str(out), "--no-cuda", "--skip-metrics",
                     "--final-convt", final_convt, "--profile-epoch", "1",
                     "--train-flags", CELEBA_FLAGS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    train_argv = _train_leg_argv(proc.stderr)
    assert train_argv[1:4] == ["-m", "disvae_tpu_torch.evidence",
                               "train-leg"]
    assert train_argv[train_argv.index("--final-convt") + 1] == final_convt
    viz_argv = proc.stderr.split("== viz: ")[1].split("\n")[0]
    assert "--final-convt" not in viz_argv and "evidence" not in viz_argv
    device = json.loads((out / "device.json").read_text())
    leg = device["train_leg"]
    assert device["final_convt"] == leg["final_convt"] == final_convt
    assert leg == json.loads((out / "legs" / "train.json").read_text())
    steps = 2 * -(-N_CELEBA // 16)
    assert leg["steps"] == steps and leg["resident"] is True
    assert leg["graph"] is None  # the graph is the card's
    assert leg["convt3_bwd_calls"] == (steps if final_convt == "kernels"
                                       else 0)
    for k in ("convt3_dw", "convt3_dx"):
        assert leg[k] == {"launches": 0, "captured": 0, "executions": 0}
    assert len(leg["epoch_images_per_sec"]) == 2
    assert all(v > 0 for v in leg["epoch_images_per_sec"])
    prof = leg["profiled_epoch"]
    assert (prof["epoch"], prof["steps"]) == (1, steps // 2)
    assert (prof["convt3_dw"], prof["convt3_dx"]) == (0, 0)
    spec = json.loads((out / "specs.json").read_text())
    assert (spec["dataset"], spec["precision"], spec["epochs"]) \
        == ("celeba", "default", 2)


def test_default_final_convt_is_the_plain_cli_run_bit_for_bit(tmp_path):
    """Without `--final-convt` the train leg is `cudnn`, and it trains the
    run the training CLI trains on its own bit for bit: train_losses.log,
    model.pt and train_state.pt are the same bytes as those of `python -m
    disvae_tpu_torch` on the same argv."""
    _fabricate_celeba(tmp_path)
    runs = {}
    for kind in ("evidence", "cli"):
        cwd = tmp_path / kind
        os.makedirs(cwd)
        if kind == "evidence":
            proc = _evidence(tmp_path, "tiny", "custom", "-s", "5", "--out",
                             str(cwd / "evidence"), "--no-cuda",
                             "--skip-metrics", "--train-flags",
                             CELEBA_FLAGS, cwd=cwd)
            argv = _train_leg_argv(proc.stderr)
            cli_argv = argv[argv.index("--") + 1:]
            device = json.loads((cwd / "evidence" / "device.json")
                                .read_text())
            assert device["final_convt"] == "cudnn"
            assert device["train_leg"]["convt3_bwd_calls"] == 0
        else:
            env = child_env(DISVAE_DATA_ROOT=str(tmp_path / "data"),
                            PYTHONPATH=REPO)
            proc = subprocess.run(
                [sys.executable, "-m", "disvae_tpu_torch"] + cli_argv,
                cwd=str(cwd), env=env, capture_output=True, text=True,
                timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[kind] = cwd / "results" / "tiny"
    for f in ("train_losses.log", "model.pt", "train_state.pt"):
        assert (runs["evidence"] / f).read_bytes() \
            == (runs["cli"] / f).read_bytes(), f


def test_executions_count_each_captured_launch_once_per_replay():
    """A wrapper's executions: its launches outside a capture, plus each
    captured launch once per replayed step (an epoch of 16 eager steps, a
    capture of K = 16 and 40 replays, and 13 + 1 eager steps of the
    short super-step and the tail)."""
    from types import SimpleNamespace as NS
    from disvae_tpu_torch.evidence import _executions
    graph = NS(captured_steps=16, replayed_steps=640)
    assert _executions(NS(launches=16 + 16 + 14, captured=16), graph) \
        == 16 + 640 + 14
    assert _executions(NS(launches=0, captured=0), graph) == 0
    assert _executions(NS(launches=7, captured=0), None) == 7


FLAGSHIP = os.path.join(REPO, "artifacts", "btcvae_celeba_h100")
FLAGSHIP_CONTROL = os.path.join(REPO, "artifacts", "btcvae_celeba_h100_cudnn")
JAX_FLAGSHIP = os.path.join(REPO, "artifacts", "btcvae_celeba_tpu")
FLAGSHIP_STEPS = 200 * -(-202599 // 64)  # 3,165 full batches and a tail


def _epoch_mean(path, key, epoch):
    return np.mean([float(v) for e, k, v in _log_rows(path)
                    if k == key and int(e) == epoch])


def _flagship_record(d):
    with open(os.path.join(d, "device.json")) as f:
        return json.load(f)


def test_h100_flagship_set_meets_the_jax_flagship_gate():
    """The port's declared btcvae_celeba run on the H100 with K1/K2 in
    every step, against the gate fixed before it ran: the JAX flagship's
    own (tests/test_artifacts.py: every plot, 200 epochs and 3,200 rows,
    epoch 199's loss below epoch 0's less 150, its KL above 5, an animated
    posterior gif); epoch 199's loss and recon within 0.5% of the JAX
    run's and its loss within 0.3% of the cuDNN control's; device.json
    naming an H100 and `kernels`, with K1's and K2's executions equal to
    the optimizer steps over the run and to the profiled epoch's device
    events."""
    from PIL import Image
    for f in ("samples.png", "data_samples.png", "reconstruct.png",
              "prior_traversals.png", "reconstruct_traverse.png",
              "posterior_traversals.gif", "test_losses.log",
              "MANIFEST.txt"):
        assert os.path.exists(os.path.join(FLAGSHIP, f)), f
    spec = json.loads(open(os.path.join(FLAGSHIP, "specs.json")).read())
    assert spec["epochs"] == 200 and spec["dataset"] == "celeba"
    assert (spec["loss"], spec["batch_size"], spec["precision"],
            spec["seed"], spec["no_viz_gif"]) \
        == ("btcvae", 64, "default", 1234, True)
    log = os.path.join(FLAGSHIP, "train_losses.log")
    rows = _log_rows(log)
    assert len(rows) == 3200
    assert sorted({int(e) for e, k, _ in rows if k == "loss"}) \
        == list(range(200))
    first, last = (_epoch_mean(log, "loss", e) for e in (0, 199))
    assert last < first - 150, (first, last)
    assert _epoch_mean(log, "kl_loss", 199) > 5
    with Image.open(os.path.join(FLAGSHIP, "posterior_traversals.gif")) as im:
        assert getattr(im, "n_frames", 1) > 1
    jax_log = os.path.join(JAX_FLAGSHIP, "train_losses.log")
    for key in ("loss", "recon_loss"):
        ref = _epoch_mean(jax_log, key, 199)
        assert abs(_epoch_mean(log, key, 199) - ref) <= 0.005 * ref, key
    control = _epoch_mean(os.path.join(FLAGSHIP_CONTROL, "train_losses.log"),
                          "loss", 199)
    assert abs(last - control) <= 0.003 * control
    device = _flagship_record(FLAGSHIP)
    leg = device["train_leg"]
    assert "H100" in device["nvidia_smi"]
    assert device["final_convt"] == leg["final_convt"] == "kernels"
    assert leg["steps"] == FLAGSHIP_STEPS and leg["resident"]
    assert leg["graph"]["replayed_steps"] > 0
    prof = leg["profiled_epoch"]
    for k in ("convt3_dw", "convt3_dx"):
        assert leg[k]["executions"] == FLAGSHIP_STEPS, k
        assert prof[k] == prof["steps"] == FLAGSHIP_STEPS // 200, k


def test_h100_flagship_control_set_is_the_same_run_without_k1_k2():
    """The declared cuDNN control: the hooked run's specs but for the
    name, `cudnn` in device.json, no K1 or K2 launch or execution over
    the run or in its profiled epoch, the same optimizer steps, and the
    200 logged epochs of the JAX flagship's log."""
    specs = [json.loads(open(os.path.join(d, "specs.json")).read())
             for d in (FLAGSHIP, FLAGSHIP_CONTROL)]
    for spec in specs:
        spec.pop("name")
    assert specs[0] == specs[1]
    device = _flagship_record(FLAGSHIP_CONTROL)
    leg = device["train_leg"]
    assert "H100" in device["nvidia_smi"]
    assert device["final_convt"] == leg["final_convt"] == "cudnn"
    assert leg["steps"] == FLAGSHIP_STEPS and leg["convt3_bwd_calls"] == 0
    for k in ("convt3_dw", "convt3_dx"):
        assert leg[k] == {"launches": 0, "captured": 0, "executions": 0}
        assert leg["profiled_epoch"][k] == 0
    rows = _log_rows(os.path.join(FLAGSHIP_CONTROL, "train_losses.log"))
    assert len(rows) == 3200
    assert {r[1] for r in rows} == {r[1] for r in _log_rows(os.path.join(
        JAX_FLAGSHIP, "train_losses.log"))}
