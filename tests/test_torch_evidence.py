"""`python -m disvae_tpu_torch.evidence` on the CPU: all four legs through
the port's CLIs on a small fabricated dsprites lattice, the snapshot they
leave, a failing leg, and `--init-from`; and the port's committed H100
evidence set (artifacts/btcvae_dsprites_h100/) against the JAX run's
gate.

The lattice is (shape, scale, orientation, posX, posY) = (3, 2, 2, 4, 4),
192 images, with the dsprites latents columns and the file that names its
factor sizes, so that the port's DSprites scores it on them.
"""

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
    env = dict(os.environ, DISVAE_DATA_ROOT=str(tmp_path / "data"),
               PYTHONPATH=REPO, OMP_NUM_THREADS="2")
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


def test_evidence_cli_on_the_cpu(tmp_path):
    """The four legs on 192 images (1 epoch at b16): the output holds every
    file of the JAX run's evidence set, the JAX package's reader parses its
    train_losses.log, both metric logs are {MIG, AAM} in [0, 1], and
    device.json records the CPU and each leg's seconds."""
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
    assert sorted(os.listdir(out / "legs")) == sorted(l + ".log"
                                                      for l in LEGS)
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
