"""The harness: BENCHMARK.json's shape, every name resolving to its
files, a cell added by files alone, the frozen counts, and no JAX.

    python -m pytest bench_port/tests -q
"""

import hashlib
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from tiny import BENCH_DIR, ROOT, restore_program, tiny_root

import harness
import roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_port"]
    assert b["command"][1].startswith("bench_port/")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits its 43,200 seconds
    assert ((2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"])
        assert c["file"].startswith("bench_port/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in b["workloads"]}
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _one_line(w["why"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        reported = harness.cell_metrics(b, cell, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.cell_metrics(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_resolves_to_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = harness.Cell(b, w["name"], 1, 1, False, torch.device("cpu"))
        try:
            driver = cell.driver()
            for fn in ("setup", "window", "release", "check"):
                assert callable(getattr(driver, fn))
            assert cell.limits and all(v > 0 for v in cell.limits.values())
            for key in ("peak_flops", "img_size", "latent_dim", "source",
                        "assumed", "reduced"):
                assert key in cell.config
            for m in (harness.cell_metrics(b, w["name"], False)
                      + harness.cell_metrics(b, w["name"], True)):
                assert callable(cell.reader(m["name"]).read)
        finally:
            cell.close()


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha1(fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, metric and limits, added as new
    files and entries in a copy, run on the CPU; no file there before is
    changed but BENCHMARK.json, which only gains entries."""
    root, bench = tiny_root(tmp_path)
    before = _digests(os.path.join(root, "bench_port"))
    b = os.path.join(root, "bench_port")
    with open(os.path.join(b, "configs", "btcvae_celeba.json")) as f:
        cfg = json.load(f)
    cfg.update(n_images=160, batch_size=4, img_size=[1, 32, 32],
               dataset="mnist", final_convt="plain")
    with open(os.path.join(b, "configs", "dummy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "train_short.json"), "w") as f:
        json.dump({"kind": "train_epochs", "min_epochs": 1,
                   "epoch_s": 1.0}, f)
    with open(os.path.join(b, "limits", "dummy_train.json"), "w") as f:
        json.dump({"loss_gap_step1": 1.0, "m_gap_median": 1.0,
                   "change_gap": 1.0}, f)
    with open(os.path.join(b, "metrics", "epochs_run.py"), "w") as f:
        f.write("def read(cell):\n    return cell.work.get('epochs')\n")
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "bench_port/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_train", "config": "dummy",
                               "traffic": "train_short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "epochs_run", "unit": "epochs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Trainer",
                               "moves": "train_images_per_s",
                               "workloads": ["dummy_train"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_images_per_s")["workloads"].append(
             "dummy_train")
    try:
        for trace in (False, True):
            result, checks = harness.run_cell(bench, "dummy_train", 5, 0.1,
                                              trace, torch.device("cpu"),
                                              root=root)
            assert result["correct"], checks
            assert result["attempted"] > 0
        assert result["metrics"]["epochs_run"]["value"] == 1
    finally:
        restore_program()
    after = _digests(os.path.join(root, "bench_port"))
    assert all(after[p] == d for p, d in before.items())


def test_frozen_counts_at_the_flagship_shapes():
    celeba, sprites = (3, 64, 64), (1, 64, 64)
    # encoder 7,279,616 and decoder 7,277,056 multiply-adds an image
    assert roofline.forward_flops(celeba, 10) == 2 * 14_556_672
    assert roofline.forward_flops(celeba, 10, "encoder.") == 2 * 7_279_616
    # forward, dgrad and wgrad, less conv1's dgrad (1,572,864 MACs)
    assert roofline.train_flops_per_image(celeba, 10) == 84_194_304
    # K1: x (64, 32, 32, 32) and dy (64, 3, 64, 64) in bf16, dW in f32
    assert roofline.k1_bytes(64, celeba) == 5_773_312
    assert roofline.k1_bound_s(64, celeba) == pytest.approx(1.7234e-6,
                                                            rel=1e-4)
    # K2: dy in bf16, w and dx in float32
    assert roofline.k2_bytes(64, celeba) == 9_967_616
    assert roofline.k2_bound_s(64, celeba) == pytest.approx(2.9754e-6,
                                                            rel=1e-4)
    # K3: 30 launches of 1.47456e10 log-densities, 35.53% of the exps on
    # the FMA pipe, 2.2733 ms each
    lat = [3, 6, 40, 32, 32]
    assert len(roofline.mig_sweeps(lat)) == 30
    assert roofline.mig_log_densities(lat, 10) == 30 * 737_280 * 10 * 2000
    assert roofline.fma_exp_share() == pytest.approx(0.35530, abs=1e-5)
    assert roofline.k3_bound_s(lat, 10) == pytest.approx(30 * 2.2733e-3,
                                                         rel=1e-4)
    # the eval's work: 12,462,080 FLOPs of encode an image, 6 a
    # log-density
    assert roofline.forward_flops(sprites, 10, "encoder.") == 12_462_080
    assert roofline.mig_eval_flops(lat, sprites, 10) == pytest.approx(
        737_280 * 12_462_080 + 6 * 4.42368e11)


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["disvae_tpu_torch", "disvae_tpu_torch.ops", "jaxtyping",
            "torch", "disvae_tpu.models", "jax.numpy", "flax"]
    assert harness.forbidden_modules(mods) == ["disvae_tpu.models", "flax",
                                               "jax.numpy"]


_PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {program!r}]
import torch
import harness
bench = harness.load_json({root!r} + "/BENCHMARK.json")
harness.run_cell(bench, {cell!r}, 3, 0.1, False, torch.device("cpu"),
                 root={root!r})
import reference.btcvae, reference.mig, reference.model  # noqa
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("cell", ["celeba_train", "dsprites_mig",
                                  "dsprites_mig_fast"])
def test_no_run_imports_jax_or_the_jax_package(tmp_path, cell):
    root, _ = tiny_root(tmp_path)
    code = _PROBE.format(bench=os.path.join(root, "bench_port"), root=root,
                         program=ROOT, cell=cell)
    env = dict(os.environ, PYTHONPATH=os.path.join(BENCH_DIR, "tests"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness.forbidden_modules(modules) == []


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {!r}); import reference.btcvae,"
            " reference.mig, reference.model, reference.seeds, json; "
            "print(json.dumps(sorted(sys.modules)))").format(BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "disvae_tpu", "disvae_tpu_torch")]


def test_a_run_without_the_program_fails_and_prints_nothing(tmp_path):
    root, _ = tiny_root(tmp_path)
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "celeba_train", "--seed", "1", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_beyond_32_bits():
    import inputs
    assert 0 <= inputs.seed32(2 ** 31 + 12345) < 2 ** 32
    assert math.isfinite(inputs.seed32(2 ** 40))
