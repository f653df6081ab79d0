#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference path once on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU carry-on):

1. Device: the card's name and power limit (nvidia-smi), the `highest`
   float32 policy (TF32 off for matmuls and cuDNN convs).
2. Build: the log_qz CUDA kernel from disvae_tpu_torch/csrc/log_qz.cu
   (nvcc, into build/disvae_tpu_torch/), with its compile time.
3. Kernel vs plain PyTorch at the MIG/AAM sweeps' real shapes (marginal
   L=1, M=737,280; conditional L=3, M=245,760 and L=32, M=23,040; D=10,
   S=2,000): max |kernel - plain| <= 1e-4, both times (CUDA events, warm,
   median).
4. Main path: the full 737,280-image dsprites lattice fabricated with
   tools/fabricate_dsprites.py, a seeded-init Burgess 64x64x1 latent-10
   checkpoint written with the port's save_model, then the port's CLI
   `<name> --is-eval-only --is-metrics -l btcvae`. Checks finite MIG,
   AAM and test losses in metrics.log / test_losses.log and that the run
   launched the log_qz kernel. Then the entropy estimate on a 4,096-image
   subset, kernel on the GPU against the plain version on the CPU.
5. Serving: ServingModel.from_dir answers encode (1, 7, 57 images),
   decode, reconstruct and sample(8).

Its last two lines are JSON: the kernels' record, then
{"ok": true, "device": {...}}. Scratch data lives under build/ and is
removed at the end.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
ATOL = 1e-4  # log-density bound of tests/test_metrics.py (kernel vs scan)
# (L, M, D, S) of the entropy sweeps at dsprites scale
KERNEL_SHAPES = [(1, 737280, 10, 2000), (3, 245760, 10, 2000),
                 (32, 23040, 10, 2000)]


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps):
    """Median device time of `fn` over `reps` warm runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    from disvae_tpu_torch.ops.precision import configure
    configure("highest")
    log("device: {} x{} (torch {}, CUDA {})".format(
        torch.cuda.get_device_name(0), torch.cuda.device_count(),
        torch.__version__, torch.version.cuda))


def phase_build(K):
    t0 = time.perf_counter()
    path, compiler_log = K.build()
    log("build: {} in {:.2f} s".format(os.path.relpath(path, REPO),
                                       time.perf_counter() - t0))
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


def phase_kernels(K):
    """Kernel vs plain at the sweeps' real shapes. Returns the kernel
    record (the marginal shape's times, the largest error)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    errs, record = [], None
    for L, M, D, S in KERNEL_SHAPES:
        mu = torch.from_numpy(rng.standard_normal((L, M, D), np.float32))
        logvar = torch.from_numpy(
            0.3 * rng.standard_normal((L, M, D), np.float32))
        values = torch.from_numpy(rng.standard_normal((L, D, S), np.float32))
        mu, logvar, values = (t.to(dev) for t in (mu, logvar, values))
        got = K.log_qz(values, mu, logvar)
        ref = K.log_qz_plain(values, mu, logvar)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not (torch.isfinite(got).all().item() and err <= ATOL):
            raise AssertionError("log_qz kernel vs plain at {}: max abs err "
                                 "{} > {}".format((L, M, D, S), err, ATOL))
        ms = time_ms(lambda: K.log_qz(values, mu, logvar), 5)
        plain_ms = time_ms(lambda: K.log_qz_plain(values, mu, logvar), 3)
        n = L * M * D * S
        log("log_qz L={} M={} D={} S={}: max_abs_err {:.3e}, kernel {:.3f} "
            "ms ({:.1f} G log-densities/s), plain {:.3f} ms".format(
                L, M, D, S, err, ms, n / ms / 1e6, plain_ms))
        errs.append(err)
        if record is None:
            record = {"ms": ms, "plain_ms": plain_ms}
        del mu, logvar, values, got, ref
        torch.cuda.empty_cache()
    record["max_abs_err"] = max(errs)
    return record


def phase_main_path(K, scratch):
    root = os.path.join(scratch, "data")
    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "fabricate_dsprites.py"),
                    "--root", os.path.join(root, "dsprites")],
                   check=True, stdout=subprocess.DEVNULL)
    log("fabricated the 737,280-image dsprites lattice in {:.1f} s".format(
        time.perf_counter() - t0))
    os.environ["DISVAE_DATA_ROOT"] = root
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.data import datasets
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.utils.modelIO import load_metadata, save_model
    if datasets.DATA_ROOT != root:
        raise AssertionError("the dataset module was imported before "
                             "DISVAE_DATA_ROOT was set")

    name = "chip_smoke_btcvae_dsprites"
    exp_dir = os.path.join(scratch, cli.RES_DIR, name)
    os.makedirs(exp_dir)
    model = init_specific_model("Burgess", (1, 64, 64), 10,
                                generator=torch.Generator().manual_seed(SEED))
    save_model(model, exp_dir, metadata=dict(
        dataset="dsprites", img_size=[1, 64, 64], latent_dim=10,
        model_type="Burgess", loss="btcvae"))

    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        K.log_qz.launches = 0
        t0 = time.perf_counter()
        evaluator = cli.main(cli.parse_arguments(
            [name, "--is-eval-only", "--is-metrics", "-l", "btcvae",
             "--no-progress-bar", "-s", str(SEED)]))
        seconds = time.perf_counter() - t0
        launches = K.log_qz.launches
    finally:
        os.chdir(cwd)

    metrics = load_metadata(exp_dir, filename="metrics.log")
    losses = load_metadata(exp_dir, filename="test_losses.log")
    timings = evaluator.last_metrics_timings
    helpers = evaluator.last_metrics_internals
    log("eval CLI: {:.1f} s total; encode {:.2f} s, entropies {:.2f} s; "
        "log_qz launches {}".format(seconds, timings["encode_seconds"],
                                    timings["entropy_seconds"], launches))
    log("metrics.log: {}".format(json.dumps(metrics, sort_keys=True)))
    log("test_losses.log: loss {loss}, recon_loss {recon_loss}, mi_loss "
        "{mi_loss}, tc_loss {tc_loss}, dw_kl_loss {dw_kl_loss}".format(
            **losses))
    if launches <= 0:
        raise AssertionError("the eval run never launched the log_qz kernel")
    if not all(math.isfinite(v) for v in list(metrics.values())
               + list(losses.values())):
        raise AssertionError("non-finite metrics or losses")
    if not (0 <= metrics["MIG"] <= 1 and 0 <= metrics["AAM"] <= 1):
        raise AssertionError("MIG/AAM outside [0, 1]: {}".format(metrics))
    if helpers["marginal_entropies"].shape != (10,) \
            or helpers["cond_entropies"].shape != (5, 10):
        raise AssertionError("unexpected entropy shapes")
    subset_check(evaluator.model, datasets)
    return exp_dir, datasets, launches


def subset_check(model, datasets):
    """Marginal entropies of a 4,096-image subset: the GPU evaluator
    (kernel) against the CPU evaluator (plain version) on the same
    weights and draws."""
    import copy
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.train.evaluate import Evaluator
    ds = datasets.get_dataset("dsprites")()
    sub = datasets.ArrayDataset(ds.imgs[::180][:4096] * 255)
    loss = get_loss_f("VAE", rec_dist="bernoulli", reg_anneal=0)
    H = {}
    for dev, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu())):
        ev = Evaluator(m, loss, save_dir=".", metrics_seed=SEED)
        samples, params = ev._compute_q_zCx(
            datasets.DataLoader(sub, batch_size=1000))
        H[dev] = ev._estimate_latent_entropies(samples, params)
    err = float(np.abs(H["cuda"] - H["cpu"]).max())
    log("subset entropies (4,096 images): GPU kernel vs CPU plain max abs "
        "diff {:.3e}".format(err))
    if not (np.isfinite(H["cuda"]).all() and err <= ATOL):
        raise AssertionError("subset entropies disagree: {}".format(err))


def phase_serving(exp_dir, datasets):
    from disvae_tpu_torch.serve import ServingModel
    sm = ServingModel.from_dir(exp_dir, device="cuda")
    ds = datasets.get_dataset("dsprites")()
    rng = np.random.default_rng(SEED)
    for n in (1, 7, 57):
        x, _ = ds.get_batch(np.sort(rng.choice(len(ds), n, replace=False)))
        ms = []
        for _ in range(2):  # the first request of a size picks cuDNN algos
            t0 = time.perf_counter()
            mu, logvar = sm.encode(x)
            rec = sm.decode(mu)
            both = sm.reconstruct(x)
            ms.append((time.perf_counter() - t0) * 1e3)
        if mu.shape != (n, 10) or logvar.shape != (n, 10) \
                or rec.shape != (n, 64, 64, 1):
            raise AssertionError("serving shapes at n={}".format(n))
        if not (np.isfinite(mu).all() and np.isfinite(logvar).all()
                and ((rec >= 0) & (rec <= 1)).all()):
            raise AssertionError("serving values at n={}".format(n))
        if not np.array_equal(both, rec):
            raise AssertionError("reconstruct(x) != decode(encode(x).mu) at "
                                 "n={}".format(n))
        log("serve n={}: encode + decode + reconstruct {:.2f} ms first, "
            "{:.2f} ms again".format(n, *ms))
    samples = sm.sample(8, seed=SEED)
    if samples.shape != (8, 64, 64, 1) or not np.isfinite(samples).all():
        raise AssertionError("sample(8)")
    log("serve sample(8): ok")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from disvae_tpu_torch.ops import log_qz as K

    phase_device()
    phase_build(K)
    record = phase_kernels(K)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    try:
        exp_dir, datasets, launches = phase_main_path(K, scratch)
        phase_serving(exp_dir, datasets)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    log(json.dumps({"kernels": [dict(
        name="log_qz", route="cuda",
        source="disvae_tpu_torch/csrc/log_qz.cu",
        replaces="disvae_tpu/ops/pallas_kernels.py:44",
        launches=launches, max_abs_err=record["max_abs_err"],
        ms=record["ms"], plain_ms=record["plain_ms"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
