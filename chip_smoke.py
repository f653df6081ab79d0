#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference and training paths once on one
GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU carry-on):

1. Device: the card's name and power limit (nvidia-smi), the `highest`
   float32 policy (TF32 off for matmuls and cuDNN convs).
2. Build: the CUDA sources disvae_tpu_torch/csrc/log_qz.cu and
   convt3_bwd.cu, one nvcc each, started together (into
   build/disvae_tpu_torch/), with compile times and ptxas register/spill
   lines.
3. K3 vs plain PyTorch at the MIG/AAM sweeps' real shapes (marginal L=1,
   M=737,280; conditional L=3, M=245,760 and L=32, M=23,040; D=10,
   S=2,000): max |kernel - plain| <= 1e-4, both times (CUDA events, warm,
   median).
4. K1/K2 (the final decoder convT's backward) vs plain at the training
   path's shapes: x (256, 32, 32, 32) with dy (256, 3, 64, 64) and
   (128, ...), Cout = 1 at (256, 32, 16, 16), and (6, 8, 4, 4) -> Cout 5.
   float32: max |d| / max |ref| <= 1e-5; bf16 operands: <= 1e-3 against
   the plain version on the same operands (float32 sums) and <= 3e-2
   against cuDNN's float32 backward. Times at b256 celeba in bf16: K1, K2,
   their plain versions, cuDNN's backward of the layer.
5. Eval path: the full 737,280-image dsprites lattice fabricated with
   tools/fabricate_dsprites.py, a seeded-init Burgess 64x64x1 latent-10
   checkpoint written with the port's save_model, then the port's CLI
   `<name> --is-eval-only --is-metrics -l btcvae`. Checks finite MIG,
   AAM and test losses and that the run launched K3; then the entropy
   estimate on a 4,096-image subset, kernel against the CPU plain version.
6. Serving: ServingModel.from_dir answers encode (1, 7, 57 images),
   decode, reconstruct and sample(8).
7. Training path: a 25,637-image celeba subset (tools/fabricate_celeba.py;
   100 batches of 256 and a tail of 37), the K1/K2 hook set, then the CLI
   with btcvae_celeba's settings at b256 under `--precision default` for 2
   epochs. Checks one K1 and one K2 launch per train step, the log, the
   checkpoints, a falling epoch loss and finite test losses; prints each
   epoch's images/sec.
8. A/B of the steady-state b256 train step, with the hook and without,
   turns (without, with, with, without), then one torch.profiler window
   each: device time by kernel and the device's idle share.
9. FactorVAE through the CLI (b128 doubled to b256, 2 epochs); K1/K2 run
   on the 128-image half batch.

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
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
ATOL = 1e-4  # log-density bound of tests/test_metrics.py (kernel vs scan)
# K1/K2 bounds on max |d| / max |ref|: float32 (tests/test_models.py:280),
# bf16 operands against float32 sums of the same operands, and against
# cuDNN's float32 backward (tests/test_models.py:337)
CONVT_F32, CONVT_BF16, CONVT_VS_CUDNN = 1e-5, 1e-3, 3e-2
# (n, h, cin, cout): the path's b256 celeba layer, the FactorVAE half batch,
# the 32^2 datasets' Cout = 1, and an odd shape
CONVT_SHAPES = [(256, 32, 32, 3), (128, 32, 32, 3), (256, 16, 32, 1),
                (6, 4, 8, 5)]
N_CELEBA = 25637  # 100 batches of 256 and a ragged tail of 37
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


def phase_build(modules):
    """One nvcc per CUDA source, all started together."""
    out = {}

    def run(name, mod):
        t0 = time.perf_counter()
        try:
            out[name] = (mod.build(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised below, in the main thread
            out[name] = e

    threads = [threading.Thread(target=run, args=item)
               for item in modules.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in modules:
        if isinstance(out[name], BaseException):
            raise out[name]
        (path, compiler_log), seconds = out[name]
        log("build {}: {} in {:.2f} s".format(
            name, os.path.relpath(path, REPO), seconds))
        for line in compiler_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
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


def _rel(ref, got):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def phase_convt_kernels(C):
    """K1/K2 against their plain versions and cuDNN at the path's shapes.
    Returns the kernels' records (b256 celeba times in bf16)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    worst = {"convt3_dw": 0.0, "convt3_dx": 0.0}
    record = None
    for n, h, cin, cout in CONVT_SHAPES:
        x32 = torch.from_numpy(np.maximum(
            rng.standard_normal((n, cin, h, h), np.float32), 0)).to(dev)
        w = torch.from_numpy(0.1 * rng.standard_normal(
            (cin, cout, 4, 4), np.float32)).to(dev)
        dy32 = torch.from_numpy(1e-2 * rng.standard_normal(
            (n, cout, 2 * h, 2 * h), np.float32)).to(dev)
        # cuDNN's float32 backward of the layer (TF32 off: `highest`)
        ref_dx, ref_dw, _ = torch.ops.aten.convolution_backward(
            dy32, x32, w, [cout], [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [True, True, True])
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            dw = C.convt3_dw(x, dy)
            dx = C.convt3_dx(dy, w, torch.float32)
            dx_t = C.convt3_dx(dy, w)
            p_dw = C.convt3_dw_plain(x, dy, dt)
            p_dx = C.convt3_dx_plain(dy, w, dt)
            torch.cuda.synchronize()
            bound = CONVT_F32 if dt == torch.float32 else CONVT_BF16
            e = {"dw": _rel(p_dw, dw), "dx": _rel(p_dx, dx),
                 "dw_cudnn": _rel(ref_dw, dw), "dx_cudnn": _rel(ref_dx, dx)}
            bad = [k for k in ("dw", "dx") if not e[k] <= bound]
            bad += [k for k in ("dw_cudnn", "dx_cudnn")
                    if not e[k] <= CONVT_VS_CUDNN]
            if dx_t.dtype != dt or not torch.isfinite(dx_t).all().item():
                bad.append("dx in {}".format(dt))
            if bad:
                raise AssertionError("K1/K2 at {} {}: {} out of bounds: {}"
                                     .format((n, h, cin, cout), dt, bad, e))
            worst["convt3_dw"] = max(worst["convt3_dw"],
                                     (dw - p_dw).abs().max().item())
            worst["convt3_dx"] = max(worst["convt3_dx"],
                                     (dx - p_dx).abs().max().item())
            errs.append("{} dw {:.2e} dx {:.2e} (vs cuDNN f32: dw {:.2e} "
                        "dx {:.2e})".format(str(dt)[6:], e["dw"], e["dx"],
                                            e["dw_cudnn"], e["dx_cudnn"]))
        log("K1/K2 (n, h, cin, cout) = {}: max |d|/max |ref| {}".format(
            (n, h, cin, cout), "; ".join(errs)))
        if record is None:  # b256 celeba, bf16 operands as on the path
            x, dy, wb = x32.bfloat16(), dy32.bfloat16(), w.bfloat16()
            t = {
                "K1": time_ms(lambda: C.convt3_dw(x, dy), 20),
                "K2": time_ms(lambda: C.convt3_dx(dy, w), 20),
                "plain K1": time_ms(
                    lambda: C.convt3_dw_plain(x, dy, torch.bfloat16), 10),
                "plain K2": time_ms(
                    lambda: C.convt3_dx_plain(dy, w, torch.bfloat16), 10),
                "cuDNN dx+dw+db": time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        dy, x, wb, [cout], [2, 2], [1, 1], [1, 1], True,
                        [0, 0], 1, [True, True, True]), 20),
            }
            log("K1/K2 times at b256 celeba, bf16, ms (median of warm runs):"
                " " + ", ".join("{} {:.4f}".format(k, v)
                                for k, v in t.items()))
            record = {"convt3_dw": {"ms": t["K1"], "plain_ms": t["plain K1"]},
                      "convt3_dx": {"ms": t["K2"], "plain_ms": t["plain K2"]},
                      "cudnn_ms": t["cuDNN dx+dw+db"]}
        del x32, w, dy32
        torch.cuda.empty_cache()
    for k in worst:
        record[k]["max_abs_err"] = worst[k]
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
        _, evaluator = cli.main(cli.parse_arguments(
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


def _cli_run(cli, scratch, argv):
    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        t0 = time.perf_counter()
        trainer, evaluator = cli.main(cli.parse_arguments(argv))
        return trainer, evaluator, time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def _read_log(exp_dir):
    with open(os.path.join(exp_dir, "train_losses.log")) as f:
        lines = f.read().strip().split("\n")
    if lines[0] != "Epoch,Loss,Value":
        raise AssertionError("train_losses.log header: {}".format(lines[0]))
    return [line.split(",") for line in lines[1:]]


def phase_train(C, scratch):
    """btcvae_celeba's settings through the CLI at b256 under `default`,
    with the K1/K2 hook set. Returns K1's and K2's launch counts."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.utils.modelIO import load_metadata

    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "fabricate_celeba.py"),
                    "--root", os.path.join(scratch, "data", "celeba"),
                    "--n", str(N_CELEBA)],
                   check=True, stdout=subprocess.DEVNULL)
    log("fabricated a {:,}-image celeba subset in {:.1f} s".format(
        N_CELEBA, time.perf_counter() - t0))

    name = "chip_smoke_btcvae_celeba"
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        C.convt3_dw.launches = C.convt3_dx.launches = 0
        trainer, _, seconds = _cli_run(cli, scratch, [
            name, "-d", "celeba", "-l", "btcvae", "--btcvae-B", "6.4",
            "--lr", "5e-4", "-b", "256", "-e", "2", "--checkpoint-every",
            "1", "--precision", "default", "--no-viz-gif",
            "--no-progress-bar", "-s", str(SEED)])
        launches = (C.convt3_dw.launches, C.convt3_dx.launches)
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")

    exp_dir = os.path.join(scratch, cli.RES_DIR, name)
    steps = trainer.state.step
    stats = trainer.epoch_stats
    log("train CLI (btcvae, celeba {:,} images, b256, default, K1/K2 hook):"
        " {:.1f} s in all, {} steps, K1 launches {}, K2 launches {}".format(
            N_CELEBA, seconds, steps, *launches))
    for e in stats:
        log("  epoch {}: mean loss {:.4f}, {:.0f} images/sec".format(
            e["epoch"] + 1, e["loss"], e["images_per_sec"]))
    if steps != 2 * -(-N_CELEBA // 256) or launches != (steps, steps):
        raise AssertionError("expected one K1 and one K2 launch per train "
                             "step: {} steps, launches {}".format(steps,
                                                                 launches))
    rows = _read_log(exp_dir)
    if sorted({r[0] for r in rows}) != ["0", "1"] \
            or not all(math.isfinite(float(r[2])) for r in rows):
        raise AssertionError("train_losses.log rows: {}".format(rows[:3]))
    if not stats[1]["loss"] < stats[0]["loss"]:
        raise AssertionError("the epoch loss did not fall: {}".format(stats))
    for f in ("model.pt", "model-0.pt", "model-1.pt", "specs.json",
              "train_state.pt"):
        if not os.path.exists(os.path.join(exp_dir, f)):
            raise AssertionError("missing artifact " + f)
    losses = load_metadata(exp_dir, filename="test_losses.log")
    log("test_losses.log: loss {loss}, recon_loss {recon_loss}, tc_loss "
        "{tc_loss}".format(**losses))
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError("non-finite test losses")
    return launches


def _device_profile(prof):
    """(device-busy seconds, [(kernel, ms, calls)] by device time) of a
    torch.profiler window, from its device events: the busy time is the
    union of their intervals."""
    intervals, by_name = [], {}
    for e in prof.events():
        # GPU-side annotation ranges (e.g. Optimizer.step) span kernels and
        # the gaps between them: not device work of their own
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        intervals.append((e.time_range.start, e.time_range.end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return busy / 1e6, [(k, ms, n) for k, (ms, n) in top]


def phase_ab(C, datasets):
    """Steady-state b256 btcvae train step under `default` on the resident
    celeba subset, with the plain final convT and with the K1/K2 hook."""
    from disvae_tpu_torch.data.resident import ResidentData
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step

    dev = torch.device("cuda")
    ds = datasets.get_dataset("celeba")()
    wire = ResidentData(ds, dev).wire
    cfg = get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                     btcvae_A=1.0, btcvae_B=6.4, btcvae_G=1.0,
                     n_data=len(ds))
    step = make_train_step(cfg)
    idx = torch.from_numpy(np.random.default_rng(SEED).permutation(
        len(ds))[:100 * 256].reshape(100, 256)).to(dev)
    impls = {"plain convT": burgess.conv_transpose2d,
             "K1/K2 hook": C.conv_transpose2d_pl}
    states, cursor = {}, {k: 0 for k in impls}

    def run(name, n):
        burgess.set_final_convt_impl(impls[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(states[name], wire.index_select(
                0, idx[cursor[name] % len(idx)]))
            cursor[name] += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    configure("default")
    try:
        for name in impls:
            model = init_specific_model(
                "Burgess", (3, 64, 64), 10,
                generator=torch.Generator().manual_seed(SEED), device=dev)
            states[name] = create_train_state(
                model, make_optimizer(model.parameters(), 5e-4),
                torch.Generator(device=dev).manual_seed(SEED),
                loss_cfg=cfg)
            run(name, 10)  # warm-up: cuDNN algorithm choice, allocator
        times = {k: [] for k in impls}
        for name in ("plain convT", "K1/K2 hook", "K1/K2 hook",
                     "plain convT"):
            times[name].append(run(name, 40))
        for name in impls:
            log("A/B {}: train step {} ms (two runs of 40 steps), {:.0f} "
                "images/sec".format(name, " / ".join(
                    "{:.3f}".format(t) for t in times[name]),
                    256e3 / statistics.mean(times[name])))
        for name in impls:
            burgess.set_final_convt_impl(impls[name])
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for i in range(10):
                    step(states[name], wire.index_select(0, idx[i]))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy, top = _device_profile(prof)
            if busy == 0:
                log("profile {}: the profiler saw no device events (device "
                    "time not measured)".format(name))
                continue
            log("profile {} (10 steps, profiler on): wall {:.2f} ms, device "
                "busy {:.2f} ms, idle share {:.1%}".format(
                    name, wall * 1e3, busy * 1e3, 1 - busy / wall))
            for k, ms, n in top[:12]:
                log("  {:9.3f} ms {:5d} calls  {}".format(ms, n, k[:110]))
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")


def phase_factor(C, scratch):
    """FactorVAE through the CLI on the same subset: b128 and 1 epoch,
    doubled by the CLI to b256 and 2 epochs; K1/K2 on the half batch."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.utils.modelIO import load_metadata

    name = "chip_smoke_factor_celeba"
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        C.convt3_dw.launches = C.convt3_dx.launches = 0
        trainer, _, seconds = _cli_run(cli, scratch, [
            name, "-d", "celeba", "-l", "factor", "--factor-G", "6.4",
            "--lr", "1e-4", "--lr-disc", "1e-5", "-b", "128", "-e", "1",
            "--precision", "default", "--no-viz-gif", "--no-progress-bar",
            "-s", str(SEED)])
        launches = (C.convt3_dw.launches, C.convt3_dx.launches)
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    exp_dir = os.path.join(scratch, cli.RES_DIR, name)
    log("factor CLI (celeba, b128 -> b256, 2 epochs): {:.1f} s, {} steps, "
        "K1 launches {}, K2 launches {}; epochs {}".format(
            seconds, trainer.state.step, *launches, ", ".join(
                "{:.4f} loss at {:.0f} images/sec".format(
                    e["loss"], e["images_per_sec"])
                for e in trainer.epoch_stats)))
    if min(launches) <= 0:
        raise AssertionError("the factor run never launched K1/K2")
    rows = _read_log(exp_dir)
    keys = {r[1] for r in rows}
    if not {"loss", "tc_loss", "discrim_loss"} <= keys \
            or not all(math.isfinite(float(r[2])) for r in rows):
        raise AssertionError("factor train_losses.log: {}".format(keys))
    losses = load_metadata(exp_dir, filename="test_losses.log")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError("non-finite factor test losses")
    last = {r[1]: r[2] for r in rows if r[0] == "1"}
    log("factor train_losses.log, epoch 1: loss {loss}, tc_loss {tc_loss}, "
        "discrim_loss {discrim_loss}".format(**last))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops import log_qz as K

    phase_device()
    phase_build({"log_qz": K, "convt3_bwd": C})
    record = phase_kernels(K)
    convt = phase_convt_kernels(C)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    try:
        exp_dir, datasets, launches = phase_main_path(K, scratch)
        phase_serving(exp_dir, datasets)
        dw_launches, dx_launches = phase_train(C, scratch)
        phase_ab(C, datasets)
        phase_factor(C, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    convt_src = "disvae_tpu_torch/csrc/convt3_bwd.cu"
    log(json.dumps({"kernels": [
        dict(name="log_qz", route="cuda",
             source="disvae_tpu_torch/csrc/log_qz.cu",
             replaces="disvae_tpu/ops/pallas_kernels.py:44",
             launches=launches, max_abs_err=record["max_abs_err"],
             ms=record["ms"], plain_ms=record["plain_ms"]),
        dict(name="convt3_dw", route="cuda", source=convt_src,
             replaces="disvae_tpu/ops/pallas_convt_bwd.py:71",
             launches=dw_launches, **convt["convt3_dw"]),
        dict(name="convt3_dx", route="cuda", source=convt_src,
             replaces="disvae_tpu/ops/pallas_convt_bwd.py:108",
             launches=dx_launches, **convt["convt3_dx"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
