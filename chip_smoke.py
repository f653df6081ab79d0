#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference and training paths once on one
GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --convt-only [--package-root DIR]
    python3 chip_smoke.py --logqz-only [--package-root DIR]
    python3 chip_smoke.py --graph-only
    python3 chip_smoke.py --zoo-only

`--convt-only` runs phases 1, 2 and 4 only, `--logqz-only` phases 1-3 for
K3 only, `--graph-only` phase 16 on seeded random images (after building
K1/K2), `--zoo-only` phases 1, 2 and 17; `--package-root` imports disvae_tpu_torch from another checkout
(e.g. a `git archive` of the parent commit unpacked under build/), to time
its kernels in the same call. Another checkout's K3 is not held to the
recompute counter (a K3 without that kernel has none).

Phases (any failure raises and exits non-zero; there is no CPU carry-on):

1. Device: the card's name and power limit (nvidia-smi), the `highest`
   float32 policy (TF32 off for matmuls and cuDNN convs).
2. Build: the CUDA sources disvae_tpu_torch/csrc/log_qz.cu and
   convt3_bwd.cu, and the floor kernel of disvae_tpu_torch/probe_convt.py
   (always this checkout's), one nvcc each, and the native host gather
   (disvae_tpu_torch/native/gather.cpp, g++), started together (into
   build/disvae_tpu_torch/), with compile times and ptxas register/spill
   lines; the issue slots per log-density of K3's inner loop, by kind,
   from its SASS (cuobjdump).
3. K3 vs plain PyTorch at the six sweep shapes of one full-lattice eval
   (L, M) = (1, 737,280), (3, 245,760), (6, 122,880), (40, 18,432) and
   (32, 23,040) twice, D=10, S=2,000: max |kernel - plain| <= 1e-4 and two
   calls bitwise equal; L2-cold and warm times at each (CUDA events) and
   their sum over the eval's 30 launches; the plain version's time and
   the warm device time by kernel (profiler) at the marginal shape, and
   with `--logqz-only` the SM clock under load (nvidia-smi). Then the edge
   inputs of tests/log_qz_cases.py (ragged M and S, tight posteriors,
   samples 50 sigma from every component): within 1e-4 plus two float32
   roundings of the result, bitwise repeatable, and the 50-sigma case
   recomputed entry by entry (`log_qz.last_recomputed`). K3's bound is the
   card's for the function, whatever the kernel: its exps split between
   the SFU and the FMA pipe at the share that balances the two.
4. K1/K2 (the final decoder convT's backward) vs plain at the training
   path's shapes: x (256, 32, 32, 32) with dy (256, 3, 64, 64) and
   (128, ...), Cout = 1 at (256, 32, 16, 16), phase 17's x (64, 32, 16,
   16) with dy (64, 1, 32, 32) and x (64, 32, 32, 32) with dy (64, 1, 64,
   64), the b64 btcvae_celeba flagship's x (64, 32, 32, 32) with dy (64,
   3, 64, 64), and (6, 8, 4, 4) -> Cout 5.
   float32: max |d| / max |ref| <= 1e-5; bf16 operands: <= 1e-3 against
   the plain version on the same operands (float32 sums) and <= 3e-2
   against cuDNN's float32 backward. Times at b256 celeba in bf16, L2-cold
   (CUDA events; 256 MB written and read between runs) and warm (device
   time by kernel, torch.profiler): K1, K2, cuDNN's dW-only, dx-only and
   whole backward of the layer (under `default`); the plain versions warm.
   Each kernel's bound (bytes or operations over the H100's peaks) and its
   L2-cold ratio to its cuDNN call. K2's floor, a flat pass that reads dy
   and writes dx once in 16-byte accesses, and K2's share of it; K2's
   times at the FactorVAE half batch (128, 32, 32, 3) too; all of the
   b256 times, bounds and floors again at the b64 flagship's shape and
   at the two Cout = 1 shapes of the mnist/fashion and chairs runs
   (`b64_mnist`, `b64_chairs`).
5. Eval path: the full 737,280-image dsprites lattice fabricated with
   tools/fabricate_dsprites.py, a seeded-init Burgess 64x64x1 latent-10
   checkpoint written with the port's save_model, then the port's CLI
   `<name> --is-eval-only --is-metrics -l btcvae`. Checks finite MIG,
   AAM and test losses, that the run launched K3 and that the streamed
   encode gathered each batch through the native gather once; then the
   entropy
   estimate on a 4,096-image subset, kernel against the CPU plain version;
   then the entropy phase again in a torch.profiler window (wall, device
   busy, device time by kernel), and its seconds beside K3's 30 launches
   timed alone.
6. Serving: ServingModel.from_dir answers encode (1, 7, 57 images),
   decode, reconstruct and sample(8).
7. Training path: a 25,637-image celeba subset (tools/fabricate_celeba.py;
   100 batches of 256 and a tail of 37), the K1/K2 hook set, then the CLI
   with btcvae_celeba's settings at b256 under `--precision default` for 2
   epochs, under torch.profiler. Checks one K1 and one K2 execution per
   train step among the profiler's device events (eager and replayed
   steps alike), that the wrappers launched each kernel (in the eager
   steps and the capture: a replay calls no wrapper), that the resident
   super-steps replayed as a CUDA graph, the log, the checkpoints, a
   falling epoch loss and finite test losses; prints each epoch's
   images/sec (profiled).
8. A/B of the steady-state b256 train step, with the hook and without,
   turns (without, with, with, without), then one torch.profiler window
   each: device time by kernel (the twelve largest, and K1/K2 wherever
   they rank) and the device's idle share.
9. FactorVAE through the CLI (b128 doubled to b256, 2 epochs), its
   super-steps replayed as a CUDA graph; K1/K2 run on the 128-image half
   batch. Once with `--no-viz-gif` and once with the
   per-epoch training gif: training.gif has one 662 x 662 RGB frame per
   epoch, its frames decode to the rendered ones within the palette bound,
   and each frame's milliseconds are printed.
10. Eval variants on the dsprites lattice: `--fast-metrics` (no K3 launch;
   entropy seconds, |dMIG| <= 1e-3 and |dAAM| <= 1e-2 against the K3
   run, the bounds of tests/test_torch_fast_metrics.py), and
   `--resident-data always` against `never` (encode seconds; MIG and AAM
   identical); the resident upload timed alone.
11. Export (in the serving phase): `torch.export` of the dsprites
   checkpoint at batch 64, loaded back and held to ServingModel on the
   card, max |d| <= 1e-5 under `highest`.
12. Viz: `python -m disvae_tpu_torch.cli_viz <name> all -s 1234
   --is-show-loss`, then with `--is-posterior`, on the celeba run of
   phase 7 and the dsprites checkpoint of phase 5 (seconds per plot). Every
   file has the JAX package's geometry at -r 6 -c 7; the PNG and GIF files
   decode (with readers of the port's own encoding, below) to the rendered
   arrays, grey exactly and RGB within the palette bound; the prior
   traversals re-rendered on the CPU agree with the card's within 1; the
   process never imported PIL, imageio or pandas.
13. Data parallelism at world size 1 over NCCL (this checkout's package
   only): the group formed by parallel.distributed.initialize() from a
   launcher's environment (RANK=0, WORLD_SIZE=1, a free MASTER_PORT), its
   backend (must be nccl) and NCCL's version; one DP btcvae and one DP
   FactorVAE step at b256 celeba shapes under `highest` against the plain
   steps from the same state and pinned noise (params, Adam moments and
   metrics within 1e-6 of their scale, and whether bitwise equal); the
   padded step, 255 real rows of 256, under `default` with the K1/K2 hook
   against the plain step on the 255 (the JAX test's bounds: metrics rel
   1e-4, params atol 2e-4 where the gradient is at least 1% of its
   tensor's largest; one K1 and one K2 launch); the training CLI under the
   group with phase 7's settings for 1 epoch (one K1 and one K2 launch per
   step, finite losses, the artifact set; images/sec beside phase 7's);
   the host-clock step, DP against plain, 40 steps in turns; the eval CLI
   of phase 5 under the group (30 K3 launches, MIG and AAM within 1e-6 of
   phase 5's, encode and entropy seconds beside it). Every line carries
   the card's name and power limit; the group is destroyed at the end.
14. Tensor parallelism at model size 1, in phase 13's group: the
   FactorVAE step of `make_tp_train_step` (all six discriminator layers
   column-parallel over the one-rank model group) at b256 celeba shapes
   under `highest` against the plain step from the same state and pinned
   noise (params, Adam moments and metrics within 1e-6 of their scale,
   and whether bitwise equal); the same step under `default` with the
   K1/K2 hook (one K1 and one K2 launch) with its collectives counted by
   group; the host-clock TP step against the DP step, 40 steps in turns;
   the Trainer with the TP discriminator, 1 epoch + resume from
   train_state.pt (which must hold the whole discriminator) + 1 epoch
   against 2 straight, bit for bit. Model sizes above 1 need a rank per
   card and are held on the CPU over gloo only (tests/test_torch_tp.py).
15. Native host gather: get_batch, get_batch_raw and get_batch_bits
   bitwise equal to numpy on 1,000 seeded random indices of the memmapped
   dsprites lattice and of the celeba subset; host ms per b256 batch,
   native at its thread count and at N_THREADS against numpy, median of
   20; phase 5's streamed eval again with
   numpy gathers, in turns with the native gather (MIG and AAM bitwise
   phase 5's; encode seconds of each). Every line of phases 14 and 15
   carries the card's name and power limit.
16. The resident super-step as one CUDA graph (train/steps.py
   GraphedSuperStep), after phase 8 (this checkout's package only): each
   of the five losses at b64 dsprites shapes (the fabricated lattice's
   bits) under `highest`, and btcvae under `default` with the K1/K2 hook,
   four super-steps of K = 4 (one eager, one captured, three replays)
   against four eager ones from the same seed: metrics, parameters,
   gradients, Adam's state, the generator and both step counters bit for
   bit, and 24 K1 and K2 wrapper launches each with the hook (16 eager
   steps, 4 eager and 4 captured ones). Then the b64 dsprites btcvae step
   (`highest`, the evidence run's) and the b256 celeba btcvae step
   (`default`, hook) eager against graphed (K = 16, the Trainer's), host
   ms per step over 20 super-steps in turns (eager, graph, graph, eager),
   and a torch.profiler window of two super-steps each for the device's
   busy share and the K1/K2 kernels the replays ran; a graphed Trainer,
   1 epoch + resume + 1, against 2 straight, bit for bit. Every line
   carries the card's name and power limit.
17. The zoo through the CLIs (after phase 12): betaB on mnist, betaH on
   fashion and VAE on chairs (ZOO_RUNS), each with the settings of a JAX
   run under artifacts/ read from its specs.json, for 2 epochs on the
   full fabricated dataset (60,000, 60,000 and 86,366 images, fabricated
   at once), at b64 under `--precision default` with the K1/K2 hook,
   each under torch.profiler; the fashion run keeps the per-epoch
   training gif (342 x 342 grey frames, decoded exactly). Checks: finite
   logged and test losses, a falling epoch loss, the super-steps replayed
   as a CUDA graph, one K1 and one K2 execution per step among the
   profiler's device events at x (64, 32, 16, 16), dy (64, 1, 32, 32) and x
   (64, 32, 32, 32), dy (64, 1, 64, 64), the artifact set; then, the
   three runs at once, `python -m disvae_tpu_torch <name> --is-eval-only
   -l <loss>` (finite test losses) and `python -m
   disvae_tpu_torch.cli_viz <name> all` and `--is-posterior`, whose
   files have the JAX package's geometry at 32 and 64 px cells and decode
   as in phase 12; no process imported PIL, imageio or pandas (the
   subprocesses' `-X importtime`). Each epoch's logged loss is printed
   beside the JAX run's, with the gap (not gated); the phase's seconds
   with fabrication and each run apart. Every line carries the card's
   name and power limit.
18. The flagship's evidence CLI (after phase 17, this checkout's
   package only): `python -m disvae_tpu_torch.evidence <name> custom
   --skip-metrics --profile-epoch 0 --final-convt kernels` and the same
   with `cudnn`, the two at once, with the settings of the JAX flagship
   artifacts/btcvae_celeba_tpu/ (b64, `default`, no gif) for 1 epoch on
   phase 7's celeba subset (401 steps). From each device.json: the card,
   the resident feed and a replayed graph, and K1's and K2's executions
   (launches outside a capture plus one per replayed step) equal to the
   steps and to the profiled epoch's device events with `kernels`, all
   zero with `cudnn`; the two runs' specs equal but for the name; finite
   test losses. Then, alone on the card, FactorVAE through the same CLI
   with the settings of the JAX run artifacts/factor_mnist_full_tpu/
   (b64 doubled to b128, `default`, no gif) for `-e 1`, doubled to 2
   epochs of 469 steps, on phase 17's mnist, `--final-convt kernels
   --profile-epoch 0`: the resident feed and a replayed graph, K1's and
   K2's executions equal to the steps (one each a step: only the first
   half batch goes through the decoder) and to the profiled epoch's
   device events, finite VAE and discriminator losses in both epochs and
   finite test losses, the specs the JAX run's but for the name, the
   epochs and the experiment; prints the graphed FactorVAE step's ms
   (epoch 1's images/sec) and the device's busy ms a step in epoch 0.

Its last two lines are JSON: the kernels' record (per kernel `ms`, the
L2-cold time, `warm_ms`, `plain_ms`, `bound_ms`/`bound_us`, `bound_by`,
`library_ms`, the L2-cold time of cuDNN's call for the same gradient or
null; `launches`, the wrapper's count in the main path's run; for K1/K2
`graph_replays` and `device_launches`, phase 7's replays and the
profiler's count of the kernel's executions, `zoo`, phase 17's wrapper
launches, the profiler's executions, replays and steps per run,
`evidence` and `evidence_factor`, phase 18's launches, captured
launches, executions, steps and profiled device executions and steps in
the flagship's and the FactorVAE kernels runs, `b64_celeba`,
`b64_mnist` and `b64_chairs`, the times, bound and library call at the
flagship's and the two Cout = 1 shapes, and `cudnn_dw_ms`/`cudnn_dx_ms`;
for K2 `flat_us`, its floor, and `b128_ms`/`b128_warm_ms`; for K3
`shapes`, the per-shape times, `eval_sum_ms`/`eval_sum_warm_ms` and
`entropy_seconds`), then
{"ok": true, "device": {...}}. Scratch data lives under build/ and is
removed at the end.
"""

import ctypes
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

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
# the 32^2 datasets' Cout = 1, phase 17's b64 mnist/fashion and chairs
# layers, the b64 btcvae_celeba flagship's layer (phase 18), and an odd
# shape
CONVT_SHAPES = [(256, 32, 32, 3), (128, 32, 32, 3), (256, 16, 32, 1),
                (64, 16, 32, 1), (64, 32, 32, 1), (64, 32, 32, 3),
                (6, 4, 8, 5)]
FLAGSHIP_CONVT = (64, 32, 32, 3)
# phase 17's and the zoo evidence runs' Cout = 1 layers, by their dataset
COUT1_CONVT = {(64, 16, 32, 1): "b64_mnist", (64, 32, 32, 1): "b64_chairs"}
N_CELEBA = 25637  # 100 batches of 256 and a ragged tail of 37
N_DSPRITES = 737280  # the full factor lattice
EXPORT_ATOL = 1e-5  # exported program vs ServingModel, float32 both
# cli_viz's default grid: -r 6 rows, -c 7 columns of 64 px cells, 2 px pads
VIZ_ROWS, VIZ_COLS, VIZ_GIF_FRAMES = 6, 7, 15
# |dMIG|, |dAAM| of `--fast-metrics` against K3 (tests/test_torch_fast_metrics)
FAST_MIG_ATOL, FAST_AAM_ATOL = 1e-3, 1e-2
# (L, M) of the six entropy sweeps of one full-lattice dsprites MIG/AAM
# eval: the marginal, then one per factor (the L slices of a factor batched,
# M = 737,280 / L). Each sweep is LAUNCHES_PER_SWEEP log_qz launches of
# S = 2,000 samples at D = 10: 30 launches, each 1.47e10 log-densities.
EVAL_SWEEPS = [(1, 737280), (3, 245760), (6, 122880), (40, 18432),
               (32, 23040), (32, 23040)]
EVAL_D, EVAL_S, LAUNCHES_PER_SWEEP = 10, 2000, 5
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
# device memory bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside
# the tensor cores; and the SFU's exps/s, 16 per SM per clock at the
# 1.98 GHz boost clock
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
BOOST_MHZ = 1980
PEAK_EXP = 132 * 16 * BOOST_MHZ * 1e6
# An exp taken on the FMA pipe instead of the SFU: range reduction and a
# degree-6 polynomial, 6 fmas and 3 adds, 15 float32 FLOPs
EXP_FLOPS_ON_FMA = 15
L2_FLUSH_BYTES = 256 << 20  # written, read between L2-cold runs: 5 L2s
# The data-parallel phase at world size 1: the DP step against the plain
# step under `highest` (max |d| / max |ref| over parameters, Adam moments
# and metrics), and |dMIG|, |dAAM| of the split eval against the plain one
DP_PARITY, DP_METRICS = 1e-6, 1e-6
# the graph phase's super-steps: the Trainer's steps_per_dispatch, and
# how many super-steps each timed turn runs
GRAPH_K, GRAPH_SUPER = 16, 20
# Phase 17: (run name, the JAX zoo run under artifacts/ whose settings it
# trains with, whether it keeps the per-epoch training gif), for 2 epochs
# on the full fabricated dataset. Between them they cover VAE, betaH and
# betaB, and mnist, fashion and chairs.
ZOO_RUNS = [("betaB_mnist", "betaB_mnist_tpu", False),
            ("betaH_fashion", "betaH_fashion_full_tpu", True),
            ("VAE_chairs", "VAE_chairs_tpu", False)]
ZOO_EPOCHS = 2
# phase 18's FactorVAE run trains with this JAX run's settings
FACTOR_EVIDENCE = "factor_mnist_full_tpu"
# the zoo losses' own coefficients, by their specs.json keys (the CLI's
# flags with "-" for "_")
LOSS_COEFS = {"VAE": (), "betaH": ("betaH_B",),
              "betaB": ("betaB_initC", "betaB_finC", "betaB_G"),
              "btcvae": ("btcvae_A", "btcvae_B", "btcvae_G"),
              "factor": ("factor_G", "lr_disc")}
# the fabricators of phase 17's datasets: (script, flags)
ZOO_DATA = {"mnist": ("fabricate_mnist.py", ["--dataset", "mnist"]),
            "fashion": ("fabricate_mnist.py", ["--dataset", "fashion"]),
            "chairs": ("fabricate_chairs.py", [])}
# an epoch-1 loss more than this far from the JAX run's is a result fault
# to hunt (printed, not gated: the init and the noise differ)
ZOO_GAP = 0.15


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps, flush=None):
    """Device time of one run of `fn` (CUDA events). Warm: the median of
    three event pairs, each around `reps` runs enqueued back to back, over
    `reps`. L2-cold with `flush`, a buffer larger than the L2 cache: the
    median of `reps` event pairs around one run each, the buffer written
    and then read before each pair (so the L2 holds clean lines of it,
    whose eviction costs the timed run no write-back), outside the events;
    the flush keeps the card busy while the host enqueues the run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps if flush is not None else 3):
        if flush is not None:
            flush.zero_()
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if flush is not None else reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end)
                     / (1 if flush is not None else reps))
    return statistics.median(times)


def read_png(path):
    """Decode a PNG as the port writes it: 8-bit rows of filter type 0 in
    zlib IDAT chunks, every chunk CRC checked."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("{}: not a PNG".format(path))
    pos, idat = 8, b""
    while pos < len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) != crc:
            raise AssertionError("{}: bad {} CRC".format(path, tag))
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", data[:10])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    c = {0: 1, 2: 3, 6: 4}[colour]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if depth != 8 or rows.shape[1] != 1 + w * c or rows[:, 0].any():
        raise AssertionError("{}: not 8-bit filter-0 rows".format(path))
    return rows[:, 1:].reshape(h, w, c)


def _sub_blocks(buf, pos):
    out = b""
    while buf[pos]:
        out += buf[pos + 1:pos + 1 + buf[pos]]
        pos += 1 + buf[pos]
    return out, pos + 1


def _lzw_decode(data):
    """The indices of a GIF LZW stream of minimum code size 8, up to its end
    code: codes widen from 9 to 12 bits as the dictionary grows and a clear
    code (256) resets it."""
    data = bytes(data) + b"\x00\x00\x00"
    out, table, pos, width, prev = bytearray(), [], 0, 9, None
    while pos + width <= (len(data) - 3) * 8:
        code = (int.from_bytes(data[pos >> 3:(pos >> 3) + 3], "little")
                >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width, prev = 9, None
            continue
        if code == 257:
            return out
        if not table or code > len(table) or (code == len(table)
                                              and prev is None):
            raise AssertionError("LZW code {} beyond a dictionary of {}"
                                 .format(code, len(table)))
        entry = table[code] if code < len(table) else prev + prev[:1]
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        if len(table) == 1 << width and width < 12:
            width += 1
        out += entry
        prev = entry
    raise AssertionError("LZW stream without an end code")


def read_gif(path):
    """Decode a GIF as the port writes it: full frames with a 256-entry
    local palette, LZW codes of 9 to 12 bits after a leading clear code.
    Returns (frames (H, W, 3) uint8, delays, loop)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:6] != b"GIF89a" or buf[10] & 0x80:
        raise AssertionError("{}: not the port's GIF layout".format(path))
    w, h = struct.unpack("<HH", buf[6:10])
    pos, frames, delays, loop = 13, [], [], None
    while buf[pos] != 0x3B:
        if buf[pos] == 0x21:
            label = buf[pos + 1]
            body, pos = _sub_blocks(buf, pos + 2)
            if label == 0xF9:
                delays.append(struct.unpack("<H", body[1:3])[0])
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", body[12:14])[0]
            continue
        fw, fh, flags = struct.unpack("<HHB", buf[pos + 5:pos + 10])
        pos += 10
        palette = np.frombuffer(buf[pos:pos + 768], np.uint8).reshape(256, 3)
        pos += 768
        if (fw, fh) != (w, h) or flags != 0x87 or buf[pos] != 8:
            raise AssertionError("{}: unexpected frame header".format(path))
        data, pos = _sub_blocks(buf, pos + 1)
        idx = np.frombuffer(_lzw_decode(data), np.uint8)
        if idx.size != w * h:
            raise AssertionError("{}: {} indices for {} x {} pixels".format(
                path, idx.size, w, h))
        frames.append(palette[idx].reshape(h, w, 3))
    return frames, delays, loop


def _grid_shape(rows, cols, px=64):
    """(H, W) of a make_grid of rows x cols cells with 2 px padding."""
    return rows * (px + 2) + 2, cols * (px + 2) + 2


def _max_diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError("shapes {} and {}".format(a.shape, b.shape))
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def phase_device():
    """Prints the card's name and power limit and returns them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    from disvae_tpu_torch.ops.precision import configure
    configure("highest")
    log("device: {} x{} (torch {}, CUDA {})".format(
        torch.cuda.get_device_name(0), torch.cuda.device_count(),
        torch.__version__, torch.version.cuda))
    return smi[0]


def phase_build(modules):
    """One nvcc per CUDA source, all started together. Returns {name:
    library path}."""
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
    return {name: out[name][0][0] for name in modules}


def _log_qz_cases():
    """K3's input generator and edge cases, shared with its tests
    (tests/log_qz_cases.py, numpy only)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import log_qz_cases
    return log_qz_cases


def _log_qz_inputs(seed, L, M, D, S, kind="unit"):
    return [torch.from_numpy(a).cuda() for a in
            _log_qz_cases().log_qz_inputs(seed, L, M, D, S, kind)]


def _log_qz_bound(n, nbytes):
    """K3's least time for n log-densities on the card. Each needs 5
    float32 FLOPs (the difference, its square, an fma, the sum's add) and
    one exp, which the SFU gives at PEAK_EXP or the FMA pipe computes in
    EXP_FLOPS_ON_FMA FLOPs. The least time over the share f of exps on the
    FMA pipe, of max(n (1 - f) / PEAK_EXP, n (5 + 15 f) / PEAK_F32), comes
    where the two are equal. Returns (the `_bound` record, f)."""
    f = (PEAK_F32 - 5 * PEAK_EXP) / (PEAK_F32 + EXP_FLOPS_ON_FMA * PEAK_EXP)
    f = min(1.0, max(0.0, f))
    return _bound(nbytes, ops=[
        (n * (1 - f), PEAK_EXP),
        (n * (5 + EXP_FLOPS_ON_FMA * f), PEAK_F32)]), f


def _log_qz_tol(ref):
    """ATOL, plus two float32 roundings of the result: at |log q| ~ 1,250
    (50 sigma) one ulp is 1.2e-4, so no two float32 computations agree to
    1e-4 there; at |log q| ~ 10 this adds 2.4e-6."""
    return ATOL + 2 * torch.finfo(torch.float32).eps * ref.abs()


def phase_kernels(K, strict=True, clock=False):
    """K3 vs plain at the eval's six sweep shapes and at the edge inputs,
    bitwise repeatable; L2-cold and warm times at every sweep shape and
    their sum over the 30 launches of one eval. `strict`: the edge inputs
    that underflow the reference must take the recompute kernel (a package
    whose K3 has no such kernel, timed with --package-root, is not held to
    that). `clock`: read the SM clock under load at the marginal shape.
    Returns the kernel record (the marginal shape's times, per-shape times,
    the largest error)."""
    flush = _flush()
    errs, shapes, record, timed = [], [], None, {}
    for L, M in EVAL_SWEEPS:
        D, S = EVAL_D, EVAL_S
        if (L, M) not in timed:
            values, mu, logvar = _log_qz_inputs(SEED + L, L, M, D, S)
            got = K.log_qz(values, mu, logvar)
            ref = K.log_qz_plain(values, mu, logvar)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not (torch.isfinite(got).all().item() and err <= ATOL
                    and torch.equal(got, K.log_qz(values, mu, logvar))):
                raise AssertionError(
                    "log_qz kernel vs plain at {}: max abs err {} > {} or "
                    "not repeatable".format((L, M, D, S), err, ATOL))
            fn = functools.partial(K.log_qz, values, mu, logvar)
            timed[L, M] = {"L": L, "M": M, "max_abs_err": err,
                           "ms": time_ms(fn, 20, flush),
                           "warm_ms": time_ms(fn, 5)}
            errs.append(err)
            if record is None:
                n = L * M * D * S
                plain_ms = time_ms(
                    lambda: K.log_qz_plain(values, mu, logvar), 3)
                warm_dev, kernels = _device_ms(fn, 5)
                # bytes: the inputs and the output once
                bound, fma = _log_qz_bound(n, 4 * (
                    2 * mu.numel() + values.numel() + got.numel()))
                record = {"ms": timed[L, M]["ms"],
                          "warm_ms": timed[L, M]["warm_ms"],
                          "plain_ms": plain_ms, **bound}
                log("log_qz bound at the marginal shape: {:.4f} ms ({}), "
                    "{:.1%} of the exps on the FMA pipe ({:.4f} ms with "
                    "every exp on the SFU)".format(
                        record["bound_ms"], record["bound_by"], fma,
                        n / PEAK_EXP * 1e3))
                log("log_qz at the marginal shape: warm device time {:.3f} "
                    "ms by kernel: {}".format(warm_dev, "; ".join(
                        "{:.3f} ms {}".format(ms / n_, name[:50])
                        for name, ms, n_ in kernels) or "not measured"))
                if clock:
                    mhz, watts, n_smp = clock_under_load(fn)
                    log("log_qz at the marginal shape, run back to back: SM "
                        "clock {:.0f} MHz, {:.0f} W (medians of {} "
                        "nvidia-smi samples; the peaks assume {} MHz)".format(
                            mhz, watts, n_smp, BOOST_MHZ))
            del values, mu, logvar, got, ref
            torch.cuda.empty_cache()
        t = dict(timed[L, M], launches_per_eval=LAUNCHES_PER_SWEEP)
        shapes.append(t)
        log("log_qz L={} M={} D={} S={}: max_abs_err {:.3e}, L2-cold {:.4f} "
            "ms, warm {:.4f} ms, {:.1%} of the bound ({:.1f} G "
            "log-densities/s)".format(
                L, M, D, S, t["max_abs_err"], t["ms"], t["warm_ms"],
                record["bound_ms"] / t["ms"], L * M * D * S / t["ms"] / 1e6))
    del flush
    record["eval_sum_ms"] = sum(LAUNCHES_PER_SWEEP * t["ms"] for t in shapes)
    record["eval_sum_warm_ms"] = sum(LAUNCHES_PER_SWEEP * t["warm_ms"]
                                     for t in shapes)
    record["shapes"] = shapes
    log("log_qz over the 30 launches of one eval: L2-cold {:.2f} ms, warm "
        "{:.2f} ms; plain at the marginal shape {:.3f} ms; bound {:.3f} ms "
        "({}) per launch".format(record["eval_sum_ms"],
                                 record["eval_sum_warm_ms"],
                                 record["plain_ms"], record["bound_ms"],
                                 record["bound_by"]))

    for name, (kind, shape, seed) in _log_qz_cases().CARD_EDGE_CASES.items():
        values, mu, logvar = _log_qz_inputs(seed, *shape, kind=kind)
        got = K.log_qz(values, mu, logvar)
        n_rec = getattr(K.log_qz, "last_recomputed", None)
        n_rec = None if n_rec is None else int(n_rec.item())
        ref = K.log_qz_plain(values, mu, logvar)
        again = K.log_qz(values, mu, logvar)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        log("log_qz edge input {} {}: max abs err {:.3e} (|ref| up to "
            "{:.1f}), entries recomputed {} of {}".format(
                name, tuple(mu.shape), err.max().item(),
                ref.abs().max().item(), n_rec, got.numel()))
        if not (err <= _log_qz_tol(ref)).all().item() \
                or not torch.equal(got, again):
            raise AssertionError("log_qz edge input {}: max abs err {} or "
                                 "not repeatable".format(name,
                                                         err.max().item()))
        if strict and (n_rec is None
                       or (kind == "far" and n_rec != got.numel())):
            raise AssertionError("log_qz edge input {}: {} entries took the "
                                 "recompute kernel".format(name, n_rec))
        errs.append(err.max().item())
    record["max_abs_err"] = max(errs)
    return record


def clock_under_load(fn, seconds=2.0):
    """The SM clock and power draw (nvidia-smi, sampled about every 0.2 s)
    while `fn` runs back to back for about `seconds`. Returns (median MHz,
    median W, samples)."""
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split("\n")[0].split(",")
            samples.append((float(out[0]), float(out[1])))
            done.wait(0.2)

    fn()
    torch.cuda.synchronize()
    t = threading.Thread(target=sample)
    t0 = time.perf_counter()
    t.start()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    done.set()
    t.join()
    busy = samples[1:] or samples  # the first may precede the load
    return (statistics.median(s[0] for s in busy),
            statistics.median(s[1] for s in busy), len(samples))


def sass_inner_loop(lib_path, kernel, per_lds=None):
    """The instructions of `kernel`'s hottest loop in the built library,
    from `cuobjdump -sass`: the innermost backward branch whose body holds
    MUFU.EX2, the one with the most of them. Its log-densities are its
    shared-memory loads times `per_lds` (each load stages one component for
    that many samples), or its MUFU.EX2 count without `per_lds` (a kernel
    that spends one SFU exp per density). Returns ({kind: count per
    log-density}, body lines, log-densities), or None where cuobjdump is
    missing. Kinds: FP32 arithmetic, MUFU, LDS, select/compare (FSETP,
    FSEL, SEL, FMNMX, PLOP3), integer/branch, other."""
    import re
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs[1:] if kernel in f.split("\n", 1)[0])
    insts, labels = [], {}
    for line in body.split("\n"):
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2)))
    by_addr = {a: i for i, (a, _) in enumerate(insts)}

    def opcode(text):
        return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]

    loops = []
    for i, (_, text) in enumerate(insts):
        m = re.search(r"\((\.L_x_\d+)\)|0x([0-9a-f]+)", text)
        if not opcode(text).startswith("BRA") or m is None:
            continue
        j = labels.get(m.group(1)) if m.group(1) else by_addr.get(
            int(m.group(2), 16))
        if j is not None and j <= i:
            n_exp = sum(opcode(t).startswith("MUFU.EX2")
                        for _, t in insts[j:i + 1])
            if n_exp:
                loops.append((j, i, n_exp))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    j, i, n_exp = max(inner, key=lambda lp: lp[2])
    counts = {}
    for _, text in insts[j:i + 1]:
        op = opcode(text)
        if op.startswith("MUFU"):
            kind = "MUFU"
        elif op.startswith("LDS"):
            kind = "LDS"
        elif op.split(".")[0] in ("FSETP", "FSEL", "SEL", "FMNMX", "PLOP3"):
            kind = "select/compare"
        elif op.split(".")[0] in ("FADD", "FMUL", "FFMA"):
            kind = "FP32"
        elif op.startswith(("LD", "ST", "BAR", "NOP", "DEPBAR", "F", "H")):
            kind = "other"
        else:
            kind = "integer/branch"
        counts[kind] = counts.get(kind, 0) + 1
    n = counts.get("LDS", 0) * per_lds if per_lds else n_exp
    per_density = {k: v / n for k, v in sorted(counts.items())}
    per_density["all"] = (i + 1 - j) / n
    return per_density, [t for _, t in insts[j:i + 1]], n


def phase_sass(path, per_lds):
    """Issue slots per log-density in log_qz_partial_kernel's inner loop."""
    got = sass_inner_loop(path, "log_qz_partial_kernel", per_lds)
    if got is None:
        log("SASS: cuobjdump not found (not measured)")
        return
    per_density, lines, n = got
    log("SASS log_qz_partial_kernel inner loop: {} instructions for {} "
        "log-densities; per log-density: {}".format(
            len(lines), n, ", ".join("{} {:.3f}".format(k, v)
                                     for k, v in per_density.items())))
    for t in lines:
        log("  sass:", t)


def _probe():
    """disvae_tpu_torch/probe_convt.py of this checkout, whatever
    `--package-root` says: its floor kernel measures the card, not a
    package."""
    spec = importlib.util.spec_from_file_location(
        "probe_convt", os.path.join(REPO, "disvae_tpu_torch",
                                    "probe_convt.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def _rel(ref, got):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _flush():
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")


def _bound(nbytes, ops):
    """The least time of a kernel on the card: its bytes (each input read
    once, each output written once) over the memory rate, against each
    (count, peak rate) of its operations; the larger bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(n / rate for n, rate in ops) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _device_ms(fn, calls=10):
    """Device time of one warm call of `fn`: its kernels' device times
    summed over `calls` back-to-back calls in a torch.profiler window, over
    `calls` (no host gaps), and the kernels [(name, ms, launches)]; CUDA
    events around back-to-back calls where the profiler sees no device
    events."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, top = _device_profile(prof)
    if not top:
        return time_ms(fn, calls), []
    return sum(ms for _, ms, _ in top) / calls, top


def _convt_times(C, x32, w, dy32, probe, flat, label="b256 celeba"):
    """K1, K2, their plain versions and cuDNN's single-gradient calls at
    `label`'s shape with bf16 operands: L2-cold medians (CUDA events) and
    warm device times (profiler). cuDNN runs under the `default` policy
    that the hook replaces it in. K2's floor: `probe.flat_pass` on `flat`,
    the floor kernel's library, reads dy and writes dx once in 16-byte
    accesses."""
    from disvae_tpu_torch.ops.precision import configure
    x, dy, wb = x32.bfloat16(), dy32.bfloat16(), w.bfloat16()
    cout = w.shape[1]
    sink = torch.zeros(4, dtype=torch.int32, device=dy.device)
    dx = torch.empty_like(x)
    sm_count = torch.cuda.get_device_properties(
        dy.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def cudnn(mask):
        return lambda: torch.ops.aten.convolution_backward(
            dy, x, wb, [cout] if mask[2] else None, [2, 2], [1, 1], [1, 1],
            True, [0, 0], 1, mask)

    fns = {"K1": lambda: C.convt3_dw(x, dy),
           "K2": lambda: C.convt3_dx(dy, w),
           "cuDNN dW": cudnn([False, True, False]),
           "cuDNN dx": cudnn([True, False, False]),
           "cuDNN dx+dw+db": cudnn([True, True, True]),
           "flat dy -> dx": lambda: probe.flat_pass(flat, (dy,), dx,
                                                    sm_count, stream, sink)}
    flush = _flush()
    configure("default")
    try:
        cold = {k: time_ms(f, 20, flush) for k, f in fns.items()}
        warm, kernels = {}, {}
        for k, f in fns.items():
            warm[k], kernels[k] = _device_ms(f)
    finally:
        configure("highest")
    del flush
    plain = {"K1": time_ms(lambda: C.convt3_dw_plain(x, dy, torch.bfloat16),
                           10),
             "K2": time_ms(lambda: C.convt3_dx_plain(dy, w, torch.bfloat16),
                           10)}
    log("K1/K2 times at {}, bf16, ms (L2-cold / warm device): ".format(
        label)
        + ", ".join("{} {:.4f} / {:.4f}".format(k, cold[k], warm[k])
                    for k in fns)
        + "; plain K1 {:.4f}, plain K2 {:.4f}".format(plain["K1"],
                                                     plain["K2"]))
    for k in ("K1", "K2"):
        log("{} warm, by kernel: {}".format(k, "; ".join(
            "{:.2f} us {}".format(ms * 1e3 / n, name[:60])
            for name, ms, n in kernels[k]) or "not measured (no device "
            "events)"))
    # bytes, each read or written once: K1 reads x and dy (bf16) and writes
    # dW (float32); K2 reads dy and w (float32) and writes dx (bf16). The
    # product's multiply-adds on the bf16 tensor cores.
    flops = 2 * x.numel() * 16 * cout
    nbytes = {"K1": 2 * (x.numel() + dy.numel()) + 4 * w.numel(),
              "K2": 2 * (dy.numel() + x.numel()) + 4 * w.numel()}
    lib = {"K1": "cuDNN dW", "K2": "cuDNN dx"}
    record = {"cudnn_dw_ms": cold["cuDNN dW"], "cudnn_dx_ms": cold["cuDNN dx"]}
    for k, name in (("K1", "convt3_dw"), ("K2", "convt3_dx")):
        r = _bound(nbytes[k], ops=[(flops, PEAK_BF16)])
        r.update(ms=cold[k], warm_ms=warm[k], plain_ms=plain[k],
                 library_ms=cold[lib[k]], warm_library_ms=warm[lib[k]],
                 bound_us=r["bound_ms"] * 1e3)
        record[name] = r
        log("{} ({}): L2-cold {:.4f} ms = {:.2f}x {} ({:.4f} ms), {:.1%} of "
            "its {:.2f} us bound ({})".format(
                k, name, cold[k], cold[k] / cold[lib[k]], lib[k],
                cold[lib[k]], r["bound_ms"] / cold[k], r["bound_us"],
                r["bound_by"]))
    # K2's floor on this card: dy read and dx written once, 16 bytes an
    # access (its bound charges the dx writes at HBM rate, though they may
    # still sit in L2 when the end event fires)
    flat_ms = cold["flat dy -> dx"]
    record["convt3_dx"]["flat_us"] = flat_ms * 1e3
    log("K2's floor, a flat read of dy and write of dx ({:.2f} MB): L2-cold "
        "{:.2f} us, warm {:.2f} us; K2 at {:.1%} of it and {:.1%} of its "
        "bound".format(2 * (dy.numel() + dx.numel()) / 1e6, flat_ms * 1e3,
                       warm["flat dy -> dx"] * 1e3, flat_ms / cold["K2"],
                       record["convt3_dx"]["bound_ms"] / cold["K2"]))
    return record


def _k2_times(C, w, dy32):
    """K2's L2-cold and warm times (ms) with bf16 operands at another
    shape, under the `default` policy as on the path."""
    from disvae_tpu_torch.ops.precision import configure
    dy = dy32.bfloat16()
    flush = _flush()
    configure("default")
    try:
        cold = time_ms(lambda: C.convt3_dx(dy, w), 20, flush)
        warm = _device_ms(lambda: C.convt3_dx(dy, w))[0]
    finally:
        configure("highest")
    return cold, warm


def phase_convt_kernels(C, probe, flat):
    """K1/K2 against their plain versions and cuDNN at the path's shapes.
    Returns the kernels' records (b256 celeba times in bf16, K2's also at
    the FactorVAE half batch, b128, and both at the b64 flagship's shape
    under `b64_celeba`). `probe` is _probe(), `flat` the path
    of its floor kernel's library."""
    flat = ctypes.CDLL(flat)
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
            record = _convt_times(C, x32, w, dy32, probe, flat)
        elif (n, h, cin, cout) == FLAGSHIP_CONVT:
            b64 = _convt_times(C, x32, w, dy32, probe, flat,
                               "the b64 btcvae_celeba flagship")
            for k in ("convt3_dw", "convt3_dx"):
                record[k]["b64_celeba"] = b64[k]
        elif (n, h, cin, cout) in COUT1_CONVT:
            key = COUT1_CONVT[n, h, cin, cout]
            times = _convt_times(C, x32, w, dy32, probe, flat,
                                 "{} (Cout = 1)".format(key))
            for k in ("convt3_dw", "convt3_dx"):
                record[k][key] = times[k]
        elif (n, h, cin, cout) == (128, 32, 32, 3):
            cold, warm = _k2_times(C, w, dy32)
            record["convt3_dx"].update(b128_ms=cold, b128_warm_ms=warm)
            log("K2 at b128 (the FactorVAE half batch): L2-cold {:.4f} ms, "
                "warm {:.4f} ms".format(cold, warm))
        del x32, w, dy32
        torch.cuda.empty_cache()
    for k in worst:
        record[k]["max_abs_err"] = worst[k]
    return record


def phase_main_path(K, scratch, smi):
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

    gathers = _native_gathers()
    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        K.log_qz.launches = 0
        for fn in gathers:
            fn.calls = 0
        t0 = time.perf_counter()
        _, evaluator = cli.main(cli.parse_arguments(
            [name, "--is-eval-only", "--is-metrics", "-l", "btcvae",
             "--no-progress-bar", "-s", str(SEED)]))
        seconds = time.perf_counter() - t0
        launches = K.log_qz.launches
        calls = {fn.__name__: fn.calls for fn in gathers}
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
    if gathers:
        batches = -(-N_DSPRITES // 1000)
        log("[{}] native gather calls in the eval: {} ({} encode batches "
            "of 1,000)".format(smi, json.dumps(calls), batches))
        if calls["gather_u8"] != batches:
            raise AssertionError("the streamed encode did not gather each "
                                 "batch natively once: {}".format(calls))
    if evaluator._resident is not None:
        raise AssertionError("`--resident-data auto` built an eval-only "
                             "upload; it streams unless handed one")
    if not all(math.isfinite(v) for v in list(metrics.values())
               + list(losses.values())):
        raise AssertionError("non-finite metrics or losses")
    if not (0 <= metrics["MIG"] <= 1 and 0 <= metrics["AAM"] <= 1):
        raise AssertionError("MIG/AAM outside [0, 1]: {}".format(metrics))
    if helpers["marginal_entropies"].shape != (10,) \
            or helpers["cond_entropies"].shape != (5, 10):
        raise AssertionError("unexpected entropy shapes")
    subset_check(evaluator.model, datasets)
    entropy_profile(evaluator, datasets)
    return exp_dir, datasets, launches, metrics, timings


def entropy_profile(evaluator, datasets):
    """The eval's entropy phase again (marginal and conditional sweeps) on
    a fresh encode of the lattice, in a torch.profiler window: its wall,
    the device's busy time and the device time by kernel."""
    ds = datasets.get_dataset("dsprites")()
    samples, params = evaluator._compute_q_zCx(
        datasets.DataLoader(ds, batch_size=1000))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluator._estimate_latent_entropies(samples, params)
        evaluator._estimate_H_zCv(samples, params, ds.lat_sizes,
                                  ds.lat_names)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top = _device_profile(prof)
    log("entropy phase profiled: wall {:.3f} s, device busy {:.3f} s "
        "(idle share {:.1%})".format(wall, busy, 1 - busy / wall)
        if busy else "entropy phase profiled: wall {:.3f} s, no device "
        "events (device time not measured)".format(wall))
    for k, ms, n in top[:8]:
        log("  {:9.3f} ms {:5d} calls  {}".format(ms, n, k[:100]))
    # the phase's host work that launches nothing: the evaluator's sample
    # draws, numpy permutations in the JAX evaluator's order
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    rng.permutation(len(ds))
    for L in ds.lat_sizes:
        for _ in range(L):
            rng.permutation(len(ds) // L)
    log("entropy phase's sample draws alone (numpy permutations, host): "
        "{:.3f} s".format(time.perf_counter() - t0))


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


def phase_eval_variants(K, scratch, exp_dir, datasets, base, base_timings):
    """The same full-lattice eval through the CLI with `--fast-metrics`,
    then with `--resident-data always` and `never`; the upload alone."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.data.resident import ResidentData
    from disvae_tpu_torch.utils.modelIO import load_metadata

    argv = [os.path.basename(exp_dir), "--is-eval-only", "--is-metrics",
            "-l", "btcvae", "--no-test", "--no-progress-bar", "-s", str(SEED)]
    K.log_qz.launches = 0
    _, ev, seconds = _cli_run(cli, scratch, argv + ["--fast-metrics"])
    if K.log_qz.launches:
        raise AssertionError("the --fast-metrics run launched K3")
    fast = load_metadata(exp_dir, filename="metrics.log")
    d_mig = abs(fast["MIG"] - base["MIG"])
    d_aam = abs(fast["AAM"] - base["AAM"])
    log("--fast-metrics eval: {:.1f} s; entropies {:.3f} s (K3 run: {:.3f} "
        "s); MIG {} AAM {}; |dMIG| {:.3e}, |dAAM| {:.3e}".format(
            seconds, ev.last_metrics_timings["entropy_seconds"],
            base_timings["entropy_seconds"], fast["MIG"], fast["AAM"],
            d_mig, d_aam))
    if not (0 <= fast["MIG"] <= 1 and 0 <= fast["AAM"] <= 1) \
            or d_mig > FAST_MIG_ATOL or d_aam > FAST_AAM_ATOL:
        raise AssertionError("--fast-metrics: {} against {}".format(fast,
                                                                    base))
    runs = {}
    for policy in ("always", "never"):
        _, ev, seconds = _cli_run(cli, scratch,
                                  argv + ["--resident-data", policy])
        runs[policy] = (load_metadata(exp_dir, filename="metrics.log"),
                        ev.last_metrics_timings["encode_seconds"])
        if (ev._resident is not None) != (policy == "always"):
            raise AssertionError("--resident-data {} fed the encode "
                                 "otherwise".format(policy))
        log("--resident-data {} eval: {:.1f} s; encode {:.3f} s; {}".format(
            policy, seconds, runs[policy][1],
            json.dumps(runs[policy][0], sort_keys=True)))
    if runs["always"][0] != runs["never"][0]:
        raise AssertionError("resident and streamed encodes gave different "
                             "metrics")
    ds = datasets.get_dataset("dsprites")()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ResidentData(ds, "cuda")
    torch.cuda.synchronize()
    log("resident upload alone (737,280 bitpacked images, 377 MB): {:.3f} "
        "s".format(time.perf_counter() - t0))


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

    from disvae_tpu_torch.serve import export_artifacts, load_artifact
    t0 = time.perf_counter()
    paths = export_artifacts(exp_dir, batch_size=64, device="cuda")
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    encode, decode = (load_artifact(p) for p in paths)
    t_load = time.perf_counter() - t0
    x, _ = ds.get_batch(np.sort(rng.choice(len(ds), 64, replace=False)))
    with torch.no_grad():
        mu, logvar = encode(torch.from_numpy(x).cuda())
        rec = decode(mu)
    r_mu, r_logvar = sm.encode(x)
    err = max(float(np.abs(a.cpu().numpy() - b).max()) for a, b in
              ((mu, r_mu), (logvar, r_logvar), (rec, sm.decode(r_mu))))
    log("export at batch 64: {:.2f} s ({}), load {:.2f} s; exported vs "
        "ServingModel max |d| {:.3e}".format(
            t_export, ", ".join("{} {:.0f} kB".format(
                os.path.basename(p), os.path.getsize(p) / 1e3)
                for p in paths), t_load, err))
    if not err <= EXPORT_ATOL:
        raise AssertionError("exported program vs eager: {}".format(err))


def _cli_run(cli, scratch, argv):
    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        t0 = time.perf_counter()
        trainer, evaluator = cli.main(cli.parse_arguments(argv))
        return trainer, evaluator, time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def _replays(trainer, what):
    """The CUDA graph replays of a Trainer's resident super-step; raises if
    it never captured or replayed one."""
    step = trainer._resident_step
    if not getattr(step, "captured", False) or step.replays < 1:
        raise AssertionError("{}: the resident super-steps did not replay "
                             "as a CUDA graph".format(what))
    return step.replays


def _read_log(exp_dir):
    with open(os.path.join(exp_dir, "train_losses.log")) as f:
        lines = f.read().strip().split("\n")
    if lines[0] != "Epoch,Loss,Value":
        raise AssertionError("train_losses.log header: {}".format(lines[0]))
    return [line.split(",") for line in lines[1:]]


def _convt_device_launches(prof):
    """(K1, K2) kernel executions on the device in a torch.profiler window:
    K1's band kernel (one per convt3_dw call, its merge kernel beside it)
    and K2's kernel, whether launched eagerly or replayed in a graph."""
    # the profiler's raw events: building its FunctionEvent tree for the
    # thousands of steps of a training run would take minutes
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    # demangled names: "void convt3_dw_band_kernel<...>(...)"
    return (sum("convt3_dw_band" in n for n in names),
            sum("convt3_dx" in n for n in names))


def phase_train(C, scratch):
    """btcvae_celeba's settings through the CLI at b256 under `default`,
    with the K1/K2 hook set, under torch.profiler. Returns K1's and K2's
    launch counts (their wrappers' counts: the eager steps and the
    captured ones), the graph's replays, the kernels' executions on the
    device (the profiler's: every step, replayed or not) and the epoch
    stats."""
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        C.convt3_dw.launches = C.convt3_dx.launches = 0
        with torch.profiler.profile(activities=acts) as prof:
            trainer, _, seconds = _cli_run(cli, scratch, [
                name, "-d", "celeba", "-l", "btcvae", "--btcvae-B", "6.4",
                "--lr", "5e-4", "-b", "256", "-e", "2",
                "--checkpoint-every", "1", "--precision", "default",
                "--no-viz-gif", "--no-progress-bar", "-s", str(SEED)])
            torch.cuda.synchronize()
        launches = (C.convt3_dw.launches, C.convt3_dx.launches)
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")

    exp_dir = os.path.join(scratch, cli.RES_DIR, name)
    steps = trainer.state.step
    stats = trainer.epoch_stats
    replays = _replays(trainer, name)
    device = _convt_device_launches(prof)
    log("train CLI (btcvae, celeba {:,} images, b256, default, K1/K2 hook,"
        " under torch.profiler): {:.1f} s in all, {} steps, K1 launches {},"
        " K2 launches {} (their wrappers' counts), {} CUDA graph replays of "
        "{} steps, K1/K2 executions on the device {} / {} (profiler)".format(
            N_CELEBA, seconds, steps, *launches, replays,
            trainer.steps_per_dispatch, *device))
    for e in stats:
        log("  epoch {}: mean loss {:.4f}, {:.0f} images/sec".format(
            e["epoch"] + 1, e["loss"], e["images_per_sec"]))
    if steps != 2 * -(-N_CELEBA // 256) or device != (steps, steps) \
            or min(launches) < 1:
        raise AssertionError("expected one K1 and one K2 execution per "
                             "train step: {} steps, executions {}, wrapper "
                             "launches {}".format(steps, device, launches))
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
    return launches, replays, device, stats


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
            # the twelve largest, and K1/K2 wherever they rank
            for k, ms, n in top[:12] + [t for t in top[12:]
                                        if "convt3_" in t[0]]:
                log("  {:9.3f} ms {:5d} calls  {}".format(ms, n, k[:110]))
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")


def _graph_cases():
    """The graph-against-eager cases the GPU tests use too
    (tests/graph_cases.py)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import graph_cases
    return graph_cases


def _graph_step_times(C, say, what, loss, wire, img_size, batch, precision,
                      hook):
    """The resident super-step of GRAPH_K steps, eager against graphed, from
    one seed each: host wall per step in turns (eager, graph, graph,
    eager; GRAPH_SUPER super-steps each), then a torch.profiler window of
    two super-steps each for the device's busy share, and the K1/K2
    kernels the window's device events show."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    G = _graph_cases()
    dev = wire.device
    idx = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, len(wire), (GRAPH_SUPER * GRAPH_K, batch))).to(dev)
    configure(precision)
    burgess.set_final_convt_impl(C.conv_transpose2d_pl if hook
                                 else burgess.conv_transpose2d)
    try:
        runs = {}
        for graph in (False, True):
            cfg, state = G.train_state(loss, dev, img_size)
            runs[graph] = (G.super_step(cfg, state, GRAPH_K, graph), state)

        def run(graph, n):
            step, state = runs[graph]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                j = i % GRAPH_SUPER * GRAPH_K
                step(state, wire, idx[j:j + GRAPH_K])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / (n * GRAPH_K) * 1e3

        run(False, 2)
        run(True, 3)  # eager warm-up, capture, replays
        times = {False: [], True: []}
        for graph in (False, True, True, False):
            times[graph].append(run(graph, GRAPH_SUPER))
        busy = {}
        for graph in (False, True):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run(graph, 2)
                wall = time.perf_counter() - t0
            seconds, top = _device_profile(prof)
            convt = {re.search(r"convt3_\w+", k).group(0): n
                     for k, _, n in top if "convt3_" in k}
            busy[graph] = (seconds, wall, convt)
            if graph:
                for k, ms, n in top[:8]:
                    say("  {}, graphed, largest device times: {:8.3f} ms "
                        "{:5d} calls  {}", what, ms, n, k[:100])
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    if not runs[True][0].captured:
        raise AssertionError("the timed super-step was never captured")

    def share(graph):
        seconds, wall, convt = busy[graph]
        if seconds == 0:
            return "device busy not measured (no device events)"
        return "device busy {:.3f} of {:.3f} ms a step ({:.1%}){}".format(
            seconds * 1e3 / (2 * GRAPH_K), wall * 1e3 / (2 * GRAPH_K),
            seconds / wall, "; K1/K2 kernels in the window: {}".format(
                json.dumps(convt)) if hook else "")
    say("{}: host ms per step, {} super-steps of {} in turns: eager {}, "
        "graph {}; profiled, eager: {}; graph: {}", what, GRAPH_SUPER,
        GRAPH_K, " / ".join("{:.4f}".format(t) for t in times[False]),
        " / ".join("{:.4f}".format(t) for t in times[True]), share(False),
        share(True))
    if hook and busy[True][0] and min(busy[True][2].values() or [0]) \
            < 2 * GRAPH_K:
        raise AssertionError("the profiled replays show no K1/K2 launch per "
                             "step: {}".format(busy[True][2]))
    return {"eager_ms": times[False], "graph_ms": times[True],
            "eager_busy": busy[False][0] / busy[False][1],
            "graph_busy": busy[True][0] / busy[True][1]}


def _graph_resume(say, wire_ds, scratch):
    """btcvae through the Trainer with the graph on, K = 4, 16 b64 batches
    an epoch: 1 epoch + resume + 1 epoch against 2 straight, bit for bit
    (state, log)."""
    from disvae_tpu_torch.data.datasets import DataLoader
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.train.trainer import Trainer
    G = _graph_cases()
    lr, cfg = G.loss_config("btcvae", n_data=len(wire_ds))

    def trainer(save_dir, resume=False):
        model = init_specific_model(
            "Burgess", (1, 64, 64), 10,
            generator=torch.Generator().manual_seed(SEED),
            device=torch.device("cuda"))
        return Trainer(model, cfg, lr=lr, seed=SEED, is_progress_bar=False,
                       save_dir=save_dir, steps_per_dispatch=4,
                       resume=resume)

    def loader():
        return DataLoader(wire_ds, batch_size=64, shuffle=True, seed=SEED)

    dirs = [os.path.join(scratch, "graph_resume", k)
            for k in ("straight", "resumed")]
    straight = trainer(dirs[0])
    straight(loader(), epochs=2, checkpoint_every=1)
    trainer(dirs[1])(loader(), epochs=1, checkpoint_every=1)
    resumed = trainer(dirs[1], resume=True)
    resumed(loader(), epochs=2, checkpoint_every=1)
    torch.cuda.synchronize()
    diff = G.differences(straight.state, resumed.state)
    logs = [open(os.path.join(d, "train_losses.log")).read() for d in dirs]
    replays = (straight._resident_step.replays,
               resumed._resident_step.replays)
    say("graph resume: 1 epoch + resume + 1 against 2 straight ({} steps, "
        "replays {}): differences {}, logs equal {}", straight.state.step,
        replays, diff, logs[0] == logs[1])
    if diff or logs[0] != logs[1] or replays != (7, 3):
        raise AssertionError("graphed resume differs: {}".format(diff))


def phase_graph(C, smi, scratch, dsprites, celeba):
    """The resident super-step as one CUDA graph: each loss at b64
    dsprites shapes under `highest`, and btcvae under `default` with the
    K1/K2 hook, graphed against eager bit for bit (K = 4, 1 eager and 3
    replayed super-steps); the b64 dsprites btcvae step (`highest`, the
    evidence run's) and the b256 celeba btcvae step (`default`, hook)
    eager against graphed in turns; a graphed Trainer resumed.
    `dsprites` and `celeba` are datasets whose wire formats are uploaded
    to the card."""
    from disvae_tpu_torch.data.resident import ResidentData
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    G = _graph_cases()
    dev = torch.device("cuda")

    def say(fmt, *args):
        log(("[{}] " + fmt).format(smi, *args))

    t0 = time.perf_counter()
    bits = ResidentData(dsprites, dev).wire
    rgb = ResidentData(celeba, dev).wire
    idx = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, len(bits), (16, 64))).to(dev)
    for loss in G.LOSSES + ["btcvae+hook"]:
        hook = loss.endswith("+hook")
        if hook:
            configure("default")
            burgess.set_final_convt_impl(C.conv_transpose2d_pl)
        before = (C.convt3_dw.launches, C.convt3_dx.launches)
        try:
            m_eager, m_graph, s_eager, s_graph, step = G.graph_against_eager(
                loss.split("+")[0], bits, idx, 4)
        finally:
            burgess.set_final_convt_impl(burgess.conv_transpose2d)
            configure("highest")
        launches = (C.convt3_dw.launches - before[0],
                    C.convt3_dx.launches - before[1])
        diff = G.differences(s_eager, s_graph)
        same = torch.equal(m_eager, m_graph)
        say("graph against eager, {} ({}), b64 dsprites, 4 super-steps of "
            "4 (replays {}): metrics bitwise {}, state differences {}{}",
            loss, "default" if hook else "highest", step.replays, same,
            diff, ", K1/K2 launches {}".format(launches) if hook else "")
        # wrapper launches: 16 eager steps, 4 eager and 4 captured ones
        if not step.captured or step.replays != 3 or not same or diff \
                or launches != ((24, 24) if hook else (0, 0)):
            raise AssertionError("the graphed super-step of {} is not the "
                                 "eager one".format(loss))
    times = {
        "b64 dsprites": _graph_step_times(
            C, say, "b64 dsprites btcvae (highest)", "btcvae", bits,
            (1, 64, 64), 64, "highest", False),
        "b256 celeba": _graph_step_times(
            C, say, "b256 celeba btcvae (default, K1/K2 hook)", "btcvae",
            rgb, (3, 64, 64), 256, "default", True)}
    from disvae_tpu_torch.data.datasets import ArrayDataset
    sub = ArrayDataset(np.asarray(dsprites.imgs[:16 * 64]))
    sub.is_binary, sub._scale = True, 1.0
    _graph_resume(say, sub, scratch)
    say("graph phase: {:.1f} s", time.perf_counter() - t0)
    return times


def phase_factor(C, scratch):
    """FactorVAE through the CLI on the same subset: b128 and 1 epoch,
    doubled by the CLI to b256 and 2 epochs; K1/K2 on the half batch. Run
    without the training gif, then with it (each frame timed)."""
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.utils.modelIO import load_metadata
    from disvae_tpu_torch.utils.visualize import GifTraversalsTraining
    from disvae_tpu_torch.utils.viz_helpers import GIF_MAX_ERR

    frame_ms, rendered = [], []

    class TimedGif(GifTraversalsTraining):
        def __call__(self, model):
            t0 = time.perf_counter()
            super().__call__(model)
            frame_ms.append((time.perf_counter() - t0) * 1e3)

        def save_reset(self):
            rendered.extend(self.images)
            super().save_reset()

    for gif in (False, True):
        name = "chip_smoke_factor_celeba" + ("" if gif else "_nogif")
        burgess.set_final_convt_impl(C.conv_transpose2d_pl)
        cli.GifTraversalsTraining = TimedGif
        try:
            C.convt3_dw.launches = C.convt3_dx.launches = 0
            trainer, _, seconds = _cli_run(cli, scratch, [
                name, "-d", "celeba", "-l", "factor", "--factor-G", "6.4",
                "--lr", "1e-4", "--lr-disc", "1e-5", "-b", "128", "-e", "1",
                "--precision", "default", "--no-progress-bar", "-s",
                str(SEED)] + ([] if gif else ["--no-viz-gif"]))
            launches = (C.convt3_dw.launches, C.convt3_dx.launches)
        finally:
            cli.GifTraversalsTraining = GifTraversalsTraining
            burgess.set_final_convt_impl(burgess.conv_transpose2d)
            configure("highest")
        exp_dir = os.path.join(scratch, cli.RES_DIR, name)
        log("factor CLI (celeba, b128 -> b256, 2 epochs, {}): {:.1f} s, {} "
            "steps, K1 launches {}, K2 launches {}, {} CUDA graph replays; "
            "epochs {}".format(
                "with the training gif" if gif else "--no-viz-gif", seconds,
                trainer.state.step, *launches, _replays(trainer, name),
                ", ".join(
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
        log("factor train_losses.log, epoch 1: loss {loss}, tc_loss "
            "{tc_loss}, discrim_loss {discrim_loss}".format(**last))

    path = os.path.join(exp_dir, "training.gif")
    frames, delays, loop = read_gif(path)
    n_epochs = len(trainer.epoch_stats)
    if len(frames) != n_epochs or len(rendered) != n_epochs \
            or any(f.shape != (662, 662, 3) for f in frames) \
            or delays != [8] * n_epochs or loop != 0:
        raise AssertionError("training.gif: {} frames of {}, delays {}, "
                             "loop {}; {} epochs".format(
                                 len(frames), frames[0].shape, delays, loop,
                                 n_epochs))
    err = max(_max_diff(a, b) for a, b in zip(frames, rendered))
    if err > GIF_MAX_ERR:
        raise AssertionError("training.gif frames decode {} away from the "
                             "rendered ones".format(err))
    log("training.gif: {} frames of 662 x 662 RGB ({:.0f} kB), {} ms per "
        "frame to render, decoded within {} of the rendered frames "
        "(palette bound {})".format(
            len(frames), os.path.getsize(path) / 1e3,
            " / ".join("{:.2f}".format(t) for t in frame_ms), err,
            GIF_MAX_ERR))


def _write_kl_log(exp_dir, datasets):
    """A train_losses.log for a checkpoint that was never trained: one
    epoch of per-dimension KLs of its posteriors over 1,000 dataset images
    (the traversal rows are ordered by them)."""
    from disvae_tpu_torch.utils.modelIO import load_metadata, load_model
    model = load_model(exp_dir, device="cuda")
    ds = datasets.get_dataset(load_metadata(exp_dir)["dataset"])()
    x, _ = ds.get_batch(np.linspace(0, len(ds) - 1, 1000).astype(np.int64))
    with torch.no_grad():
        mu, logvar = model.encode(torch.from_numpy(x).cuda())
        kl = (0.5 * (mu ** 2 + logvar.exp() - logvar - 1)).mean(0)
    with open(os.path.join(exp_dir, "train_losses.log"), "w") as f:
        f.write("Epoch,Loss,Value\n")
        for d, v in enumerate(kl.tolist()):
            f.write("0,kl_loss_{},{}\n".format(d, v))


def phase_viz(scratch, runs, datasets):
    """cli_viz `all` on each (name, dataset) run, prior and posterior,
    with seconds per plot; geometry, decoding and CPU-vs-card checks."""
    from disvae_tpu_torch import cli, cli_viz

    for name, dataset in runs:
        exp_dir = os.path.join(scratch, cli.RES_DIR, name)
        if not os.path.exists(os.path.join(exp_dir, "train_losses.log")):
            _write_kl_log(exp_dir, datasets)
        for flags in ([], ["--is-posterior"]):
            cwd = os.getcwd()
            os.chdir(scratch)
            try:
                seconds = cli_viz.main(cli_viz.parse_arguments(
                    [name, "all", "-s", str(SEED), "--is-show-loss"] + flags))
            finally:
                os.chdir(cwd)
            log("viz {} ({}): {}".format(name, "posterior" if flags else
                                          "prior", ", ".join(
                                              "{} {:.3f} s".format(k, v)
                                              for k, v in seconds.items())))
        _viz_checks(exp_dir, name, dataset, px=64)
    _no_image_libraries("the viz path", sys.modules)


def _no_image_libraries(what, modules, tag=""):
    """Raise if any of PIL, imageio or pandas is among `modules` (module
    names); `tag` prefixes the line logged."""
    loaded = sorted({m.split(".")[0] for m in modules}
                    & {"PIL", "imageio", "pandas"})
    if loaded:
        raise AssertionError("{} loaded {}".format(what, loaded))
    log("{}{}: PIL, imageio and pandas never imported".format(tag, what))


def _viz_checks(exp_dir, name, dataset, px, tag=""):
    """The files of `cli_viz <name> all -s SEED --is-show-loss`, prior and
    posterior, at the JAX package's geometry for px-pixel cells (-r 6 -c
    7); prior_traversals.png decodes to the card's render, which the CPU's
    matches within 1; the posterior gif, rendered again from the CLI's
    samples, is the CLI's bytes and decodes to the rendered frames (grey
    exactly, RGB within the palette bound)."""
    from disvae_tpu_torch.utils.helpers import set_seed
    from disvae_tpu_torch.utils.modelIO import load_model
    from disvae_tpu_torch.utils.visualize import Visualizer
    from disvae_tpu_torch.utils.viz_helpers import GIF_MAX_ERR, get_samples

    grid = _grid_shape(VIZ_ROWS, VIZ_COLS, px)
    expect = {f: grid for f in ("samples.png", "data_samples.png",
                                "reconstruct.png", "prior_traversals.png",
                                "posterior_traversals.png")}
    expect["reconstruct_traverse.png"] = (
        _grid_shape(2, VIZ_COLS, px)[0] + grid[0], grid[1] + 100)
    gif_shape = grid + (3,)
    for f, shape in expect.items():
        img = read_png(os.path.join(exp_dir, f))
        if img.shape != shape + (3,):
            raise AssertionError("{}/{}: {} != {}".format(
                name, f, img.shape, shape + (3,)))
    gif_path = os.path.join(exp_dir, "posterior_traversals.gif")
    frames, delays, loop = read_gif(gif_path)
    if len(frames) != VIZ_GIF_FRAMES or frames[0].shape != gif_shape \
            or delays != [8] * VIZ_GIF_FRAMES or loop != 0:
        raise AssertionError("{} posterior gif: {} frames of {}".format(
            name, len(frames), frames[0].shape))

    # the prior traversals: the written PNG is the card's render, which
    # the CPU's render matches within 1
    renders = {}
    for dev in ("cuda", "cpu"):
        viz = Visualizer(load_model(exp_dir, device=dev), dataset,
                         exp_dir, save_images=False,
                         loss_of_interest="kl_loss_", max_traversal=2)
        renders[dev] = viz.traversals(is_reorder_latents=True,
                                      n_per_latent=VIZ_COLS,
                                      n_latents=VIZ_ROWS)
    png = read_png(os.path.join(exp_dir, "prior_traversals.png"))
    if not np.array_equal(png, renders["cuda"]):
        raise AssertionError("{}: prior_traversals.png does not decode "
                             "to the card's render".format(name))
    d_cpu = _max_diff(renders["cuda"], renders["cpu"])
    # the posterior gif again from the CLI's samples: the same bytes,
    # decoding to the rendered frames (grey exactly)
    with open(gif_path, "rb") as f:
        cli_bytes = f.read()
    set_seed(SEED)
    samples = get_samples(dataset, VIZ_ROWS * VIZ_COLS)
    viz = Visualizer(load_model(exp_dir, device="cuda"), dataset,
                     exp_dir, loss_of_interest="kl_loss_",
                     max_traversal=2)
    rendered = viz.gif_traversals(samples[:VIZ_COLS], n_latents=VIZ_ROWS)
    with open(gif_path, "rb") as f:
        same = f.read() == cli_bytes
    frames, _, _ = read_gif(gif_path)
    err = max(_max_diff(a, b) for a, b in zip(frames, rendered))
    grey = all((r[..., 0] == r[..., 2]).all() for r in rendered)
    bound = 0 if grey else GIF_MAX_ERR
    log(tag + "viz {}: prior traversals card vs CPU max |d| {} (uint8); PNG "
        "decodes exactly; posterior gif {} frames ({:.0f} kB), rerender {} "
        "the CLI's bytes, decoded within {} ({} bound {})".format(
            name, d_cpu, len(frames), len(cli_bytes) / 1e3,
            "equals" if same else "differs from", err,
            "grey" if grey else "RGB", bound))
    if d_cpu > 1 or not same or err > bound:
        raise AssertionError("viz checks failed for {}".format(name))


def zoo_specs(jax_run):
    """The specs.json of the JAX run artifacts/<jax_run>/."""
    with open(os.path.join(REPO, "artifacts", jax_run, "specs.json")) as f:
        return json.load(f)


def zoo_flags(name, jax_run, gif):
    """Phase 17's CLI flags for run `name`: every setting that defines the
    JAX run artifacts/<jax_run>/, from its specs.json, then the phase's
    own: the name, 2 epochs, no progress bar and, unless `gif`,
    --no-viz-gif. No -x: a named experiment's INI would override them."""
    specs = zoo_specs(jax_run)
    # a FactorVAE run's specs hold the batch the CLI doubled
    batch = specs["batch_size"] // (2 if specs["loss"] == "factor" else 1)
    flags = [name, "-d", specs["dataset"], "-l", specs["loss"],
             "-m", specs["model_type"], "-z", str(specs["latent_dim"]),
             "-r", specs["rec_dist"], "-a", repr(specs["reg_anneal"]),
             "--lr", repr(specs["lr"]), "-b", str(batch),
             "--precision", specs["precision"], "-s", str(specs["seed"])]
    for key in LOSS_COEFS[specs["loss"]]:
        flags += ["--" + key.replace("_", "-"), repr(specs[key])]
    flags += ["--checkpoint-every", str(specs["checkpoint_every"]),
              "-e", str(ZOO_EPOCHS), "--no-progress-bar"]
    return flags + ([] if gif else ["--no-viz-gif"])


def _log_losses(path):
    """{epoch: the `loss` row} of a train_losses.log."""
    with open(path) as f:
        return {int(e): float(v) for e, k, v in
                (line.strip().split(",") for line in f.readlines()[1:])
                if k == "loss"}


def _imported(stderr):
    """The modules a `python -X importtime` process imported, from its
    stderr."""
    return [line.rsplit("|", 1)[1].strip() for line in stderr.splitlines()
            if line.startswith("import time:") and "|" in line
            and not line.rstrip().endswith("imported package")]


def _zoo_after(name, loss, env, scratch):
    """The eval-only CLI and cli_viz `all`, prior then posterior, on a
    trained run, as subprocesses; returns [(argv, seconds, stderr)]."""
    out = []
    for argv in (["disvae_tpu_torch", name, "--is-eval-only", "-l", loss,
                  "--no-progress-bar"],
                 ["disvae_tpu_torch.cli_viz", name, "all", "-s", str(SEED),
                  "--is-show-loss"],
                 ["disvae_tpu_torch.cli_viz", name, "all", "-s", str(SEED),
                  "--is-show-loss", "--is-posterior"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-X", "importtime", "-m"]
                              + argv, cwd=scratch, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError("{} exited {}:\n{}".format(
                " ".join(argv), proc.returncode, "\n".join(
                    l for l in proc.stderr.splitlines()
                    if not l.startswith("import time:"))[-3000:]))
        out.append((argv, time.perf_counter() - t0, proc.stderr))
    return out


def phase_zoo(C, scratch, smi):
    """Phase 17: VAE, betaH and betaB, on mnist, fashion and chairs,
    through the CLIs with the K1/K2 hook: each run of ZOO_RUNS trains with
    its JAX run's settings for 2 epochs in process, then the eval-only CLI
    and cli_viz run as `python -m` subprocesses, the three runs' at once.
    Returns {run: K1/K2 wrapper launches, executions on the device (the
    profiler's), replays and steps}."""
    t_phase = time.perf_counter()
    root = os.path.join(scratch, "data")
    os.environ["DISVAE_DATA_ROOT"] = root  # as phase 5 sets it
    from disvae_tpu_torch import cli
    from disvae_tpu_torch.data import datasets
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.utils.modelIO import load_metadata
    from disvae_tpu_torch.utils.visualize import GifTraversalsTraining
    if datasets.DATA_ROOT != root:
        raise AssertionError("the dataset module reads {}, not {}".format(
            datasets.DATA_ROOT, root))

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", script), "--root",
         os.path.join(root, ds)] + flags, stdout=subprocess.DEVNULL)
        for ds, (script, flags) in ZOO_DATA.items()]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise AssertionError("fabricating {} exited {}".format(
            list(ZOO_DATA), rcs))
    t_fab = time.perf_counter() - t0
    log("[{}] phase 17: fabricated {} in {:.1f} s (at once)".format(
        smi, ", ".join("{} ({:,} images)".format(
            ds, len(datasets.get_dataset(ds)())) for ds in ZOO_DATA),
        t_fab))

    rendered = []

    class KeptGif(GifTraversalsTraining):
        def save_reset(self):
            rendered[:] = self.images
            super().save_reset()

    dw, dx = C.convt3_dw, C.convt3_dx
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    shapes = set()

    def convt_seen(x, w, b):
        """The hook, noting the (x, dy) shapes its backward gets."""
        y = C.conv_transpose2d_pl(x, w, b)
        if y.requires_grad:
            y.register_hook(lambda dy: shapes.add((tuple(x.shape),
                                                   tuple(dy.shape))))
        return y

    record, t_train, t_prof = {}, {}, {}
    for name, jax_run, gif in ZOO_RUNS:
        specs = zoo_specs(jax_run)
        burgess.set_final_convt_impl(convt_seen)
        cli.GifTraversalsTraining = KeptGif
        shapes.clear()
        try:
            dw.launches = dx.launches = 0
            with torch.profiler.profile(activities=acts) as prof:
                trainer, _, seconds = _cli_run(cli, scratch, zoo_flags(
                    name, jax_run, gif))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            launches = (dw.launches, dx.launches)
        finally:
            cli.GifTraversalsTraining = GifTraversalsTraining
            burgess.set_final_convt_impl(burgess.conv_transpose2d)
            configure("highest")
        t_train[name] = seconds
        exp_dir = os.path.join(scratch, cli.RES_DIR, name)
        n = len(datasets.get_dataset(specs["dataset"])())
        B, k = specs["batch_size"], trainer.steps_per_dispatch
        steps = trainer.state.step
        replays = _replays(trainer, name)
        executions = _convt_device_launches(prof)
        t_prof[name] = time.perf_counter() - t0
        c, h = trainer.model.img_size[:2]
        want = ((B, 32, h // 2, h // 2), (B, c, h, h))
        log("[{}] {} ({} {}, {:,} images, b{}, {}, K1/K2 hook, under "
            "torch.profiler): {:.1f} s, {} steps, K1/K2 wrapper launches {} "
            "/ {}, {} CUDA graph replays of {}, executions on the device {} "
            "/ {} (profiler; its stop and the count {:.1f} s); (x, dy) into "
            "K1/K2 {}".format(
                smi, name, specs["loss"], specs["dataset"], n, B,
                specs["precision"], seconds, steps, *launches, replays, k,
                *executions, t_prof[name], sorted(shapes)))
        if steps != ZOO_EPOCHS * -(-n // B) or executions != (steps, steps) \
                or min(launches) < 1 or want not in shapes \
                or any(x[1:] != want[0][1:] or dy[1:] != want[1][1:]
                       for x, dy in shapes):
            raise AssertionError("{}: expected one K1 and one K2 execution "
                                 "per step at x {}, dy {}".format(
                                     name, *want))
        rows = _read_log(exp_dir)
        if sorted({r[0] for r in rows}) != ["0", "1"] \
                or not all(math.isfinite(float(r[2])) for r in rows):
            raise AssertionError("{} train_losses.log rows: {}".format(
                name, rows[:3]))
        stats = trainer.epoch_stats
        ours = _log_losses(os.path.join(exp_dir, "train_losses.log"))
        ref = _log_losses(os.path.join(REPO, "artifacts", jax_run,
                                       "train_losses.log"))
        for e in stats:
            i = e["epoch"]
            gap = (ours[i] - ref[i]) / abs(ref[i])
            log("[{}]   {} epoch {}: mean loss {:.4f} ({:.0f} images/sec); "
                "train_losses.log loss {:.4f} against {}'s {:.4f}: {:+.2%}"
                "{}".format(smi, name, i, e["loss"], e["images_per_sec"],
                            ours[i], jax_run, ref[i], gap,
                            " (beyond {:.0%}: a result fault to hunt)".format(
                                ZOO_GAP) if i == 1 and abs(gap) > ZOO_GAP
                            else ""))
        if not stats[1]["loss"] < stats[0]["loss"]:
            raise AssertionError("{}: the epoch loss did not fall: {}".format(
                name, stats))
        for f in ("train_losses.log", "specs.json", "model.pt",
                  "train_state.pt", "test_losses.log"):
            if not os.path.exists(os.path.join(exp_dir, f)):
                raise AssertionError("{}: missing artifact {}".format(name, f))
        losses = load_metadata(exp_dir, filename="test_losses.log")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError("{}: non-finite test losses".format(name))
        os.remove(os.path.join(exp_dir, "test_losses.log"))
        if gif:
            frames, delays, loop = read_gif(os.path.join(exp_dir,
                                                         "training.gif"))
            side = 10 * (trainer.model.img_size[1] + 2) + 2
            if len(frames) != ZOO_EPOCHS or len(rendered) != ZOO_EPOCHS \
                    or any(f.shape != (side, side, 3) for f in frames) \
                    or delays != [8] * ZOO_EPOCHS or loop != 0 \
                    or any(_max_diff(a, b) for a, b in zip(frames,
                                                           rendered)):
                raise AssertionError("{} training.gif: {} frames of {}, "
                                     "delays {}, loop {}".format(
                                         name, len(frames), frames[0].shape,
                                         delays, loop))
            log("[{}]   {} training.gif: {} frames of {} x {} grey, decoded "
                "exactly".format(smi, name, len(frames), side, side))
        record[name] = dict(launches=launches, device_launches=executions,
                            graph_replays=replays, steps=steps)

    # the eval-only CLI and cli_viz, each run's three in turn, the runs at
    # once
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(C.__file__)))))
    after, errors = {}, []

    def chain(name, loss):
        try:
            after[name] = _zoo_after(name, loss, env, scratch)
        except Exception as e:  # re-raised below, after every chain ended
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=chain, args=(
        name, zoo_specs(jax_run)["loss"])) for name, jax_run, _ in ZOO_RUNS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_after = time.perf_counter() - t0
    if errors:
        raise errors[0]
    t0 = time.perf_counter()
    for name, jax_run, _ in ZOO_RUNS:
        specs = zoo_specs(jax_run)
        exp_dir = os.path.join(scratch, cli.RES_DIR, name)
        losses = load_metadata(exp_dir, filename="test_losses.log")
        log("[{}] {}: eval-only CLI {:.1f} s, test loss {}; cli_viz all "
            "{:.1f} s, --is-posterior {:.1f} s".format(
                smi, name, after[name][0][1], losses["loss"],
                after[name][1][1], after[name][2][1]))
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError("{}: non-finite eval-only test losses"
                                 .format(name))
        tag = "[{}] ".format(smi)
        for argv, _, stderr in after[name]:
            _no_image_libraries(" ".join(argv), _imported(stderr), tag)
        _viz_checks(exp_dir, name, specs["dataset"],
                    px=specs["img_size"][1], tag=tag)
    _no_image_libraries("phase 17's process", sys.modules, tag)
    log("[{}] phase 17: {:.1f} s in all: fabrication {:.1f} s, training {} "
        "(in turn), the profiler's stop and count {:.1f} s, eval-only and "
        "cli_viz {:.1f} s (the runs at once), checks {:.1f} s".format(
            smi, time.perf_counter() - t_phase, t_fab, ", ".join(
                "{} {:.1f} s".format(k, v) for k, v in t_train.items()),
            sum(t_prof.values()), t_after, time.perf_counter() - t0))
    return record


def _native_gathers():
    """The native gather's three functions, or () for a checkout without
    `disvae_tpu_torch/native` (an older commit under --package-root)."""
    if importlib.util.find_spec("disvae_tpu_torch.native") is None:
        return ()
    from disvae_tpu_torch import native
    return (native.gather_u8_f32, native.gather_u8_mul, native.gather_u8)


def phase_evidence(scratch, smi, package_root):
    """Phase 18: the flagship's evidence CLI, `python -m
    disvae_tpu_torch.evidence ... --skip-metrics --profile-epoch 0`, with
    the settings of the JAX flagship artifacts/btcvae_celeba_tpu/ (b64,
    `default`, no gif) for 1 epoch on phase 7's celeba subset, once with
    `--final-convt kernels` and once with `cudnn`, the two at once. Checks
    device.json: the option, the card, the resident feed and the graph,
    and K1's and K2's executions (the wrappers' launches less the captured
    ones, plus one per replayed step) equal to the optimizer steps and to
    their executions among the profiled epoch's device events with the
    kernels, and zero of each with cudnn; the specs equal but for the
    name; finite test losses. Returns the kernels run's train_leg
    record."""
    t0 = time.perf_counter()
    flags = zoo_flags("-", "btcvae_celeba_tpu", False)[1:] + ["-e", "1"]
    env = dict(os.environ, PYTHONPATH=package_root)
    procs = {}
    for final_convt in ("kernels", "cudnn"):
        name = "chip_smoke_evidence_" + final_convt
        procs[final_convt] = subprocess.Popen(
            [sys.executable, "-m", "disvae_tpu_torch.evidence", name,
             "custom", "-s", str(SEED), "--skip-metrics", "--final-convt",
             final_convt, "--profile-epoch", "0", "--out",
             os.path.join(scratch, name), "--train-flags",
             " ".join(flags)], cwd=scratch, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    outs = {k: p.communicate()[0] for k, p in procs.items()}
    seconds = time.perf_counter() - t0
    bad = {k: out[-3000:] for k, out in outs.items()
           if procs[k].returncode}
    if bad:
        raise AssertionError("the evidence CLI failed: {}".format(bad))
    sets = {}
    for final_convt in procs:
        out = os.path.join(scratch, "chip_smoke_evidence_" + final_convt)
        with open(os.path.join(out, "device.json")) as f:
            device = json.load(f)
        with open(os.path.join(out, "specs.json")) as f:
            specs = json.load(f)
        with open(os.path.join(out, "test_losses.log")) as f:
            losses = json.load(f)
        sets[final_convt] = device, specs, losses
        leg = device["train_leg"]
        prof = leg["profiled_epoch"] or {}
        counts = [(leg[k]["executions"], prof.get(k))
                  for k in ("convt3_dw", "convt3_dx")]
        log("[{}] phase 18: evidence --final-convt {} (b64 btcvae_celeba "
            "settings, {:,} images, 1 epoch): {} steps, resident {}, graph "
            "{}, K1/K2 wrapper launches {} / {} ({} / {} captured), "
            "executions {} / {} (profiled epoch: {} / {} device events of "
            "{} steps), convt3_bwd calls {}, {:.0f} images/sec; legs {}; "
            "test loss {:.4f}".format(
                smi, final_convt, N_CELEBA, leg["steps"], leg["resident"],
                leg["graph"], leg["convt3_dw"]["launches"],
                leg["convt3_dx"]["launches"], leg["convt3_dw"]["captured"],
                leg["convt3_dx"]["captured"], *[c[0] for c in counts],
                *[c[1] for c in counts], prof.get("steps"),
                leg["convt3_bwd_calls"], leg["epoch_images_per_sec"][0],
                {k: round(v, 1) for k, v in device["leg_seconds"].items()},
                losses["loss"]))
        steps = leg["steps"]
        want = steps if final_convt == "kernels" else 0
        if device["final_convt"] != final_convt \
                or smi.split(",")[0] not in device["nvidia_smi"] \
                or steps != -(-N_CELEBA // 64) or not leg["resident"] \
                or not leg["graph"] or not leg["graph"]["replayed_steps"] \
                or prof.get("steps") != steps \
                or counts != [(want, want)] * 2 \
                or leg["convt3_bwd_calls"] != (
                    leg["convt3_dw"]["launches"] if want else 0) \
                or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError("phase 18, --final-convt {}: {}".format(
                final_convt, device))
    specs = [{k: v for k, v in sets[c][1].items() if k != "name"}
             for c in procs]
    if specs[0] != specs[1]:
        raise AssertionError("phase 18: the two runs' specs differ: {}"
                             .format(specs))
    log("[{}] phase 18: {:.1f} s (the two runs at once)".format(smi,
                                                                seconds))
    factor = _evidence_factor(scratch, smi, env)
    log("[{}] phase 18: {:.1f} s in all".format(
        smi, time.perf_counter() - t0))
    return sets["kernels"][0]["train_leg"], factor


def factor_evidence_flags():
    """Phase 18's FactorVAE train flags: the JAX run FACTOR_EVIDENCE's
    settings (zoo_flags) for `-e 1`, which the CLI doubles to 2 epochs."""
    return zoo_flags("-", FACTOR_EVIDENCE, False)[1:] + ["-e", "1"]


def _evidence_factor(scratch, smi, env):
    """Phase 18's FactorVAE run: the evidence CLI with the settings of the
    JAX run FACTOR_EVIDENCE for 1 epoch (doubled to 2 of 469 steps at
    b128) on phase 17's mnist, `--final-convt kernels --profile-epoch 0`.
    Checks device.json: the card, the resident feed and a replayed graph,
    K1's and K2's executions equal to the steps (one each per step: only
    the first half batch goes through the decoder) and to the profiled
    epoch's device events; finite VAE and discriminator losses in every
    epoch, finite test losses; the specs the JAX run's but for the name,
    the epochs and the experiment (`custom`: the INI's would set 400
    epochs). Prints the graphed step's ms, from epoch 1's images/sec (all
    replays but the short super-step and the tail, not profiled: the
    profiler's start alone takes seconds), and the device's busy ms a
    step in the profiled epoch 0 against it. Returns the train leg's
    record."""
    t0 = time.perf_counter()
    name = "chip_smoke_evidence_factor"
    out = os.path.join(scratch, name)
    proc = subprocess.run(
        [sys.executable, "-m", "disvae_tpu_torch.evidence", name, "custom",
         "-s", str(SEED), "--skip-metrics", "--final-convt", "kernels",
         "--profile-epoch", "0", "--out", out, "--train-flags",
         " ".join(factor_evidence_flags())], cwd=scratch, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError("phase 18, factor: the evidence CLI failed: {}"
                             .format(proc.stdout[-3000:]))
    with open(os.path.join(out, "device.json")) as f:
        device = json.load(f)
    with open(os.path.join(out, "specs.json")) as f:
        specs = json.load(f)
    with open(os.path.join(out, "test_losses.log")) as f:
        losses = json.load(f)
    rows = _read_log(out)
    leg, prof = device["train_leg"], device["train_leg"]["profiled_epoch"]
    ref = zoo_specs(FACTOR_EVIDENCE)
    with np.load(os.path.join(os.environ["DISVAE_DATA_ROOT"], "mnist",
                              "train32.npz")) as z:
        n = len(z["labels"])
    per_epoch = -(-n // ref["batch_size"])
    step_ms = n / leg["epoch_images_per_sec"][1] / per_epoch * 1e3
    busy_ms = prof["device_busy_seconds"] / prof["steps"] * 1e3
    log("[{}] phase 18: evidence factor (factor_mnist settings, {:,} "
        "images, b{}, 2 epochs): {} steps, resident {}, graph {}, K1/K2 "
        "wrapper launches {} / {} ({} / {} captured), executions {} / {} "
        "(profiled epoch 0: {} / {} device events of {} steps); graphed "
        "FactorVAE step {:.4f} ms (epoch 1), device busy {:.4f} ms a step "
        "in epoch 0 ({:.1%} of it); epoch images/sec {}; legs {}; test "
        "loss {:.4f}; {:.1f} s".format(
            smi, n, specs["batch_size"], leg["steps"], leg["resident"],
            leg["graph"], leg["convt3_dw"]["launches"],
            leg["convt3_dx"]["launches"], leg["convt3_dw"]["captured"],
            leg["convt3_dx"]["captured"], leg["convt3_dw"]["executions"],
            leg["convt3_dx"]["executions"], prof["convt3_dw"],
            prof["convt3_dx"], prof["steps"], step_ms, busy_ms,
            busy_ms / step_ms,
            [round(v) for v in leg["epoch_images_per_sec"]],
            {k: round(v, 1) for k, v in device["leg_seconds"].items()},
            losses["loss"], seconds))
    steps = leg["steps"]
    bad = []
    if device["final_convt"] != "kernels" \
            or smi.split(",")[0] not in device["nvidia_smi"] \
            or steps != 2 * per_epoch or not leg["resident"] \
            or not (leg["graph"] or {}).get("replayed_steps"):
        bad.append("the run")
    if [leg[k]["executions"] for k in ("convt3_dw", "convt3_dx")] \
            != [steps] * 2 \
            or (prof["epoch"], prof["steps"]) != (0, per_epoch) \
            or [prof["convt3_dw"], prof["convt3_dx"]] != [per_epoch] * 2:
        bad.append("K1/K2 executions")
    for key in ("loss", "discrim_loss"):
        vals = {e: float(v) for e, k, v in rows if k == key}
        if sorted(vals) != ["0", "1"] or not all(
                math.isfinite(v) for v in vals.values()):
            bad.append("{} rows {}".format(key, vals))
    if not all(math.isfinite(v) for v in losses.values()):
        bad.append("test losses")
    skip = ("name", "epochs", "experiment")
    if {k: v for k, v in specs.items() if k not in skip} \
            != {k: v for k, v in ref.items() if k not in skip} \
            or specs["epochs"] != 2:
        bad.append("specs")
    if bad:
        raise AssertionError("phase 18, factor: {}: {}".format(bad, device))
    return leg


def phase_native(scratch, smi, datasets, eval_run, build_seconds):
    """The native host gather: get_batch, get_batch_raw and
    get_batch_bits bitwise equal to numpy (the same methods on the numpy
    branch) on 1,000 seeded random indices of the memmapped dsprites
    lattice and of the celeba subset; host ms per b256 batch, native
    at its thread count and at N_THREADS against numpy, median of 20;
    then phase 5's streamed eval with numpy gathers against it with the
    native gather, in turns (native, numpy, numpy, native): MIG and AAM
    bitwise equal, the encode seconds of each."""
    from disvae_tpu_torch import cli, native
    from disvae_tpu_torch.utils.modelIO import load_metadata

    def say(fmt, *args):
        log("[{}] {}".format(smi, fmt.format(*args)))

    say("native gather built with g++ (-O3; up to {} threads a call, one "
        "per {} MB written) in {:.2f} s in phase 2", native.N_THREADS,
        native.BYTES_PER_THREAD >> 20, build_seconds)
    rng = np.random.default_rng(SEED)
    for name in ("dsprites", "celeba"):
        ds = datasets.get_dataset(name)()
        ref = datasets.get_dataset(name)()
        ref._native = lambda: False  # the same methods' numpy branch
        if not ds._native() or not isinstance(ds.imgs, np.memmap):
            raise AssertionError("the {} store is not a C-contiguous uint8 "
                                 "memmap".format(name))
        idcs = rng.integers(0, len(ds), 1000)
        for method in ("get_batch", "get_batch_raw", "get_batch_bits"):
            got = getattr(ds, method)(idcs)[0]
            want = getattr(ref, method)(idcs)[0]
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError("native {}.{} differs from numpy"
                                     .format(name, method))
        times = {}
        per_thread = native.BYTES_PER_THREAD
        for method in ("get_batch", "get_batch_raw"):
            # the native gather at its own thread count, at N_THREADS
            # whatever the bytes, and numpy
            for who, d, bytes_per_thread in (
                    ("native", ds, per_thread), ("all", ds, 1),
                    ("numpy", ref, per_thread)):
                native.BYTES_PER_THREAD = bytes_per_thread
                ms = []
                try:
                    for _ in range(20):
                        batch = rng.integers(0, len(ds), 256)
                        t0 = time.perf_counter()
                        getattr(d, method)(batch)
                        ms.append((time.perf_counter() - t0) * 1e3)
                finally:
                    native.BYTES_PER_THREAD = per_thread
                times[method, who] = statistics.median(ms)
            # the gather writes float32 rows for get_batch, uint8 otherwise
            times[method] = native.threads(256 * ds.imgs[0].nbytes * (
                4 if method == "get_batch" else 1))
        say("native gather, {} ({:,} images, memmap): get_batch, "
            "get_batch_raw and get_batch_bits bitwise equal to numpy on "
            "1,000 random indices; host ms per b256 batch, median of 20, "
            "native at its thread count / native at {} threads / numpy: "
            "get_batch ({} thread(s)) {:.3f} / {:.3f} / {:.3f}, get_batch_raw "
            "({}, {} thread(s)) {:.3f} / {:.3f} / {:.3f}", name, len(ds),
            native.N_THREADS, times["get_batch"],
            times["get_batch", "native"], times["get_batch", "all"],
            times["get_batch", "numpy"],
            "bits" if ds.is_binary else "bytes", times["get_batch_raw"],
            times["get_batch_raw", "native"], times["get_batch_raw", "all"],
            times["get_batch_raw", "numpy"])

    exp_dir, metrics, _ = eval_run
    argv = [os.path.basename(exp_dir), "--is-eval-only", "--is-metrics",
            "-l", "btcvae", "--no-test", "--no-progress-bar", "-s", str(SEED)]
    runs = {"native": [], "numpy": []}
    native_method = datasets.BaseDataset._native
    for who in ("native", "numpy", "numpy", "native"):
        if who == "numpy":
            datasets.BaseDataset._native = lambda self: False
        try:
            _, ev, _ = _cli_run(cli, scratch, argv)
        finally:
            datasets.BaseDataset._native = native_method
        got = load_metadata(exp_dir, filename="metrics.log")
        runs[who].append(ev.last_metrics_timings["encode_seconds"])
        if (got["MIG"], got["AAM"]) != (metrics["MIG"], metrics["AAM"]):
            raise AssertionError("the {} eval's MIG/AAM {} differ from "
                                 "phase 5's {}".format(who, got, metrics))
    say("streamed MIG/AAM eval (dsprites 737,280 images, in turns: native, "
        "numpy, numpy, native): encode {} s with the native gather, {} s "
        "with numpy; MIG {} AAM {}, bitwise phase 5's in every run",
        " / ".join("{:.3f}".format(t) for t in runs["native"]),
        " / ".join("{:.3f}".format(t) for t in runs["numpy"]),
        metrics["MIG"], metrics["AAM"])



def _dp_cases():
    """The data-parallel cases the GPU tests use too (tests/dp_cases.py)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import dp_cases
    return dp_cases


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_parity(mesh, say):
    """One DP step and one plain step from the same state on the same b256
    celeba batch and pinned noise, under `highest`: btcvae and FactorVAE."""
    from disvae_tpu_torch.train.steps import make_train_step
    cases = _dp_cases()
    dev = torch.device("cuda")
    batch = cases.celeba_batch(256, dev)
    for loss in ("btcvae", "factor"):
        cfg, plain = cases.celeba_state(loss, dev)
        _, dp = cases.celeba_state(loss, dev)
        noise = cases.pinned_noise(cfg, 256, dev)
        want = make_train_step(cfg)(plain, batch, noise)
        got = make_train_step(cfg, mesh)(dp, batch, noise)
        torch.cuda.synchronize()
        d_metrics = max(abs(float(got[k]) - float(want[k]))
                        / max(abs(float(want[k])), 1e-30) for k in want)
        d_state, equal = cases.state_diff(plain, dp)
        say("DP {} step at b256 (highest) against the plain step: metrics "
            "max rel {:.3e}; params and Adam moments max |d| / max |ref| "
            "{:.3e}; bitwise equal: {}", loss, d_metrics, d_state, equal)
        if d_state > DP_PARITY or d_metrics > DP_PARITY:
            raise AssertionError("the DP {} step left another state".format(
                loss))


def _dp_padded(C, mesh, say):
    """255 real rows padded to 256 through the DP padded step under
    `default` with the K1/K2 hook, against the plain step on the 255."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.parallel.mesh import pad_to_multiple
    from disvae_tpu_torch.train.steps import (make_padded_train_step,
                                              make_train_step)
    cases = _dp_cases()
    dev = torch.device("cuda")
    batch = cases.celeba_batch(255, dev)
    cfg, plain = cases.celeba_state("btcvae", dev)
    _, dp = cases.celeba_state("btcvae", dev)
    padded, n_valid = pad_to_multiple(batch.cpu().numpy(), 256)
    padded = torch.from_numpy(padded).to(dev)
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        want = make_train_step(cfg)(plain, batch)
        C.convt3_dw.launches = C.convt3_dx.launches = 0
        got = make_padded_train_step(cfg, mesh)(dp, padded, n_valid)
        launches = (C.convt3_dw.launches, C.convt3_dx.launches)
        torch.cuda.synchronize()
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    bad = [k for k in want if abs(float(got[k]) - float(want[k]))
           > 1e-4 + 1e-4 * abs(float(want[k]))]
    d_metrics = max(abs(float(got[k]) - float(want[k]))
                    / max(abs(float(want[k])), 1e-30) for k in want)
    d_params = cases.settled_param_diff(plain, dp)
    say("DP padded btcvae step, 255 real rows of 256 (default, K1/K2 hook) "
        "against the plain step on the 255: metrics max rel {:.3e}; params "
        "max |d| {:.3e} where |grad| >= 1% of its tensor's max; K1 "
        "launches {}, K2 launches {}", d_metrics, d_params, *launches)
    if bad or d_params > 2e-4 or launches != (1, 1):
        raise AssertionError("the padded DP step: metrics {} off, params "
                             "{}, launches {}".format(bad, d_params,
                                                      launches))


def _dp_step_times(C, mesh, say, datasets):
    """Host-clock ms per b256 btcvae step over 40 steps, the DP step
    against the plain one, in turns, on the resident celeba subset under
    `default` with the K1/K2 hook."""
    from disvae_tpu_torch.data.resident import ResidentData
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.steps import make_train_step
    cases = _dp_cases()
    dev = torch.device("cuda")
    ds = datasets.get_dataset("celeba")()
    wire = ResidentData(ds, dev).wire
    idx = torch.from_numpy(np.random.default_rng(SEED).permutation(
        len(ds))[:100 * 256].reshape(100, 256)).to(dev)
    runs, cursor = {}, {}
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        for name, m in (("plain", None), ("DP", mesh)):
            cfg, state = cases.celeba_state("btcvae", dev, n_data=len(ds))
            runs[name] = (make_train_step(cfg, m), state)
            cursor[name] = 0

        def run(name, n):
            step, state = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, wire.index_select(0, idx[cursor[name] % 100]))
                cursor[name] += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        for name in runs:
            run(name, 10)  # warm-up
        times = {k: [] for k in runs}
        for name in ("plain", "DP", "DP", "plain"):
            times[name].append(run(name, 40))
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    say("b256 btcvae train step, host clock, 40 steps (default, K1/K2 hook, "
        "resident): plain {} ms, DP at world size 1 {} ms (in turns: plain, "
        "DP, DP, plain)", " / ".join("{:.3f}".format(t)
                                     for t in times["plain"]),
        " / ".join("{:.3f}".format(t) for t in times["DP"]))
    # the DP step's collectives alone, at the step's sizes: the latent
    # gather (256 x 30 float32), the reconstruction sum, the flat gradient
    # all-reduce of the VAE's parameters
    from disvae_tpu_torch.parallel.mesh import (all_reduce_sum, gather_rows,
                                                reduce_gradients)
    model = runs["DP"][1].model
    stats, scalar = torch.randn(256, 30, device=dev), torch.ones((), device=dev)

    def host_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    say("the DP step's collectives alone, host clock per call (200 calls): "
        "latent gather {:.3f} ms, reconstruction all-reduce {:.3f} ms, flat "
        "gradient all-reduce ({:,} floats) {:.3f} ms",
        host_ms(lambda: gather_rows(stats, mesh)),
        host_ms(lambda: all_reduce_sum(scalar, mesh)),
        sum(p.numel() for p in model.parameters()),
        host_ms(lambda: reduce_gradients(model.parameters(), mesh)))


def _count_model_calls(mesh, fn):
    """Run `fn` counting the collectives of parallel/mesh.py by group:
    {"model": calls over the model group, "data": calls over the data
    group}."""
    import disvae_tpu_torch.parallel.mesh as M
    counts = {"model": 0, "data": 0}
    gather, reduce = M._all_gather, M.dist.all_reduce

    def counted(f):
        def call(*args, group=None, **kwargs):
            counts["model" if group is mesh.model_group else "data"] += 1
            return f(*args, group=group, **kwargs)
        return call
    M._all_gather, M.dist.all_reduce = counted(gather), counted(reduce)
    try:
        out = fn()
    finally:
        M._all_gather, M.dist.all_reduce = gather, reduce
    return out, counts


def _tp_step(cfg, mesh, state):
    """The FactorVAE step with the discriminator column-parallel over the
    model group, at any model size (parallel/mesh.py make_tp_train_step)."""
    from disvae_tpu_torch.parallel.mesh import make_tp_train_step
    from disvae_tpu_torch.train.steps import _factor_train_step
    return make_tp_train_step(functools.partial(_factor_train_step, cfg),
                              mesh, state)


def _tp_parity(C, mesh, say):
    """One TP FactorVAE step at b256 celeba shapes against the plain step
    from the same state and pinned noise under `highest`; then the same
    step under `default` with the K1/K2 hook (one K1 and one K2 launch),
    its model-axis collectives counted."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.steps import make_train_step
    cases = _dp_cases()
    dev = torch.device("cuda")
    batch = cases.celeba_batch(256, dev)
    cfg, plain = cases.celeba_state("factor", dev)
    _, tp = cases.celeba_state("factor", dev)
    noise = cases.pinned_noise(cfg, 256, dev)
    want = make_train_step(cfg)(plain, batch, noise)
    got = _tp_step(cfg, mesh, tp)(tp, batch, noise)
    torch.cuda.synchronize()
    d_metrics = max(abs(float(got[k]) - float(want[k]))
                    / max(abs(float(want[k])), 1e-30) for k in want)
    d_state, equal = cases.state_diff(plain, tp)
    split = sum(isinstance(m, type(tp.disc.lin1)) for m in tp.disc.children())
    say("TP FactorVAE step at b256, model size 1 ({} of 6 discriminator "
        "layers column-parallel; highest) against the plain step: metrics "
        "max rel {:.3e}; params and Adam moments max |d| / max |ref| {:.3e};"
        " bitwise equal: {}", split, d_metrics, d_state, equal)
    if split != 6 or d_state > DP_PARITY or d_metrics > DP_PARITY:
        raise AssertionError("the TP step left another state")

    _, tp = cases.celeba_state("factor", dev)
    step = _tp_step(cfg, mesh, tp)
    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        C.convt3_dw.launches = C.convt3_dx.launches = 0
        got, calls = _count_model_calls(mesh, lambda: step(tp, batch, noise))
        launches = (C.convt3_dw.launches, C.convt3_dx.launches)
        torch.cuda.synchronize()
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    say("TP FactorVAE step at b256 (default, K1/K2 hook): K1 launches {}, "
        "K2 launches {}; collectives per step: {} over the model group, {} "
        "over the data group; loss {:.4f}, discrim_loss {:.4f}", *launches,
        calls["model"], calls["data"], float(got["loss"]),
        float(got["discrim_loss"]))
    if launches != (1, 1) or not all(math.isfinite(float(v))
                                     for v in got.values()):
        raise AssertionError("the hooked TP step: launches {}".format(
            launches))
    return calls


def _tp_step_times(C, mesh, say, datasets):
    """Host-clock ms per b256 FactorVAE step over 40 steps, the TP step
    against the DP step (both over the one-rank group), in turns, on the
    resident celeba subset under `default` with the K1/K2 hook."""
    from disvae_tpu_torch.data.resident import ResidentData
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.steps import make_train_step
    cases = _dp_cases()
    dev = torch.device("cuda")
    ds = datasets.get_dataset("celeba")()
    wire = ResidentData(ds, dev).wire
    idx = torch.from_numpy(np.random.default_rng(SEED).permutation(
        len(ds))[:100 * 256].reshape(100, 256)).to(dev)
    runs, cursor = {}, {}
    for name in ("DP", "TP"):
        cfg, state = cases.celeba_state("factor", dev, n_data=len(ds))
        step = (make_train_step(cfg, mesh) if name == "DP"
                else _tp_step(cfg, mesh, state))
        runs[name], cursor[name] = (step, state), 0

    def run(name, n):
        step, state = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, wire.index_select(0, idx[cursor[name] % 100]))
            cursor[name] += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    configure("default")
    burgess.set_final_convt_impl(C.conv_transpose2d_pl)
    try:
        for name in runs:
            run(name, 10)  # warm-up
        times = {k: [] for k in runs}
        for name in ("DP", "TP", "TP", "DP"):
            times[name].append(run(name, 40))
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
        configure("highest")
    say("b256 FactorVAE train step, host clock, 40 steps (default, K1/K2 "
        "hook, resident, world size 1): DP {} ms, TP at model size 1 {} ms "
        "(in turns: DP, TP, TP, DP)", " / ".join(
            "{:.3f}".format(t) for t in times["DP"]),
        " / ".join("{:.3f}".format(t) for t in times["TP"]))


def _tp_resume(mesh, scratch, say, datasets):
    """The Trainer with the discriminator column-parallel at model size 1
    (`make_tp_train_step` on its state), FactorVAE b256 on 5,120 celeba
    images under `highest`: 2 epochs straight against 1 epoch, then a new
    Trainer resumed from its train_state.pt for the 2nd; the checkpoint
    holds the whole discriminator."""
    from disvae_tpu_torch.models.discriminator import Discriminator
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.train.trainer import CKPT_FILE, Trainer
    ds = datasets.get_dataset("celeba")()
    sub = datasets.ArrayDataset(np.asarray(ds.imgs[:5120]))
    cfg = PL.get_loss_f("factor", rec_dist="bernoulli", reg_anneal=0,
                        factor_G=6.4, latent_dim=10, lr_disc=1e-5,
                        n_data=len(sub))

    def trainer(save_dir, resume=False):
        model = init_specific_model(
            "Burgess", (3, 64, 64), 10,
            generator=torch.Generator().manual_seed(SEED), device="cuda")
        tr = Trainer(model, cfg, lr=1e-4, seed=SEED, save_dir=save_dir,
                     is_progress_bar=False, resume=resume, mesh=mesh)
        _tp_step(cfg, mesh, tr.state)
        return tr

    def loader():
        return datasets.DataLoader(sub, batch_size=256, shuffle=True,
                                   seed=SEED)

    dirs = [os.path.join(scratch, "tp_resume", k) for k in ("straight",
                                                            "resumed")]
    straight = trainer(dirs[0])
    straight(loader(), epochs=2, checkpoint_every=1)
    trainer(dirs[1])(loader(), epochs=1, checkpoint_every=1)
    payload = torch.load(os.path.join(dirs[1], CKPT_FILE),
                         map_location="cpu", weights_only=True)["state"]
    whole = {k: tuple(v.shape) for k, v in Discriminator().state_dict()
             .items()}
    saved = {k: tuple(v.shape) for k, v in payload["disc"].items()}
    moments = [tuple(s["exp_avg"].shape) for s in
               payload["disc_optimizer"]["state"].values()]
    resumed = trainer(dirs[1], resume=True)
    resumed(loader(), epochs=2, checkpoint_every=1)
    torch.cuda.synchronize()
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    equal = all(torch.equal(x, b[part][k]) for part in ("model", "disc")
                for k, x in a[part].items())
    say("TP Trainer at model size 1 (FactorVAE b256, 5,120 celeba images, "
        "highest): train_state.pt holds the whole discriminator: {}; 1 "
        "epoch + resume + 1 equals 2 straight, bit for bit: {} ({} steps)",
        saved == whole and moments == list(whole.values()), equal,
        resumed.state.step)
    if saved != whole or moments != list(whole.values()) or not equal \
            or resumed.state.step != straight.state.step:
        raise AssertionError("TP resume: checkpoint {} , equal {}".format(
            saved, equal))



def phase_data_parallel(C, K, scratch, smi, datasets, plain_train,
                        eval_run):
    """The data-parallel path at world size 1 over NCCL: the group formed
    from a launcher's environment, step parity, the padded step with the
    hook, the training CLI and the split MIG/AAM eval through the CLI
    under the group, each beside its plain counterpart from this call.
    Every line carries the card's name and power limit."""
    from datetime import timedelta

    import torch.distributed as dist

    from disvae_tpu_torch import cli
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.parallel import distributed
    from disvae_tpu_torch.parallel.mesh import create_mesh
    from disvae_tpu_torch.utils.modelIO import load_metadata

    def say(fmt, *args):
        log("[{}] {}".format(smi, fmt.format(*args)))

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        distributed.initialize(cuda=True, timeout=timedelta(seconds=300))
        backend = dist.get_backend()
        nccl = torch.cuda.nccl.version()
        say("process group: backend {}, NCCL {}, world size {}, formed in "
            "{:.2f} s", backend, ".".join(map(str, nccl))
            if isinstance(nccl, tuple) else nccl, dist.get_world_size(),
            time.perf_counter() - t0)
        if backend != "nccl":
            raise AssertionError("the group's backend is " + backend)
        mesh = create_mesh()
        _dp_parity(mesh, say)
        _dp_padded(C, mesh, say)

        # the training CLI under the group: btcvae_celeba's settings
        name = "chip_smoke_dp_btcvae_celeba"
        burgess.set_final_convt_impl(C.conv_transpose2d_pl)
        try:
            C.convt3_dw.launches = C.convt3_dx.launches = 0
            trainer, _, seconds = _cli_run(cli, scratch, [
                name, "-d", "celeba", "-l", "btcvae", "--btcvae-B", "6.4",
                "--lr", "5e-4", "-b", "256", "-e", "1", "--checkpoint-every",
                "1", "--precision", "default", "--no-viz-gif",
                "--no-progress-bar", "-s", str(SEED)])
            launches = (C.convt3_dw.launches, C.convt3_dx.launches)
        finally:
            burgess.set_final_convt_impl(burgess.conv_transpose2d)
            configure("highest")
        exp_dir = os.path.join(scratch, cli.RES_DIR, name)
        steps = trainer.state.step
        rate = trainer.epoch_stats[0]["images_per_sec"]
        say("DP train CLI (btcvae, celeba {:,} images, b256, default, K1/K2 "
            "hook, world size 1): {:.1f} s, {} steps, K1 launches {}, K2 "
            "launches {}; {:.0f} images/sec, against the plain CLI's epochs "
            "{} images/sec", N_CELEBA, seconds, steps, *launches, rate,
            " / ".join("{:.0f}".format(e["images_per_sec"])
                       for e in plain_train))
        if trainer.mesh is None or steps != -(-N_CELEBA // 256) \
                or launches != (steps, steps):
            raise AssertionError("DP training: mesh {}, {} steps, launches "
                                 "{}".format(trainer.mesh, steps, launches))
        rows = _read_log(exp_dir)
        losses = load_metadata(exp_dir, filename="test_losses.log")
        if not all(math.isfinite(float(r[2])) for r in rows) \
                or not all(math.isfinite(v) for v in losses.values()) \
                or not math.isfinite(trainer.epoch_stats[0]["loss"]):
            raise AssertionError("DP training: non-finite losses")
        made = sorted(os.listdir(exp_dir))
        if made != ["model-0.pt", "model.pt", "specs.json",
                    "test_losses.log", "train_losses.log", "train_state.pt"]:
            raise AssertionError("DP training wrote {}".format(made))
        say("DP train CLI: epoch loss {:.4f}, test loss {}; wrote {}",
            trainer.epoch_stats[0]["loss"], losses["loss"], ", ".join(made))
        _dp_step_times(C, mesh, say, datasets)

        # the MIG/AAM eval through the CLI under the group
        eval_dir, metrics, timings = eval_run
        K.log_qz.launches = 0
        _, ev, seconds = _cli_run(cli, scratch, [
            os.path.basename(eval_dir), "--is-eval-only", "--is-metrics",
            "-l", "btcvae", "--no-progress-bar", "-s", str(SEED)])
        launches = K.log_qz.launches
        got = load_metadata(eval_dir, filename="metrics.log")
        d_mig = abs(got["MIG"] - metrics["MIG"])
        d_aam = abs(got["AAM"] - metrics["AAM"])
        t = ev.last_metrics_timings
        say("DP eval CLI (dsprites 737,280 images, world size 1): {:.1f} s; "
            "log_qz launches {}; MIG {} AAM {}, |dMIG| {:.3e} |dAAM| {:.3e} "
            "against the plain eval; encode {:.3f} s (plain {:.3f} s), "
            "entropies {:.3f} s (plain {:.3f} s)", seconds, launches,
            got["MIG"], got["AAM"], d_mig, d_aam, t["encode_seconds"],
            timings["encode_seconds"], t["entropy_seconds"],
            timings["entropy_seconds"])
        if ev.mesh is None or launches != 30 or d_mig > DP_METRICS \
                or d_aam > DP_METRICS:
            raise AssertionError("DP eval: mesh {}, {} launches, |dMIG| {}, "
                                 "|dAAM| {}".format(ev.mesh, launches, d_mig,
                                                    d_aam))

        # tensor parallelism of the FactorVAE discriminator at model size 1
        calls = _tp_parity(C, mesh, say)
        _tp_step_times(C, mesh, say, datasets)
        _tp_resume(mesh, scratch, say, datasets)
        return calls
    finally:
        distributed.shutdown()
        for k in env:
            os.environ.pop(k, None)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--convt-only", action="store_true",
                        help="build, check and time K1/K2 only (phases 1, "
                        "2 and 4), then stop")
    parser.add_argument("--logqz-only", action="store_true",
                        help="build, check and time K3 only (phases 1-3 and "
                        "the SASS of its inner loop), then stop")
    parser.add_argument("--graph-only", action="store_true",
                        help="build K1/K2 and run the CUDA-graph phase on "
                        "seeded random images only, then stop")
    parser.add_argument("--zoo-only", action="store_true",
                        help="build every kernel and run phase 17 (VAE, "
                        "betaH, betaB on mnist, fashion, chairs through the "
                        "CLIs) only, then stop")
    parser.add_argument("--package-root", default=REPO,
                        help="import disvae_tpu_torch from this directory "
                        "(another checkout, to time its kernels in the same "
                        "call); default: this script's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    from disvae_tpu_torch.ops import convt_bwd as C
    from disvae_tpu_torch.ops import log_qz as K
    log("disvae_tpu_torch from {}".format(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(C.__file__))))))
    strict = root == REPO

    smi = phase_device()
    probe = _probe()
    floor = types.SimpleNamespace(build=probe.build_flat)
    if args.convt_only:
        paths = phase_build({"convt3_bwd": C, "flat_floor": floor})
        phase_convt_kernels(C, probe, paths["flat_floor"])
        return 0
    if args.logqz_only:
        paths = phase_build({"log_qz": K})
        phase_sass(paths["log_qz"], getattr(K, "SAMPLES_PER_THREAD", None))
        log(json.dumps(phase_kernels(K, strict, clock=True)))
        return 0
    if args.graph_only:
        from disvae_tpu_torch.data.datasets import ArrayDataset
        phase_build({"convt3_bwd": C})
        rng = np.random.default_rng(SEED)
        bits = ArrayDataset((rng.random((4096, 64, 64, 1)) < 0.1).astype(
            np.uint8))
        bits.is_binary, bits._scale = True, 1.0
        rgb = ArrayDataset(rng.integers(0, 256, (4096, 64, 64, 3),
                                        dtype=np.uint8))
        build_dir = os.path.join(REPO, "build")
        os.makedirs(build_dir, exist_ok=True)
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
        try:
            log(json.dumps({"graph_times": phase_graph(C, smi, scratch, bits,
                                                       rgb)}))
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        return 0
    builds = {"log_qz": K, "convt3_bwd": C, "flat_floor": floor}
    native_build = {}
    if _native_gathers():
        from disvae_tpu_torch import native

        def build_native():
            t0 = time.perf_counter()
            path = native.build()
            native_build["seconds"] = time.perf_counter() - t0
            return path, ""
        builds["native_gather"] = types.SimpleNamespace(build=build_native)
    paths = phase_build(builds)
    phase_sass(paths["log_qz"], getattr(K, "SAMPLES_PER_THREAD", None))
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    if args.zoo_only:
        scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
        try:
            log(json.dumps({"zoo": phase_zoo(C, scratch, smi)}))
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        return 0
    record = phase_kernels(K, strict)
    convt = phase_convt_kernels(C, probe, paths["flat_floor"])
    scratch = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    try:
        exp_dir, datasets, launches, metrics, timings = phase_main_path(
            K, scratch, smi)
        log("entropy phase {:.3f} s against K3's 30 launches timed alone: "
            "{:.3f} s L2-cold, {:.3f} s warm".format(
                timings["entropy_seconds"], record["eval_sum_ms"] / 1e3,
                record["eval_sum_warm_ms"] / 1e3))
        phase_eval_variants(K, scratch, exp_dir, datasets, metrics, timings)
        phase_serving(exp_dir, datasets)
        (dw_launches, dx_launches), replays, device, train_stats = \
            phase_train(C, scratch)
        phase_ab(C, datasets)
        if strict:
            log(json.dumps({"graph_times": phase_graph(
                C, smi, scratch, datasets.get_dataset("dsprites")(),
                datasets.get_dataset("celeba")())}))
        phase_factor(C, scratch)
        phase_viz(scratch, [("chip_smoke_btcvae_celeba", "celeba"),
                            (os.path.basename(exp_dir), "dsprites")],
                  datasets)
        zoo = phase_zoo(C, scratch, smi)
        evidence = factor = None
        if strict:
            evidence, factor = phase_evidence(scratch, smi, root)
            phase_data_parallel(C, K, scratch, smi, datasets, train_stats,
                                (exp_dir, metrics, timings))
            phase_native(scratch, smi, datasets, (exp_dir, metrics, timings),
                         native_build["seconds"])
        else:
            log("graph, evidence, data-parallel, tensor-parallel and "
                "native-gather phases skipped: they run this checkout's "
                "package only")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    convt_src = "disvae_tpu_torch/csrc/convt3_bwd.cu"

    def _evidence_counts(leg, name):
        """Phase 18's counts of one kernel in a kernels run."""
        if leg is None:
            return None
        return dict(leg[name], steps=leg["steps"],
                    device_launches=leg["profiled_epoch"][name],
                    profiled_steps=leg["profiled_epoch"]["steps"])

    cudnn = {k: convt[k] for k in ("cudnn_dw_ms", "cudnn_dx_ms")}
    log(json.dumps({"kernels": [
        dict(name="log_qz", route="cuda",
             source="disvae_tpu_torch/csrc/log_qz.cu",
             replaces="disvae_tpu/ops/pallas_kernels.py:44",
             launches=launches, library_ms=None,
             bound_us=record["bound_ms"] * 1e3,
             entropy_seconds=timings["entropy_seconds"], **record),
        dict(name="convt3_dw", route="cuda", source=convt_src,
             replaces="disvae_tpu/ops/pallas_convt_bwd.py:71",
             launches=dw_launches, graph_replays=replays,
             device_launches=device[0],
             evidence=_evidence_counts(evidence, "convt3_dw"),
             evidence_factor=_evidence_counts(factor, "convt3_dw"), zoo={
                 name: dict(launches=r["launches"][0],
                            device_launches=r["device_launches"][0],
                            graph_replays=r["graph_replays"],
                            steps=r["steps"]) for name, r in zoo.items()},
             **convt["convt3_dw"], **cudnn),
        dict(name="convt3_dx", route="cuda", source=convt_src,
             replaces="disvae_tpu/ops/pallas_convt_bwd.py:108",
             launches=dx_launches, graph_replays=replays,
             device_launches=device[1],
             evidence=_evidence_counts(evidence, "convt3_dx"),
             evidence_factor=_evidence_counts(factor, "convt3_dx"), zoo={
                 name: dict(launches=r["launches"][1],
                            device_launches=r["device_launches"][1],
                            graph_replays=r["graph_replays"],
                            steps=r["steps"]) for name, r in zoo.items()},
             **convt["convt3_dx"], **cudnn)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
