"""Where the bf16 K1 (csrc/convt3_bwd.cu, the band kernel) spends its time
on the card: the kernel against variants of itself with parts of its work
taken out, and against a flat read of the same bytes.

    python -m disvae_tpu_torch.probe_convt_dw

At the training path's shape (x (256, 32, 32, 32), dy (256, 3, 64, 64),
bf16) it prints, for each variant, its L2-cold time (CUDA events; 256 MB
written and read between runs, outside the events, as chip_smoke.py does)
and the warm device time of each of its kernels (torch.profiler):

* as built (its dW checked against the plain version);
* no Q rebuild: Q is left as it was (the sums are garbage, the time is
  not);
* loads only: no Q rebuild and no product, the band pipeline's copies,
  waits and barriers alone;
* a 3-stage cp.async ring instead of 2;
* a flat read: a grid-stride kernel that reads x and dy once in 16-byte
  loads and nothing else, the floor for the bytes K1 must move.

The variants are the source with exact text edits; an edit that no longer
applies raises. Sources and libraries go to build/disvae_tpu_torch/probe/.
Needs a CUDA device and nvcc.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import threading

import numpy as np
import torch

from disvae_tpu_torch.ops import convt_bwd, cuda_build

PROBE_DIR = os.path.join(cuda_build.BUILD_DIR, "probe")
N, H, CIN, COUT = 256, 32, 32, 3
_NO_REBUILD = ("e < n_rows * ((W + kRun) / kRun);", "e < 0;")
_NO_PRODUCT = ("for (int s = grp; s < steps; s += Split::kGroups)",
               "for (int s = grp; s < 0; s += Split::kGroups)")
VARIANTS = {
    "as built": [],
    "no Q rebuild": [_NO_REBUILD],
    "loads only": [_NO_REBUILD, _NO_PRODUCT],
    "3-stage ring": [("constexpr int kBandStages = 2;",
                      "constexpr int kBandStages = 3;")],
}
FLAT_READ_CU = r"""
#include <cuda_runtime.h>
__global__ void flat_read(const uint4* a, long long na, const uint4* b,
                          long long nb, unsigned* out) {
  unsigned acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll 4
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < na + nb; i += stride) {
    const uint4 v = i < na ? a[i] : b[i - na];
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads
}
extern "C" int probe_flat_read(const void* a, long long na, const void* b,
                               long long nb, void* out, int blocks,
                               void* stream) {
  flat_read<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, na, (const uint4*)b, nb, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def _compile(name, text):
    """nvcc (ops/cuda_build.py's flags) of `text` into PROBE_DIR."""
    source = os.path.join(PROBE_DIR, name + ".cu")
    with open(source, "w") as f:
        f.write(text)
    path = os.path.join(PROBE_DIR, "lib{}.so".format(name))
    proc = subprocess.run([cuda_build._nvcc()] + cuda_build.NVCC_FLAGS
                          + ["-o", path, source], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}{}".format(
            source, proc.stdout, proc.stderr))
    return path


def _sources():
    with open(os.path.join(cuda_build.CSRC, "convt3_bwd.cu")) as f:
        base = f.read()
    out = {"flat read": FLAT_READ_CU}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant {!r}: {!r} is not in "
                                   "convt3_bwd.cu".format(name, old))
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all():
    """One nvcc per source, all started together: {name: ctypes lib}."""
    os.makedirs(PROBE_DIR, exist_ok=True)
    paths = {}

    def run(i, name, text):
        try:
            paths[name] = _compile("v{}".format(i), text)
        except RuntimeError as e:  # re-raised below, in the main thread
            paths[name] = e

    threads = [threading.Thread(target=run, args=(i, name, text))
               for i, (name, text) in enumerate(_sources().items())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name, path in paths.items():
        if isinstance(path, Exception):
            raise path
        libs[name] = ctypes.CDLL(path)
    return libs


def _cold_ms(fn, flush, reps=20):
    """Median of `reps` CUDA-event times of one call, the flush buffer
    written and read before each, outside the events."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _warm_kernels(fn, calls=10):
    """[(kernel, device us per call)] over `calls` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    return [(k, v / calls) for k, v in sorted(us.items(),
                                              key=lambda kv: -kv[1])]


def main():
    if not torch.cuda.is_available():
        print("probe_convt_dw: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    libs = _build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (N, CIN, H, H), np.float32), 0)).to(dev).bfloat16()
    dy = torch.from_numpy(1e-2 * rng.standard_normal(
        (N, COUT, 2 * H, 2 * H), np.float32)).to(dev).bfloat16()
    ref = convt_bwd.convt3_dw_plain(x, dy, torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    stream = torch.cuda.current_stream().cuda_stream
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    p, i = ctypes.c_void_p, ctypes.c_int

    flat = libs.pop("flat read").probe_flat_read
    flat.argtypes = [p, ctypes.c_longlong, p, ctypes.c_longlong, p, i, p]
    sink = torch.zeros(4, dtype=torch.int32, device=dev)

    def read():
        flat(x.data_ptr(), x.numel() // 8, dy.data_ptr(), dy.numel() // 8,
             sink.data_ptr(), 8 * sm_count, stream)

    print("flat read of x and dy ({:.2f} MB): L2-cold {:.4f} ms; warm "
          "{:.2f} us".format(2 * (x.numel() + dy.numel()) / 1e6,
                             _cold_ms(read, flush),
                             sum(us for _, us in _warm_kernels(read))),
          flush=True)
    for name in VARIANTS:
        lib = libs[name]
        convt_bwd._declare(lib)
        n_blocks = lib.disvae_convt3_dw_n_blocks(1, N, CIN, H, H, COUT,
                                                 sm_count)
        part = torch.empty((n_blocks, CIN * 16 * COUT), device=dev)
        dw = torch.empty((CIN, COUT, 4, 4), device=dev)

        def call():
            err = lib.disvae_convt3_dw(1, x.data_ptr(), dy.data_ptr(),
                                       part.data_ptr(), dw.data_ptr(), N, CIN,
                                       H, H, COUT, n_blocks, stream)
            if err != 0:
                raise RuntimeError("{}: launch failed ({})".format(name, err))

        call()
        torch.cuda.synchronize()
        err = ((dw - ref).abs().max() / ref.abs().max()).item()
        if name == "as built" and not err <= 1e-3:
            raise AssertionError("as built: max |d| / max |ref| {}".format(
                err))
        print("{}: {} blocks, L2-cold {:.4f} ms; warm {}{}".format(
            name, n_blocks, _cold_ms(call, flush), "; ".join(
                "{:.2f} us {}".format(us, k[:48])
                for k, us in _warm_kernels(call)),
            "; max |d| / max |ref| {:.2e}".format(err)
            if name == "as built" else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
