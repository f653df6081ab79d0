"""Where the bf16 K1 and K2 (csrc/convt3_bwd.cu) spend their time on the
card: each kernel against variants of itself with parts of its work taken
out, and against a flat pass over the same bytes.

    python -m disvae_tpu_torch.probe_convt [--package-root DIR]

At the training path's shape (x (256, 32, 32, 32), dy (256, 3, 64, 64),
bf16) it prints, for each variant, its L2-cold time (CUDA events; 256 MB
written and read between runs, outside the events, as chip_smoke.py does)
and the warm device time of each of its kernels (torch.profiler):

* K1 as built (its dW checked against the plain version); without the Q
  rebuild (the sums are garbage, the time is not); loads only (no Q
  rebuild and no product: the band pipeline's copies, waits and barriers
  alone); a 3-stage cp.async ring instead of 2;
* K2 as built (its dx checked against the plain version); no store (the
  sums are computed, dx is not written to device memory); no product
  (dy in, Q rebuilt, the tile stored as it stands); loads only (dy read
  as the kernel reads it: no Q rebuild, product or store); 2 and 4 blocks
  per SM instead of 3; a 3-stage cp.async ring instead of 2;
* the floors: a grid-stride kernel of 16-byte accesses that reads x and
  dy once (K1's bytes), and one that reads dy and writes dx (K2's).

The variants are the source with exact text edits. A K2 variant lists
its edits for the band kernel and for the design before it (one thread
per position), and takes the first set whose texts all occur, so
`--package-root` can probe an older checkout's K2 (its
csrc/convt3_bwd.cu; the wrappers are this package's).
A variant none of whose edit sets applies raises for this package's
source and is skipped for another checkout's. Sources and libraries go to
build/disvae_tpu_torch/probe/. Needs a CUDA device and nvcc.
"""

import argparse
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
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, CIN, COUT = 256, 32, 32, 3
_NO_REBUILD = ("e < n_rows * ((W + kRun) / kRun);", "e < 0;")
_THREE_STAGES = ("constexpr int kBandStages = 2;",
                 "constexpr int kBandStages = 3;")  # both band kernels' ring
_NO_PRODUCT = ("for (int s = grp; s < steps; s += Split::kGroups)",
               "for (int s = grp; s < 0; s += Split::kGroups)")
# the band K2: present (an edit that changes nothing), its 16-byte dx
# stores, its product
_BAND_K2 = ("convt3_dx_band_kernel(", "convt3_dx_band_kernel(")
_K2_NO_STORE = ("e < Cin * chunks;", "e < 0;")
_K2_NO_PRODUCT = ("for (int s = warp; s < steps; s += kBandThreads / 32)",
                  "for (int s = warp; s < 0; s += kBandThreads / 32)")
_K2_NO_REBUILD = ("rebuild_q(ds + buf * dbuf, qs, bd, Cout, H2, W, dr, dp, "
                  "tp);\n    __syncthreads();  // Q is built\n\n    // dx^T",
                  "__syncthreads();  // Q is built\n\n    // dx^T")
# the K2 before the band kernel: one thread per position, 48 taps on the
# FP32 pipe
_PR2_NO_STORE = ("if (ci < Cin) dx[(n * Cin + ci) * HW + r]",
                 "if (ci < Cin && acc[c] == 1.5e-38f) dx[(n * Cin + ci) * "
                 "HW + r]")
_PR2_NO_FFMA = [("const float v = to_f(plane[oy * W2 + ox]);",
                 "const float v = to_f(plane[oy * W2 + ox]); acc[0] += v;"),
                ("for (int q = 0; q < kDxC / 4; ++q) {",
                 "for (int q = 0; q < 0; ++q) {")]
# (kernel, [edit sets]): the first set whose old texts all occur applies
VARIANTS = {
    "K1 as built": ("K1", [[]]),
    "K1 no Q rebuild": ("K1", [[_NO_REBUILD]]),
    "K1 loads only": ("K1", [[_NO_REBUILD, _NO_PRODUCT]]),
    "K1 3-stage ring": ("K1", [[_THREE_STAGES]]),
    "K2 as built": ("K2", [[]]),
    "K2 no store": ("K2", [[_K2_NO_STORE], [_PR2_NO_STORE]]),
    "K2 no Q rebuild": ("K2", [[_K2_NO_REBUILD]]),
    "K2 no product": ("K2", [[_K2_NO_PRODUCT], _PR2_NO_FFMA]),
    "K2 2 blocks per SM": ("K2", [[("constexpr int kDxBlocksPerSm = 3;",
                                    "constexpr int kDxBlocksPerSm = 2;")]]),
    "K2 4 blocks per SM": ("K2", [[("constexpr int kDxBlocksPerSm = 3;",
                                    "constexpr int kDxBlocksPerSm = 4;")]]),
    "K2 3-stage ring": ("K2", [[_THREE_STAGES, _BAND_K2]]),
    "K2 loads only": ("K2", [[_NO_REBUILD, _K2_NO_PRODUCT, _K2_NO_STORE],
                             [_PR2_NO_STORE] + _PR2_NO_FFMA]),
}
FLAT_CU = r"""
#include <cuda_runtime.h>
// Reads a[0, na) and b[0, nb) and writes c[0, nc), 16 bytes a thread and
// access, the reads and writes of one index interleaved.
__global__ void flat(const uint4* a, long long na, const uint4* b,
                     long long nb, uint4* c, long long nc, unsigned* out) {
  unsigned acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n = na + nb > nc ? na + nb : nc;
#pragma unroll 4
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (i < na + nb) {
      const uint4 v = i < na ? a[i] : b[i - na];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    if (i < nc) c[i] = make_uint4((unsigned)i, 0u, 0u, 0u);
  }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads
}
extern "C" int probe_flat(const void* a, long long na, const void* b,
                          long long nb, void* c, long long nc, void* out,
                          int blocks, void* stream) {
  flat<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, na, (const uint4*)b, nb, (uint4*)c, nc,
      (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def _compile(name, text):
    """nvcc (ops/cuda_build.py's flags) of `text` into PROBE_DIR: (library
    path, compiler output)."""
    os.makedirs(PROBE_DIR, exist_ok=True)
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
    return path, proc.stdout + proc.stderr


def build_flat():
    """The floor kernel (FLAT_CU) built alone: (library path, compiler
    output). chip_smoke.py times K2's floor with it."""
    return _compile("flat_floor", FLAT_CU)


def flat_pass(lib, reads, write, sm_count, stream, sink):
    """One launch of the floor kernel of `lib`: read the tensors `reads`
    (one or two) and write `write` (or None), each whole, 16-byte aligned
    and a multiple of 16 bytes. `sink` is a small int32 device buffer."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_flat.argtypes = [p, ll, p, ll, p, ll, p, i, p]
    a, b = (list(reads) + [None])[:2]
    views = [(0, 0) if t is None else (t.data_ptr(),
                                       t.numel() * t.element_size() // 16)
             for t in (a, b, write)]
    err = lib.probe_flat(*views[0], *views[1], *views[2], sink.data_ptr(),
                         8 * sm_count, stream)
    if err != 0:
        raise RuntimeError("flat floor kernel: launch failed ({})".format(err))


def _sources(package_root):
    """{name: source} of the floor kernel and of each variant that applies
    to package_root's convt3_bwd.cu."""
    with open(os.path.join(package_root, "disvae_tpu_torch", "csrc",
                           "convt3_bwd.cu")) as f:
        base = f.read()
    out = {"flat": FLAT_CU}
    for name, (_, edit_sets) in VARIANTS.items():
        edits = next((s for s in edit_sets
                      if all(old in base for old, _ in s)), None)
        if edits is None:
            if os.path.samefile(package_root, _ROOT):
                raise RuntimeError("variant {!r}: no edit set applies to "
                                   "convt3_bwd.cu".format(name))
            print("{}: does not apply to this source, skipped".format(name))
            continue
        text = base
        for old, new in edits:
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all(package_root):
    """One nvcc per distinct source, all started together: {name: ctypes
    lib}."""
    sources = _sources(package_root)
    texts = list(dict.fromkeys(sources.values()))
    paths = {}

    def run(i, text):
        try:
            paths[text] = _compile("v{}".format(i), text)[0]
        except RuntimeError as e:  # re-raised below, in the main thread
            paths[text] = e

    threads = [threading.Thread(target=run, args=item)
               for item in enumerate(texts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for path in paths.values():
        if isinstance(path, Exception):
            raise path
    return {name: ctypes.CDLL(paths[text]) for name, text in sources.items()}


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


def _report(name, fn, flush, extra=""):
    print("{}: L2-cold {:.4f} ms; warm {}{}".format(
        name, _cold_ms(fn, flush), "; ".join(
            "{:.2f} us {}".format(us, k[:48])
            for k, us in _warm_kernels(fn)), extra), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", default=_ROOT,
        help="probe the convt3_bwd.cu of this checkout (default: this "
        "package's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_convt: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print("convt3_bwd.cu of {}".format(os.path.abspath(args.package_root)),
          flush=True)
    libs = _build_all(args.package_root)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (N, CIN, H, H), np.float32), 0)).to(dev).bfloat16()
    w = torch.from_numpy(0.1 * rng.standard_normal(
        (CIN, COUT, 4, 4), np.float32)).to(dev)
    dy = torch.from_numpy(1e-2 * rng.standard_normal(
        (N, COUT, 2 * H, 2 * H), np.float32)).to(dev).bfloat16()
    ref = {"K1": convt_bwd.convt3_dw_plain(x, dy, torch.bfloat16),
           "K2": convt_bwd.convt3_dx_plain(dy, w, torch.bfloat16)}
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    stream = torch.cuda.current_stream().cuda_stream
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    flat = libs.pop("flat")
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    dx = torch.empty((N, CIN, H, H), dtype=torch.bfloat16, device=dev)
    for name, reads, write in (("flat read of x and dy", (x, dy), None),
                               ("flat read of dy + write of dx", (dy,), dx)):
        nbytes = sum(2 * t.numel() for t in reads + (write,)
                     if t is not None)
        _report("{} ({:.2f} MB)".format(name, nbytes / 1e6),
                lambda r=reads, o=write: flat_pass(flat, r, o, sm_count,
                                                   stream, sink), flush)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (kernel, _) in VARIANTS.items():
        if name not in libs:  # does not apply to another checkout's source
            continue
        lib = libs[name]
        if kernel == "K1":
            lib.disvae_convt3_dw_n_blocks.argtypes = [i] * 7
            n_blocks = lib.disvae_convt3_dw_n_blocks(1, N, CIN, H, H, COUT,
                                                     sm_count)
            part = torch.empty((n_blocks, CIN * 16 * COUT), device=dev)
            out = torch.empty((CIN, COUT, 4, 4), device=dev)
            fn = lib.disvae_convt3_dw
            args = [1, x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                    out.data_ptr(), N, CIN, H, H, COUT, n_blocks]
            fn.argtypes = [i] + [p] * 4 + [i] * 6 + [p]
        else:
            out = torch.empty((N, CIN, H, H), dtype=torch.bfloat16,
                              device=dev)
            fn = lib.disvae_convt3_dx
            args = [1, 1, dy.data_ptr(), w.data_ptr(), out.data_ptr(), N,
                    CIN, H, H, COUT]
            # the band kernel's block count (the K2 before it has none)
            if hasattr(lib, "disvae_convt3_dx_n_blocks"):
                lib.disvae_convt3_dx_n_blocks.argtypes = [i] * 7
                args.append(lib.disvae_convt3_dx_n_blocks(
                    1, N, CIN, H, H, COUT, sm_count))
            fn.argtypes = [i] * 2 + [p] * 3 + [i] * (len(args) - 5) + [p]

        def checked(fn=fn, args=args, name=name):
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError("{}: launch failed ({})".format(name, err))

        checked()
        torch.cuda.synchronize()
        extra = ""
        if name.endswith("as built"):
            err = ((out.float() - ref[kernel]).abs().max()
                   / ref[kernel].abs().max()).item()
            bound = 1e-3 if kernel == "K1" else 2 ** -8
            if not err <= bound:
                raise AssertionError("{}: max |d| / max |ref| {}".format(
                    name, err))
            extra = "; max |d| / max |ref| {:.2e}".format(err)
        _report(name, checked, flush, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
