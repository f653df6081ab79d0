"""The native host gather of the input pipeline (`gather.cpp`).

Counterpart of disvae_tpu/native/__init__.py. The C++ source is compiled
with g++ at first use into a shared library under `build/disvae_tpu_torch/`
(listed in .gitignore), named by a hash of the source, the flags and the
compiler, as ops/cuda_build.py builds the CUDA kernels, and loaded with
ctypes. Nothing is built when the module is imported. Each build writes a
temporary file named for its process and thread and renames it into
place, so several processes may build at once and leave one valid
library.

There is no numpy fallback: a build that fails raises with the compiler's
output. ctypes releases the interpreter lock for the call, so the
prefetcher's thread (data/prefetch.py) gathers while the device works.
Each function counts its calls in `<function>.calls`.

Threads: at most N_THREADS = min(8, cpu count), as the JAX package uses,
and one per BYTES_PER_THREAD of output below that. The C++ starts its
threads anew on every call, and on the H100 machine's 8-core host the
starts cost more than a small copy: at 8 threads every b256 gather of
byte or bitpacked rows took longer than numpy's, and the streamed
metrics encode about twice its numpy time (PERF.md).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from disvae_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "gather.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
N_THREADS = min(8, os.cpu_count() or 1)
BYTES_PER_THREAD = 4 << 20

_lock = threading.Lock()
_lib = None


def build():
    """Compile gather.cpp into BUILD_DIR unless a library of the same
    source, flags and compiler is there. Returns its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join([CXX] + CXX_FLAGS)
                              .encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, "libgather-{}.so".format(digest))
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.{}.tmp".format(path, os.getpid(), threading.get_ident())
    try:
        proc = subprocess.run([CXX] + CXX_FLAGS + [SOURCE, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("the native gather cannot be built: {} ({})"
                           .format(CXX, e)) from e
    if proc.returncode != 0:
        raise RuntimeError("{} failed on {} ({}):\n{}{}".format(
            CXX, SOURCE, proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, path)
    return path


def library():
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u8, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.gather_u8_f32.argtypes = [u8, i64, u8, i64, ctypes.c_float,
                                          u8, ctypes.c_int]
            lib.gather_u8_mul.argtypes = [u8, i64, u8, i64, ctypes.c_int,
                                          u8, ctypes.c_int]
            lib.gather_u8.argtypes = [u8, i64, u8, i64, u8, ctypes.c_int]
            for fn in (lib.gather_u8_f32, lib.gather_u8_mul, lib.gather_u8):
                fn.restype = None
            _lib = lib
        return _lib


def _prepare(imgs, idcs, dtype):
    """Checked arguments of a gather: int64 indices (negative ones wrapped
    as numpy wraps them), the bytes per row, and the output array."""
    if not (isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8
            and imgs.flags["C_CONTIGUOUS"]):
        raise TypeError("the native gather reads a C-contiguous uint8 "
                        "array or memmap")
    n = imgs.shape[0]
    idcs = np.asarray(idcs, np.int64).reshape(-1)
    if idcs.size and (idcs.min() < -n or idcs.max() >= n):
        raise IndexError("gather index out of range for {} rows".format(n))
    idcs = np.ascontiguousarray(np.where(idcs < 0, idcs + n, idcs))
    out = np.empty((len(idcs),) + imgs.shape[1:], dtype)
    return idcs, int(np.prod(imgs.shape[1:])), out


def threads(nbytes):
    """Threads for a gather that writes `nbytes`: one per
    BYTES_PER_THREAD, at least 1 and at most N_THREADS."""
    return max(1, min(N_THREADS, -(-nbytes // BYTES_PER_THREAD)))


def gather_u8_f32(imgs, idcs, scale):
    """out[r] = imgs[idcs[r]] as float32 times `scale`, in one fused
    multithreaded pass (numpy's `np.asarray(imgs[idcs], np.float32) *
    scale`, bit for bit)."""
    idcs, row, out = _prepare(imgs, idcs, np.float32)
    if len(idcs):
        library().gather_u8_f32(imgs.ctypes.data, row, idcs.ctypes.data,
                                len(idcs), scale, out.ctypes.data,
                                threads(out.nbytes))
        gather_u8_f32.calls += 1
    return out


def gather_u8_mul(imgs, idcs, mul):
    """out[r] = imgs[idcs[r]] * mul as uint8; callers keep src * mul <=
    255 (the wire format, value / 255)."""
    idcs, row, out = _prepare(imgs, idcs, np.uint8)
    if len(idcs):
        library().gather_u8_mul(imgs.ctypes.data, row, idcs.ctypes.data,
                                len(idcs), int(mul), out.ctypes.data,
                                threads(out.nbytes))
        gather_u8_mul.calls += 1
    return out


def gather_u8(imgs, idcs):
    """out[r] = imgs[idcs[r]], the rows copied as they are."""
    idcs, row, out = _prepare(imgs, idcs, np.uint8)
    if len(idcs):
        library().gather_u8(imgs.ctypes.data, row, idcs.ctypes.data,
                            len(idcs), out.ctypes.data,
                            threads(out.nbytes))
        gather_u8.calls += 1
    return out


gather_u8_f32.calls = gather_u8_mul.calls = gather_u8.calls = 0
