"""Build and load the port's hand-written CUDA sources.

Each `disvae_tpu_torch/csrc/<name>.cu` has a plain C interface. At first
use it is compiled with nvcc (sm_90a) into a shared library under
`build/disvae_tpu_torch/` (listed in .gitignore), named by a hash of the
source and the flags, and loaded with ctypes. Nothing is built when a
module is imported: the CPU tests import every module on machines
without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
# build/ at the repository root (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build",
                         "disvae_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's CUDA "
                           "kernels cannot be built.")
    return path


def build(name):
    """Compile csrc/<name>.cu into BUILD_DIR unless a library built from the
    same source and flags is there already. Returns (path, compiler
    output); the output is empty when nothing was compiled. Safe to call
    for several sources from several threads at once."""
    source = os.path.join(CSRC, name + ".cu")
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, "lib{}-{}.so".format(
        name, digest.hexdigest()[:12]))
    if os.path.exists(path):
        return path, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.{}.tmp".format(path, os.getpid(), threading.get_ident())
    proc = subprocess.run([nvcc] + NVCC_FLAGS + ["-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {} ({}):\n{}{}".format(
            source, proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def library(name, declare):
    """The loaded library of csrc/<name>.cu, built at first use.
    `declare(lib)` sets argtypes/restype of its functions once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            lib.disvae_cuda_error_string.argtypes = [ctypes.c_int]
            lib.disvae_cuda_error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[name] = lib
        return lib


def check(lib, err, what):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("{} kernel launch failed: {} ({})".format(
            what, lib.disvae_cuda_error_string(err).decode(), err))
