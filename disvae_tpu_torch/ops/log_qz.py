"""Gaussian-mixture log density of the MIG/AAM entropy sweep.

    log_qz(values, mu, logvar)[l, d, s]
        = logsumexp_m log N(values[l, d, s]; mu[l, m, d], exp(logvar[l, m, d]))

values (L, D, S), mu/logvar (L, M, D), all float32; the -log M mixture
normalisation is the caller's. The marginal sweep is L = 1; the conditional
sweeps batch the L slices of one factor.

Counterpart of the Pallas kernel disvae_tpu/ops/pallas_kernels.py
(`_log_qz_kernel`, launched by `log_qz`) and of its XLA sibling
disvae_tpu/train/evaluate.py `_streaming_log_qz`. Three pieces live here:

* `log_qz_plain` — plain PyTorch: `_streaming_log_qz` with the L axis written
  out, an online logsumexp over component chunks as the JAX scan does;
* the hand-written CUDA kernel in `disvae_tpu_torch/csrc/log_qz.cu` (its
  header says what bounds it on Hopper and what the design does about it),
  built with nvcc into a plain-C shared library at first use and loaded with
  ctypes;
* `log_qz` — the wrapper. It takes the plain version only for CPU tensors.
  For CUDA tensors it launches the kernel or raises; nothing falls back.
  `log_qz.launches` counts its kernel launches.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

from disvae_tpu_torch.ops.math import log_density_gaussian

# Component chunk of the plain version's (L, chunk, D, S) density brick, as
# in the JAX evaluator (evaluate.py _COMP_CHUNK, scaled down with L).
_COMP_CHUNK = 2048

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "log_qz.cu")
# build/ at the repository root (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "disvae_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def log_qz_plain(values, mu, logvar, comp_chunk=None):
    """Plain PyTorch log_qz: online logsumexp over component chunks.
    Same contract as `log_qz`; ragged chunks need no padding here."""
    L, D, S = values.shape
    M = mu.shape[1]
    if comp_chunk is None:
        comp_chunk = max(256, _COMP_CHUNK // L)
    run_max = torch.full((L, D, S), -math.inf, dtype=values.dtype,
                         device=values.device)
    run_sum = torch.zeros_like(run_max)
    v = values[:, None, :, :]                          # (L, 1, D, S)
    for m0 in range(0, M, comp_chunk):
        cmu = mu[:, m0:m0 + comp_chunk, :, None]       # (L, C, D, 1)
        clv = logvar[:, m0:m0 + comp_chunk, :, None]
        ld = log_density_gaussian(v, cmu, clv)         # (L, C, D, S)
        new_max = torch.maximum(run_max, ld.amax(dim=1))
        run_sum = (run_sum * torch.exp(run_max - new_max)
                   + torch.exp(ld - new_max[:, None]).sum(dim=1))
        run_max = new_max
    return torch.log(run_sum) + run_max


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the log_qz CUDA "
                           "kernel cannot be built.")
    return path


def build():
    """Compile csrc/log_qz.cu into BUILD_DIR unless a library built from
    the same source and flags is there already. Returns (path, compiler
    output); the output is empty when nothing was compiled."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, "liblog_qz-{}.so".format(
        digest.hexdigest()[:12]))
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}{}".format(
            proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.disvae_log_qz_f32.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
            lib.disvae_log_qz_f32.restype = ctypes.c_int
            lib.disvae_log_qz_n_split.argtypes = [ctypes.c_int] * 5
            lib.disvae_log_qz_n_split.restype = ctypes.c_int
            lib.disvae_cuda_error_string.argtypes = [ctypes.c_int]
            lib.disvae_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(values, mu, logvar):
    for name, t in (("values", values), ("mu", mu), ("logvar", logvar)):
        if t.device != values.device:
            raise ValueError("log_qz: {} is on {}, values on {}".format(
                name, t.device, values.device))
        if t.dtype != torch.float32:
            raise TypeError("log_qz: {} must be float32, got {}".format(
                name, t.dtype))
        if t.dim() != 3:
            raise ValueError("log_qz: {} must be 3-d, got shape {}".format(
                name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("log_qz: {} must be contiguous".format(name))
    L, D, S = values.shape
    if mu.shape != logvar.shape or mu.shape[0] != L or mu.shape[2] != D:
        raise ValueError(
            "log_qz: shapes values {}, mu {}, logvar {} do not fit "
            "(L, D, S), (L, M, D), (L, M, D)".format(
                tuple(values.shape), tuple(mu.shape), tuple(logvar.shape)))
    M = mu.shape[1]
    if min(L, D, S, M) < 1:
        raise ValueError("log_qz: empty operand")
    return L, M, D, S


def log_qz(values, mu, logvar):
    """(L, D, S) logsumexp over the M components of mu/logvar (L, M, D).
    CPU tensors take `log_qz_plain`; CUDA tensors launch the kernel."""
    L, M, D, S = _check(values, mu, logvar)
    if values.device.type == "cpu":
        return log_qz_plain(values, mu, logvar)
    if values.device.type != "cuda":
        raise ValueError("log_qz: no kernel for device {}".format(
            values.device))
    if L * D > 65535 or L * D * S >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError("log_qz: (L, M, D, S) = {} exceeds the launch "
                         "geometry".format((L, M, D, S)))
    lib = _library()
    with torch.cuda.device(values.device):
        sm_count = torch.cuda.get_device_properties(
            values.device).multi_processor_count
        n_split = lib.disvae_log_qz_n_split(L, M, D, S, sm_count)
        out = torch.empty((L, D, S), dtype=torch.float32,
                          device=values.device)
        part = torch.empty((2, n_split, L, D, S), dtype=torch.float32,
                           device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.disvae_log_qz_f32(
            values.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            out.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            L, M, D, S, n_split, stream)
    if err != 0:
        raise RuntimeError("log_qz kernel launch failed: {} ({})".format(
            lib.disvae_cuda_error_string(err).decode(), err))
    log_qz.launches += 1
    return out


log_qz.launches = 0
