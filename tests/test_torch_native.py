"""The port's native host gather (`disvae_tpu_torch/native`) against the JAX
package's (`disvae_tpu/native`) and numpy, and the datasets that use it.

Every comparison is bitwise: the gathers copy bytes, and the float32 one
multiplies each byte by the scale once, as numpy does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from disvae_tpu import native as jax_native
from disvae_tpu.data import datasets as JD

from disvae_tpu_torch import native
from disvae_tpu_torch.data import datasets as PD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dsprites stores {0, 1} in (N, 64, 64, 1); celeba bytes in (N, 64, 64, 3)
LAYOUTS = {"dsprites": ((300, 64, 64, 1), 2, 255),
           "celeba": ((120, 64, 64, 3), 256, 1)}


def _store(kind, tmp_path, memmap):
    shape, high, _ = LAYOUTS[kind]
    imgs = np.random.RandomState(0).randint(0, high, shape).astype(np.uint8)
    if memmap:
        np.save(tmp_path / "imgs.npy", imgs)
        imgs = np.load(tmp_path / "imgs.npy", mmap_mode="r")
        assert isinstance(imgs, np.memmap)
    return imgs


@pytest.mark.parametrize("memmap", [False, True], ids=["array", "memmap"])
@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_gathers_match_jax_native_and_numpy(tmp_path, kind, memmap):
    imgs = _store(kind, tmp_path, memmap)
    mul = LAYOUTS[kind][2]
    # repeats, the first and the last row, and a ragged count
    idcs = np.random.RandomState(1).randint(0, len(imgs), 77)
    idcs[:2] = [0, len(imgs) - 1]
    scale = 1.0 / 255.0

    got = native.gather_u8_f32(imgs, idcs, scale)
    want = np.asarray(imgs[idcs], np.float32) * scale
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_native.gather_u8_to_f32(imgs, idcs,
                                                           scale))

    got = native.gather_u8_mul(imgs, idcs, mul)
    want = (np.asarray(imgs[idcs]) * mul).astype(np.uint8)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, jax_native.gather_u8_scaled(imgs, idcs, mul))

    got = native.gather_u8(imgs, idcs)
    assert np.array_equal(got, imgs[idcs])
    assert np.array_equal(got, jax_native.gather_u8_scaled(imgs, idcs, 1))


def test_gather_checks_its_arguments():
    imgs = np.arange(5 * 2 * 2, dtype=np.uint8).reshape(5, 2, 2, 1)
    # negative indices wrap as numpy wraps them; an empty batch is empty
    assert np.array_equal(native.gather_u8(imgs, [-1, 0, -5]),
                          imgs[[-1, 0, -5]])
    assert native.gather_u8_f32(imgs, [], 0.5).shape == (0, 2, 2, 1)
    with pytest.raises(IndexError):
        native.gather_u8(imgs, [5])
    with pytest.raises(IndexError):
        native.gather_u8(imgs, [-6])
    with pytest.raises(TypeError):
        native.gather_u8(imgs[::2], [0])  # not C-contiguous
    with pytest.raises(TypeError):
        native.gather_u8(imgs.astype(np.int16), [0])


def test_threads_scale_with_the_bytes_written(monkeypatch):
    """One thread per BYTES_PER_THREAD written, at least one and at most
    N_THREADS (the JAX package's min(8, cpu count))."""
    assert native.N_THREADS == min(8, os.cpu_count())
    monkeypatch.setattr(native, "N_THREADS", 8)
    per = native.BYTES_PER_THREAD
    assert [native.threads(n) for n in (1, per, per + 1, 3 * per,
                                        100 * per)] == [1, 1, 2, 3, 8]


def _pair(imgs, binary):
    """The same store as an ArrayDataset of each package; `binary` makes
    it a {0, 1} store with the bitpacked wire format, as dsprites."""
    out = []
    for mod in (JD, PD):
        ds = mod.ArrayDataset(imgs)
        if binary:
            ds.is_binary, ds._scale = True, 1.0
        out.append(ds)
    return out


@pytest.mark.parametrize("store", ["contiguous", "strided"])
@pytest.mark.parametrize("binary", [False, True], ids=["bytes", "bits"])
def test_get_batch_matches_jax_datasets(binary, store):
    """get_batch, get_batch_raw and get_batch_bits of the port equal the
    JAX package's: through the native gather (one call per batch) on a
    C-contiguous store, through numpy on a strided one."""
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 2 if binary else 256, (40, 8, 8, 3)).astype(
        np.uint8)
    j_ds, p_ds = _pair(imgs, binary)
    if store == "strided":  # a view that skips every other row
        big = np.repeat(imgs, 2, axis=0)
        j_ds.imgs = p_ds.imgs = big[::2]
        assert not p_ds.imgs.flags["C_CONTIGUOUS"]
    idcs = rng.randint(0, 40, 13)
    fns = [("get_batch", native.gather_u8_f32),
           ("get_batch_raw", native.gather_u8 if binary
            else native.gather_u8_mul)]
    if binary:
        fns.append(("get_batch_bits", native.gather_u8))
    for name, fn in fns:
        before = fn.calls
        got, got_labels = getattr(p_ds, name)(idcs)
        want, want_labels = getattr(j_ds, name)(idcs)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(got_labels, want_labels)
        assert fn.calls - before == (store == "contiguous"), name


def test_failed_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: a compiler that cannot run fails the gather."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.library()
    ds = PD.ArrayDataset(np.zeros((4, 2, 2, 1), np.uint8))
    with pytest.raises(RuntimeError, match="no-such-g"):
        ds.get_batch([0, 1])


WORKER = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from disvae_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
imgs = np.arange(6 * 4 * 4, dtype=np.uint8).reshape(6, 4, 4, 1)
assert np.array_equal(native.gather_u8(imgs, [5, 0, 3]), imgs[[5, 0, 3]])
print(native.build())
"""


def test_six_concurrent_builds_leave_one_library(tmp_path):
    """Six processes (the test workers' count) build into one empty
    directory at once: each gathers correctly, and one library is left,
    with no temporary file."""
    build = tmp_path / "build"
    code = WORKER.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    paths = {out.strip().splitlines()[-1] for out in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build)) == [os.path.basename(paths.pop())]
