"""The port's visualization against the JAX package's, on the CPU.

Both packages get the same weights (utils/torch_compat.py) and, where the
JAX package draws prior latents with jax.random, the same pinned latents.
Tolerances: helper outputs, traversal latents and PNG files exactly; plot
grids within 1 in uint8 (float32 decodes on both sides differ in
summation order only, which can move one rounding); GIF frames of grey
images exactly, RGB frames within `GIF_MAX_ERR` (25) per channel, the
bound of the port's uniform palette. The JAX package's GIFs go through
Pillow's quantiser, so the two packages' animations are compared through
their frames before quantisation.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from disvae_tpu import cli_viz as jax_cli_viz
from disvae_tpu.data import datasets as JD
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.utils import helpers as JH
from disvae_tpu.utils import modelIO as JIO
from disvae_tpu.utils import visualize as JV
from disvae_tpu.utils import viz_helpers as JVH

from disvae_tpu_torch import cli_viz
from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.vae import VAE
from disvae_tpu_torch.utils import helpers as PH
from disvae_tpu_torch.utils import visualize as PV
from disvae_tpu_torch.utils import viz_helpers as PVH
from disvae_tpu_torch.utils.torch_compat import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_kl_log(path, latent_dim, epochs=2):
    with open(path, "w") as f:
        f.write("Epoch,Loss,Value\n")
        for e in range(epochs):
            f.write("{},loss,{}\n".format(e, 100 - e))
            for d in range(latent_dim):
                f.write("{},kl_loss_{},{}\n".format(e, d,
                                                    (d * 7) % 10 + e + 0.25))


def _weights(img_size, latent_dim, seed=0):
    model, params = jax_init("Burgess", img_size, latent_dim,
                             key=jax.random.PRNGKey(seed))
    port = VAE(img_size, latent_dim)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    return model, params, port.eval()


def _close(a, b, tol=1):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= tol


def _read_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return frames, im.info


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b, nrow, c, pad", [(6, 3, 1, 1.0), (7, 4, 3, 0.0),
                                             (2, 8, 3, 1.0)])
def test_grid_helpers_match_jax(b, nrow, c, pad):
    imgs = np.random.RandomState(b).rand(b, 8, 9, c).astype(np.float32)
    assert np.array_equal(PVH.make_grid(imgs, nrow=nrow, pad_value=pad),
                          JVH.make_grid(imgs, nrow=nrow, pad_value=pad))
    assert np.array_equal(PVH.make_grid_img(imgs, nrow=nrow, pad_value=pad),
                          JVH.make_grid_img(imgs, nrow=nrow, pad_value=pad))
    arrs = [(imgs[i] * 255).astype(np.uint8) for i in range(b)]
    for axis in (0, 1):  # a pad before, between and after: one trailing pad
        assert np.array_equal(PVH.concatenate_pad(arrs, 2, 255, axis=axis),
                              JVH.concatenate_pad(arrs, 2, 255, axis=axis))
    other = list(np.random.RandomState(b + 1).rand(b))
    for reverse in (True, False):
        assert PVH.sort_list_by_other(list(range(b)), other, reverse) == \
            JVH.sort_list_by_other(list(range(b)), other, reverse)


def test_read_loss_from_file_matches_jax(tmp_path):
    path = str(tmp_path / "train_losses.log")
    _write_kl_log(path, latent_dim=12, epochs=3)  # kl_loss_10 sorts after 9
    got = PVH.read_loss_from_file(path, "kl_loss_")
    assert got == JVH.read_loss_from_file(path, "kl_loss_")
    assert got == [(d * 7) % 10 + 2.25 for d in range(12)]


def test_get_samples_indices_match_jax(capsys):
    imgs = (np.random.RandomState(0).rand(50, 32, 32, 1) * 255).astype(
        np.uint8)
    JH.set_seed(5)
    ref = JVH.get_samples(JD.ArrayDataset(imgs), 9, idcs=[4, 2])
    ref_out = capsys.readouterr().out
    PH.set_seed(5)
    got = PVH.get_samples(PD.ArrayDataset(imgs), 9, idcs=[4, 2])
    assert capsys.readouterr().out == ref_out
    assert ref_out.startswith("Selected idcs: [4, 2, ")
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("shape", [(5, 7, 3), (33, 40), (20, 9, 3)])
def test_png_writer_decodes_exactly_with_pil(tmp_path, shape):
    img = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    PVH.write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)


def test_writers_refuse_other_channel_counts(tmp_path):
    rgba = np.zeros((4, 5, 4), np.uint8)
    with pytest.raises(ValueError, match="grey or RGB"):
        PVH.write_png(str(tmp_path / "a.png"), rgba)
    with pytest.raises(ValueError, match="grey or RGB"):
        PVH.mimsave(str(tmp_path / "a.gif"), [rgba])


@pytest.mark.parametrize("kind", ["grey", "rgb", "few_colours"])
def test_gif_writer_decodes_with_pil(tmp_path, kind):
    """Frame count, size, delay (round(100 / 12) = 8 cs) and endless loop;
    grey and <= 256-colour frames exactly, RGB within GIF_MAX_ERR."""
    rng = np.random.RandomState(2)
    if kind == "grey":
        frames = [np.repeat((rng.rand(30, 41, 1) * 255).astype(np.uint8), 3,
                            axis=2) for _ in range(3)]
    elif kind == "rgb":  # 1,230 pixels: more than 256 colours
        frames = [(rng.rand(30, 41, 3) * 255).astype(np.uint8)
                  for _ in range(2)]
    else:
        frames = [(rng.randint(0, 5, (30, 41, 3)) * 60).astype(np.uint8)
                  for _ in range(2)]
    path = str(tmp_path / "a.gif")
    PVH.mimsave(path, frames)
    got, info = _read_frames(path)
    assert len(got) == len(frames)
    assert info["duration"] == 80 and info["loop"] == 0
    err = max(np.abs(g.astype(int) - f).max() for g, f in zip(got, frames))
    if kind == "rgb":
        assert 0 < err <= PVH.GIF_MAX_ERR
    else:
        assert err == 0
    # the port's own reader gives PIL's frames, delays and loop
    own, delays, loop = PVH.read_gif(path)
    assert all(np.array_equal(a, b) for a, b in zip(own, got))
    assert delays == [8] * len(frames) and loop == 0


def test_gif_palette_error_bound_is_tight():
    """The uniform palette's worst per-channel error over all uint8 values
    is GIF_MAX_ERR."""
    v = np.arange(256)
    frame = np.stack(np.meshgrid(v, v[::-1], v[::3], indexing="ij"),
                     axis=-1).reshape(256, -1, 3).astype(np.uint8)
    idx, palette = PVH._quantize(frame)
    assert np.abs(palette[idx].astype(int) - frame).max() == PVH.GIF_MAX_ERR


def test_gif_reader_decodes_pil_lzw(tmp_path):
    """The port's reader decodes a GIF that imageio/Pillow wrote (adaptive
    palettes, a transparent index, interlaced rows, Pillow's LZW codes)
    to Pillow's own frames exactly, with its delays and loop."""
    rng = np.random.RandomState(3)
    frames = [(rng.rand(40, 37, 3) * 255).astype(np.uint8) for _ in range(2)]
    frames += [(rng.randint(0, 4, (40, 37, 1)) * 60).repeat(3, 2).astype(
        np.uint8) for _ in range(2)]
    path = str(tmp_path / "p.gif")
    imageio.mimsave(path, frames, duration=80, loop=0)
    want, _ = _read_frames(path)
    got, delays, loop = PVH.read_gif(path)
    assert len(got) == len(want) == 4
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert delays == [8] * 4 and loop == 0


def _grey_traversal(n_frames=15, rows=10, cols=8, px=32, seed=0):
    """A seeded grey traversal: a grid of blobs, each row's moving along
    its own path over the frames."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:px, :px]
    start, step = rng.rand(rows, cols, 2) * px, rng.randn(rows, 2)
    frames = []
    for t in range(n_frames):
        centre = start + step[:, None] * t
        d2 = ((yy - centre[..., 0, None, None]) ** 2
              + (xx - centre[..., 1, None, None]) ** 2)
        cells = 255 * np.exp(-d2 / 40.0)  # (rows, cols, px, px)
        frames.append(cells.transpose(0, 2, 1, 3).reshape(
            rows * px, cols * px).astype(np.uint8))
    return frames


def test_gif_writer_compresses_like_pil(tmp_path):
    """The port's LZW: a seeded 15-frame grey traversal takes at most 1.5x
    the bytes Pillow writes for the same frames, and Pillow decodes it to
    those frames exactly."""
    frames = _grey_traversal()
    path, pil_path = str(tmp_path / "port.gif"), str(tmp_path / "pil.gif")
    PVH.mimsave(path, frames)
    Image.fromarray(frames[0]).save(
        pil_path, save_all=True, duration=80, loop=0,
        append_images=[Image.fromarray(f) for f in frames[1:]])
    ratio = os.path.getsize(path) / os.path.getsize(pil_path)
    assert ratio <= 1.5, ratio
    got, info = _read_frames(path)
    assert len(got) == 15 and info["duration"] == 80 and info["loop"] == 0
    assert all(np.array_equal(g, np.repeat(f[..., None], 3, 2))
               for g, f in zip(got, frames))


@pytest.mark.parametrize("n", [8445, 19450, 28664])
def test_lzw_end_code_after_a_widening(n):
    """Streams whose last code fills the dictionary to 1,024, 512 and 2,048
    entries (in the 3rd, 6th and 8th dictionary after the clears), so the
    decoder widens before it reads the end code, and the stream ends on a
    byte boundary: both of the port's readers decode them exactly, up to
    the end code."""
    # no pair of indices repeats, so every code is one index: each
    # dictionary takes 3,839 codes before its clear
    data = np.concatenate([np.arange(256) * s % 256
                           for s in range(1, 256, 2)])[:n].astype(np.uint8)
    blocks = PVH._lzw_encode(data)
    stream, _ = PVH._sub_blocks(blocks, 0)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert bytes(smoke._lzw_decode(stream)) == data.tobytes()
    assert bytes(PVH._lzw_decode(stream, 8)) == data.tobytes()


def test_plot_grid_gifs_matches_jax_geometry(tmp_path):
    rng = np.random.RandomState(4)
    files, frames = [], []
    for r in range(2):
        row_f, row_a = [], []
        for c in range(3):
            gif = [np.repeat((rng.rand(10, 12, 1) * 255).astype(np.uint8),
                             3, axis=2) for _ in range(4)]
            path = str(tmp_path / "g{}{}.gif".format(r, c))
            PVH.mimsave(path, gif)
            row_f.append(path)
            row_a.append(gif)
        files.append(row_f)
        frames.append(row_a)
    PVH.plot_grid_gifs(str(tmp_path / "port.gif"), files)
    JVH.plot_grid_gifs(str(tmp_path / "jax.gif"), files)
    got, _ = _read_frames(str(tmp_path / "port.gif"))
    ref, _ = _read_frames(str(tmp_path / "jax.gif"))
    assert len(got) == len(ref) == 4 and got[0].shape == ref[0].shape
    for i, frame in enumerate(got):
        want = PVH.concatenate_pad(
            [PVH.concatenate_pad([g[i] for g in row], 7, 255, axis=1)
             for row in frames], 7, 255, axis=0)
        assert np.array_equal(frame, want)


def test_add_labels_geometry():
    img = (np.random.RandomState(5).rand(70, 40, 3) * 255).astype(np.uint8)
    labels = ["orig", "recon", "KL=12.3456", "KL=nan", "KL=-inf"]
    out = PVH.add_labels(img, labels)
    assert out.shape == (70, 140, 3) and np.array_equal(out[:, :40], img)
    margin = out[:, 40:]
    for i in range(len(labels)):
        y = int((i / len(labels) + 1 / (2 * len(labels))) * 70)
        assert (margin[y:y + 7] == 0).any(), labels[i]  # the text
    assert set(np.unique(margin)) <= {0, 255}


# ----------------------------------------------------------------------
# Visualizer
# ----------------------------------------------------------------------

CASES = [((1, 32, 32), 4, "mnist"), ((3, 64, 64), 10, "celeba")]


@pytest.fixture(params=CASES, ids=["32x32x1_z4", "64x64x3_z10"])
def pair(request, tmp_path):
    img_size, latent_dim, dataset = request.param
    model, params, port = _weights(img_size, latent_dim)
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        _write_kl_log(str(d / "train_losses.log"), latent_dim)
        dirs.append(str(d))
    kw = dict(loss_of_interest="kl_loss_", max_traversal=2)
    c, h, w = img_size
    data = np.random.RandomState(6).rand(16, h, w, c).astype(np.float32)
    return (JV.Visualizer(model, params, dataset, dirs[0], **kw),
            PV.Visualizer(port, dataset, dirs[1], **kw), data)


@pytest.mark.parametrize("max_traversal", [2, 0.475])
def test_traversal_latents_equal_jax(pair, max_traversal):
    jv, pv, _ = pair
    jv.max_traversal = pv.max_traversal = max_traversal
    rng = np.random.RandomState(7)
    D = pv.latent_dim
    stats = (rng.randn(D).astype(np.float32),
             (0.5 * rng.randn(D)).astype(np.float32))
    for s in (None, stats):
        for n in (3, 8):
            assert np.array_equal(pv._traversal_latents(s, n),
                                  jv._traversal_latents(s, n))
    assert pv._get_traversal_range(0.3, 1.7) == jv._get_traversal_range(0.3,
                                                                        1.7)


def test_plot_grids_match_jax(pair, monkeypatch):
    """Every grid the Visualizer renders, within 1 in uint8; the prior
    draws of generate_samples are pinned latents on both sides."""
    jv, pv, data = pair
    jv.save_images = pv.save_images = False
    z = np.random.RandomState(8).randn(6, pv.latent_dim).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(z))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(z))
    _close(pv.generate_samples(size=(2, 3)), jv.generate_samples(size=(2, 3)))
    monkeypatch.undo()
    assert np.array_equal(pv.data_samples(data, size=(2, 4)),
                          jv.data_samples(data, size=(2, 4)))
    _close(pv.reconstruct(data, size=(2, 4)), jv.reconstruct(data,
                                                             size=(2, 4)))
    for d in (None, data[:1]):
        for reorder in (False, True):
            kw = dict(data=d, is_reorder_latents=reorder, n_per_latent=5,
                      n_latents=3)
            _close(pv.traversals(**kw), jv.traversals(**kw))


def test_gif_traversal_frames_match_jax(pair, monkeypatch):
    jv, pv, data = pair
    captured = {}
    monkeypatch.setattr(JV, "mimsave",
                        lambda f, imgs, fps: captured.update(imgs=imgs))
    jv.gif_traversals(data[:3], n_latents=2, n_per_gif=4)
    frames = pv.gif_traversals(data[:3], n_latents=2, n_per_gif=4)
    assert len(frames) == len(captured["imgs"]) == 4
    for a, b in zip(frames, captured["imgs"]):
        _close(a, b)
    got, info = _read_frames(os.path.join(pv.model_dir,
                                          "posterior_traversals.gif"))
    assert len(got) == 4 and info["duration"] == 80
    bound = PVH.GIF_MAX_ERR if data.shape[-1] == 3 else 0
    for a, b in zip(got, frames):
        _close(a, b, tol=bound)


def test_rendered_files_match_jax(pair):
    """Same filenames and image sizes, the 100 px label margin of
    reconstruct_traverse included; pixels within 1 outside the margin."""
    jv, pv, data = pair
    for viz in (jv, pv):
        viz.generate_samples(size=(2, 2))
        viz.data_samples(data, size=(2, 2))
        viz.reconstruct(data, size=(2, 4))
        viz.traversals(data=data[:1], is_reorder_latents=True,
                       n_per_latent=3, n_latents=4)
        viz.traversals(data=None, is_reorder_latents=True, n_per_latent=3,
                       n_latents=2)
        viz.reconstruct_traverse(data, is_posterior=True, n_per_latent=3,
                                 n_latents=4, is_show_text=True)
        viz.gif_traversals(data[:2], n_latents=3, n_per_gif=4)
    names = sorted(os.listdir(jv.model_dir))
    assert names == sorted(os.listdir(pv.model_dir))
    assert "reconstruct_traverse.png" in names and len(names) == 8
    for name in names:
        if name.endswith(".png"):
            a = np.asarray(Image.open(os.path.join(pv.model_dir, name)))
            b = np.asarray(Image.open(os.path.join(jv.model_dir, name))
                           .convert("RGB"))
            assert a.shape == b.shape, name
            if name == "reconstruct_traverse.png":
                a, b = a[:, :-100], b[:, :-100]
            if name != "samples.png":  # prior draws differ
                _close(a, b)
        elif name.endswith(".gif"):
            a, _ = _read_frames(os.path.join(pv.model_dir, name))
            b, _ = _read_frames(os.path.join(jv.model_dir, name))
            assert len(a) == len(b) and a[0].shape == b[0].shape


@pytest.mark.parametrize("training", [True, False])
def test_gif_traversals_training(tmp_path, training):
    """One frame per call, reset after save_reset; each frame leaves the
    model in the mode it found it in."""
    _, _, port = _weights((1, 32, 32), 4)
    port.train(training)
    gif = PV.GifTraversalsTraining(port, "mnist", str(tmp_path),
                                   n_per_latent=3)
    for _ in range(3):
        gif(port)
        assert port.training == training
    assert len(gif.images) == 3 and gif.images[0].shape == (4 * 34 + 2,
                                                            3 * 34 + 2, 3)
    gif.save_reset()
    assert gif.images == []
    frames, _ = _read_frames(str(tmp_path / "training.gif"))
    assert len(frames) == 3
    gif.save_reset()  # nothing collected: nothing written, no error


# ----------------------------------------------------------------------
# both CLIs on one result directory
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--is-posterior", "--is-show-loss"]])
def test_both_cli_viz_render_one_npz_dir(tmp_path, monkeypatch, flags):
    root = tmp_path / "data" / "mnist"
    root.mkdir(parents=True)
    rng = np.random.RandomState(9)
    np.savez_compressed(root / "train32.npz",
                        imgs=(rng.rand(60, 32, 32, 1) * 255).astype(np.uint8),
                        labels=np.zeros(60, np.int32))
    monkeypatch.setattr(PD, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setattr(JD, "DATA_ROOT", str(tmp_path / "data"))
    model, params = jax_init("Burgess", (1, 32, 32), 5,
                             key=jax.random.PRNGKey(1))
    one = tmp_path / "results" / "one"
    one.mkdir(parents=True)
    JIO.save_model(model, params, str(one), metadata=dict(
        dataset="mnist", img_size=[1, 32, 32], latent_dim=5,
        model_type="Burgess"))
    _write_kl_log(str(one / "train_losses.log"), 5)
    for name in ("jax", "port"):
        shutil.copytree(one, tmp_path / "results" / name)
    monkeypatch.chdir(tmp_path)
    argv = ["all", "-s", "3", "-r", "4", "-c", "5"] + flags
    jax_cli_viz.main(jax_cli_viz.parse_arguments(["jax"] + argv))
    seconds = cli_viz.main(cli_viz.parse_arguments(["port"] + argv
                                                   + ["--no-cuda"]))
    assert sorted(seconds) == sorted(p for p in cli_viz.PLOT_TYPES
                                     if p != "all")
    jdir, pdir = tmp_path / "results" / "jax", tmp_path / "results" / "port"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    kind = "posterior" if flags else "prior"
    assert "{}_traversals.png".format(kind) in names
    for name in names:
        if name.endswith(".png"):
            a = np.asarray(Image.open(pdir / name))
            b = np.asarray(Image.open(jdir / name).convert("RGB"))
            assert a.shape == b.shape, name
            if name == "reconstruct_traverse.png" and flags:
                assert a.shape[1] == 5 * 34 + 2 + 100
                a, b = a[:, :-100], b[:, :-100]
            if name != "samples.png":
                _close(a, b)
        elif name.endswith(".gif"):
            a, _ = _read_frames(pdir / name)
            b, _ = _read_frames(jdir / name)
            assert len(a) == len(b) == 15 and a[0].shape == b[0].shape


def test_cli_viz_requires_cuda_or_no_cuda(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no-cuda"):
        cli_viz.main(cli_viz.parse_arguments(["run", "all"]))


def test_viz_path_needs_no_jax_pil_imageio_pandas(tmp_path):
    """With jax, PIL, imageio and pandas unimportable, the port's viz and
    serving modules import and render PNG and GIF files."""
    code = """
import sys
BLOCKED = ("jax", "PIL", "imageio", "pandas", "disvae_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
import disvae_tpu_torch.cli_viz, disvae_tpu_torch.serve
import disvae_tpu_torch.data.synthetic, disvae_tpu_torch.cli
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.utils.visualize import GifTraversalsTraining, Visualizer
m = init_specific_model("Burgess", (1, 32, 32), 3,
                        generator=torch.Generator().manual_seed(0))
v = Visualizer(m, "mnist", sys.argv[1])
v.traversals(n_per_latent=4)
g =GifTraversalsTraining(m, "mnist", sys.argv[1], n_per_latent=3)
g(m); g(m); g.save_reset()
print(sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED))
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert sorted(os.listdir(tmp_path)) == ["prior_traversals.png",
                                            "training.gif"]
