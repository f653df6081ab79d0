"""Plotting helpers: grid assembly, log parsing, PNG and GIF files.

Counterpart of disvae_tpu/utils/viz_helpers.py. The grid helpers
(`make_grid`, `make_grid_img`, `concatenate_pad`, `sort_list_by_other`) are
copied from it (numpy only; importing the JAX package would load JAX). The
JAX module writes its files with PIL and imageio and reads the loss log
with pandas; this one needs none of them:

* PNG: 8-bit RGB (or grey) rows, filter byte 0, one zlib IDAT chunk.
* GIF: GIF89a with a NETSCAPE2.0 loop block, a frame delay of
  round(100 / fps) centiseconds and one local colour table per frame.
  The LZW stream keeps every code 9 bits wide: a clear code before every
  254 literals keeps the decoder's dictionary below 512 entries, so the
  codes are plain literals and the encoder is vectorised in numpy.
  `read_gif` reads that encoding back, and only that one.
* Palette: a frame with at most 256 distinct colours (every grey frame)
  gets them exactly; any other frame is mapped to the nearest colour of a
  fixed uniform 6 x 7 x 6 RGB palette, whose levels are at most 25 apart
  from any uint8 value in each channel (`GIF_MAX_ERR`).
* The CSV log is read with the `csv` module.
* `add_labels` draws with a 5 x 7 bitmap font of its own; the geometry
  (a 100 px white margin, one label per row band) is the JAX module's, the
  glyphs are not PIL's.
"""

import csv
import random
import struct
import zlib

import numpy as np

FPS_GIF = 12
LABEL_MARGIN = 100
# Largest per-channel error of the GIF palette on a frame of more than 256
# colours (the uniform palette below); frames of fewer colours are exact.
GIF_MAX_ERR = 25

_LEVELS = (6, 7, 6)  # uniform palette levels per channel (R, G, B)
_LITERALS_PER_CLEAR = 254


def get_samples(dataset, num_samples, idcs=None):
    """Fixed indices first, then a `random.sample` fill. Returns float32
    (N, H, W, C)."""
    from disvae_tpu_torch.data.datasets import get_dataset
    idcs = list(idcs) if idcs is not None else []  # `if idcs` breaks on arrays
    ds = dataset if not isinstance(dataset, str) else get_dataset(dataset)()
    if len(idcs) > num_samples:
        idcs = idcs[:num_samples]
    idcs += random.sample(range(len(ds)), num_samples - len(idcs))
    samples, _ = ds.get_batch(np.asarray(idcs))
    print("Selected idcs: {}".format(idcs))
    return samples


def sort_list_by_other(to_sort, other, reverse=True):
    """Sort a list by another list's values."""
    return [el for _, el in sorted(zip(other, to_sort), key=lambda p: p[0],
                                   reverse=reverse)]


def read_loss_from_file(log_file_path, loss_to_fetch):
    """Per-dimension values of `loss_to_fetch` ('kl_loss_') at the final
    logged epoch, ordered by dimension index. The `Epoch,Loss,Value` schema
    of train_losses.log is load-bearing here."""
    with open(log_file_path, newline="") as f:
        rows = list(csv.DictReader(f))
    last = max(int(r["Epoch"]) for r in rows)
    picked = [(int(r["Loss"].replace(loss_to_fetch, "")), float(r["Value"]))
              for r in rows
              if int(r["Epoch"]) == last
              and r["Loss"].startswith(loss_to_fetch)]
    return [v for _, v in sorted(picked, key=lambda p: p[0])]


def make_grid(imgs, nrow=8, padding=2, pad_value=0.0):
    """torchvision-compatible image grid. imgs: float (B, H, W, C) in [0,1].
    Returns float (H', W', C)."""
    b, h, w, c = imgs.shape
    xmaps = min(nrow, b)
    ymaps = int(np.ceil(b / xmaps))
    H, W = h + padding, w + padding
    grid = np.full((ymaps * H + padding, xmaps * W + padding, c), pad_value,
                   dtype=np.float32)
    for idx in range(b):
        y, x = divmod(idx, xmaps)
        grid[y * H + padding:y * H + padding + h,
             x * W + padding:x * W + padding + w] = imgs[idx]
    return grid


def make_grid_img(imgs, **kwargs):
    """Grid as uint8 HWC (RGB if C==3 else single channel replicated)."""
    grid = make_grid(np.asarray(imgs), **kwargs)
    grid = np.clip(grid * 255 + 0.5, 0, 255).astype(np.uint8)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


def save_image(imgs, filename, **kwargs):
    """Assemble a grid and write it as PNG."""
    write_png(filename, make_grid_img(imgs, **kwargs))


def concatenate_pad(arrays, pad_size, pad_values, axis=0):
    """Concatenate arrays with constant padding between, before and after."""
    pad = np.ones_like(arrays[0]).take(range(pad_size), axis=axis) * pad_values
    new_arrays = [pad]
    for arr in arrays:
        new_arrays += [arr, pad]
    return np.concatenate(new_arrays, axis=axis)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def _png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(filename, img):
    """Write a uint8 (H, W) grey or (H, W, 3) RGB image."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        colour = 0
    elif img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError("PNG of shape {}: grey or RGB only".format(
            img.shape))
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    with open(filename, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


# --------------------------------------------------------------------------
# GIF
# --------------------------------------------------------------------------

def _uniform_levels(n):
    return np.array([round(k * 255 / (n - 1)) for k in range(n)], np.int32)


def _quantize(frame):
    """(H, W, 3) uint8 -> (indices (H, W) uint8, palette (256, 3) uint8).
    Exact for at most 256 colours, else the uniform 6 x 7 x 6 palette."""
    h, w, _ = frame.shape
    flat = frame.reshape(-1, 3).astype(np.uint32)
    palette = np.zeros((256, 3), np.uint8)
    if (flat[:, 0] == flat[:, 1]).all() and (flat[:, 1] == flat[:, 2]).all():
        palette[:] = np.arange(256, dtype=np.uint8)[:, None]
        return frame[:, :, 0].copy(), palette
    key = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    colours, inverse = np.unique(key, return_inverse=True)
    if len(colours) <= 256:
        palette[:len(colours)] = np.stack(
            [colours >> 16, (colours >> 8) & 255, colours & 255], axis=1)
        return inverse.astype(np.uint8).reshape(h, w), palette
    idx = 0
    for ch, n in enumerate(_LEVELS):
        # nearest of n levels round(k * 255 / (n - 1))
        idx = idx * n + (flat[:, ch].astype(np.int32) * (n - 1) + 127) // 255
    grids = np.meshgrid(*[_uniform_levels(n) for n in _LEVELS],
                        indexing="ij")
    palette[:int(np.prod(_LEVELS))] = np.stack([g.ravel() for g in grids],
                                               axis=1)
    return idx.astype(np.uint8).reshape(h, w), palette


def _lzw_literals(indices):
    """GIF LZW stream (minimum code size 8) of uint8 indices, as
    sub-blocks: every code is a 9-bit literal, with a clear code before
    every `_LITERALS_PER_CLEAR` of them and the end code last."""
    lit = indices.ravel().astype(np.uint16)
    codes = np.insert(lit, np.arange(0, lit.size, _LITERALS_PER_CLEAR), 256)
    codes = np.append(codes, np.uint16(257))
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1)
    data = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    n_full = data.size // 255
    blocks = np.concatenate([np.full((n_full, 1), 255, np.uint8),
                             data[:n_full * 255].reshape(n_full, 255)],
                            axis=1).tobytes()
    tail = data[n_full * 255:]
    if tail.size:
        blocks += bytes([tail.size]) + tail.tobytes()
    return blocks + b"\x00"


def _as_rgb(frame):
    frame = np.asarray(frame, np.uint8)
    if frame.ndim == 2:
        frame = frame[:, :, None]
    if frame.shape[2] not in (1, 3):
        raise ValueError("image of shape {}: grey or RGB only".format(
            frame.shape))
    return np.repeat(frame, 3, axis=2) if frame.shape[2] == 1 else frame


def mimsave(filename, images, fps=FPS_GIF):
    """Write uint8 grey (H, W) or RGB (H, W, 3) frames of one size as a
    looping GIF."""
    frames = [_as_rgb(f) for f in images]
    h, w = frames[0].shape[:2]
    delay = int(round(100 / fps))
    with open(filename, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0x70, 0, 0))
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
                + b"\x00")
        for frame in frames:
            if frame.shape[:2] != (h, w):
                raise ValueError("GIF frames differ in size: {} and {}"
                                 .format(frame.shape[:2], (h, w)))
            indices, palette = _quantize(frame)
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                    + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87))
            f.write(palette.tobytes())
            f.write(b"\x08" + _lzw_literals(indices))
        f.write(b"\x3b")


def _sub_blocks(buf, pos):
    out = bytearray()
    while buf[pos]:
        out += buf[pos + 1:pos + 1 + buf[pos]]
        pos += 1 + buf[pos]
    return bytes(out), pos + 1


def read_gif(filename):
    """Decode a GIF written by `mimsave` into a list of uint8 (H, W, 3)
    frames. Returns (frames, delays in centiseconds, loop count or None).
    Only that encoding is read (full-size frames with a 256-colour local
    table, 9-bit literal LZW codes); any other GIF raises ValueError."""
    with open(filename, "rb") as f:
        buf = f.read()
    w, h, flags = struct.unpack("<HHB", buf[6:11])
    if buf[:6] != b"GIF89a" or flags & 0x80:
        raise ValueError("{} is not a GIF of mimsave's encoding".format(
            filename))
    pos = 13
    frames, delays, loop, delay = [], [], None, 0
    while buf[pos] != 0x3B:
        if buf[pos] == 0x21:
            label = buf[pos + 1]
            body, pos = _sub_blocks(buf, pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0]
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", body[12:14])[0]
            continue
        header = struct.unpack("<BHHHHB", buf[pos:pos + 10])
        if header != (0x2C, 0, 0, w, h, 0x87) or buf[pos + 778] != 8:
            raise ValueError("{}: a frame not of mimsave's encoding".format(
                filename))
        table = np.frombuffer(buf[pos + 10:pos + 778], np.uint8)
        data, pos = _sub_blocks(buf, pos + 779)
        bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
        codes = bits[:bits.size // 9 * 9].reshape(-1, 9).astype(np.uint16) \
            @ (np.uint16(1) << np.arange(9, dtype=np.uint16))
        codes = codes[:np.argmax(codes == 257)]  # up to the end code
        idx = codes[codes != 256]  # clear codes dropped
        if idx.size != w * h or (idx > 255).any():
            raise ValueError("{}: a frame not of mimsave's encoding".format(
                filename))
        frames.append(table.reshape(256, 3)[idx.reshape(h, w)])
        delays.append(delay)
        delay = 0
    return frames, delays, loop


def plot_grid_gifs(filename, grid_files, pad_size=7, pad_values=255):
    """Merge a 2D grid of gif files written by `mimsave` (the port's
    posterior_traversals.gif) into one gif with padding, as the JAX
    module's (used by bin/plot_all.sh) does. The JAX module pads RGBA
    frames; these are RGB."""
    grid_gifs = [[read_gif(f)[0] for f in row] for row in grid_files]
    n_per_gif = len(grid_gifs[0][0])
    imgs = [concatenate_pad([concatenate_pad(
        [gif[i] for gif in row], pad_size, pad_values, axis=1)
        for row in grid_gifs], pad_size, pad_values, axis=0)
        for i in range(n_per_gif)]
    mimsave(filename, imgs)


# --------------------------------------------------------------------------
# labels
# --------------------------------------------------------------------------

# 5 x 7 glyphs of the characters the labels use ("orig", "recon",
# "KL=<float>", nan, inf); any other character is drawn as a box.
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#",
          "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..",
          "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.",
          "..#..", ".#...", "#####"),
    "3": ("#####", "...#.", "..#..", "...#.",
          "....#", "#...#", ".###."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.",
          "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#",
          "....#", "#...#", ".###."),
    "6": ("..##.", ".#...", "#....", "####.",
          "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..",
          ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.",
          "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####",
          "....#", "...#.", ".##.."),
    ".": (".....", ".....", ".....", ".....",
          ".....", ".##..", ".##.."),
    "-": (".....", ".....", ".....", "#####",
          ".....", ".....", "....."),
    "+": (".....", "..#..", "..#..", "#####",
          "..#..", "..#..", "....."),
    "=": (".....", ".....", "#####", ".....",
          "#####", ".....", "....."),
    "K": ("#...#", "#..#.", "#.#..", "##...",
          "#.#..", "#..#.", "#...#"),
    "L": ("#....", "#....", "#....", "#....",
          "#....", "#....", "#####"),
    "o": (".....", ".....", ".###.", "#...#",
          "#...#", "#...#", ".###."),
    "r": (".....", ".....", "#.##.", "##..#",
          "#....", "#....", "#...."),
    "i": ("..#..", ".....", ".##..", "..#..",
          "..#..", "..#..", ".###."),
    "g": (".....", ".####", "#...#", "#...#",
          ".####", "....#", ".###."),
    "e": (".....", ".....", ".###.", "#...#",
          "#####", "#....", ".###."),
    "c": (".....", ".....", ".###.", "#....",
          "#....", "#...#", ".###."),
    "n": (".....", ".....", "#.##.", "##..#",
          "#...#", "#...#", "#...#"),
    "a": (".....", ".....", ".###.", "....#",
          ".####", "#...#", ".####"),
    "f": ("..##.", ".#..#", ".#...", "###..",
          ".#...", ".#...", ".#..."),
    " ": (".....",) * 7,
}
_BOX = ("#####",) + ("#...#",) * 5 + ("#####",)
_GLYPH_W = 5


def _glyph(ch):
    return np.array([[c == "#" for c in row]
                     for row in _GLYPHS.get(ch, _BOX)])


def _draw_text(img, x, y, text):
    """Black 5 x 7 glyphs with a 1 px advance gap, clipped to the image."""
    h, w = img.shape[:2]
    for k, ch in enumerate(text):
        x0 = x + k * (_GLYPH_W + 1)
        ys, xs = np.nonzero(_glyph(ch))
        ys, xs = ys + y, xs + x0
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = 0


def add_labels(input_image, labels):
    """Labels in a white 100 px margin right of a uint8 (H, W, 3) image:
    label i at the top of row band i of len(labels) equal bands, as the
    JAX module places them. Returns the (H, W + 100, 3) uint8 image."""
    img = np.asarray(input_image, np.uint8)
    h, w = img.shape[:2]
    out = np.full((h, w + LABEL_MARGIN, 3), 255, np.uint8)
    out[:, :w] = _as_rgb(img)
    for i, s in enumerate(labels):
        _draw_text(out, w, int((i / len(labels) + 1 / (2 * len(labels))) * h),
                   s)
    return out
