"""Plotting helpers: grid assembly, log parsing, PNG and GIF files.

Counterpart of disvae_tpu/utils/viz_helpers.py. The grid helpers
(`make_grid`, `make_grid_img`, `concatenate_pad`, `sort_list_by_other`) are
copied from it (numpy only; importing the JAX package would load JAX). The
JAX module writes its files with PIL and imageio and reads the loss log
with pandas; this one needs none of them:

* PNG: 8-bit RGB (or grey) rows, filter byte 0, one zlib IDAT chunk.
* GIF: GIF89a with a NETSCAPE2.0 loop block, a frame delay of
  round(100 / fps) centiseconds and one local colour table per frame.
  The pixels are LZW-compressed as the GIF format defines it: codes grow
  from 9 to 12 bits as the dictionary fills, and a clear code resets it
  when it holds 4,096 codes. `read_gif` decodes any such GIF (global or
  local tables, any code size, frames smaller than the screen drawn over
  the previous one), as Pillow and imageio write them too.
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
_LZW_CODES = 4096  # GIF LZW codes are at most 12 bits wide


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


def _lzw_encode(indices):
    """GIF LZW stream (minimum code size 8) of uint8 indices, as
    sub-blocks: a clear code first, codes widening from 9 to 12 bits as
    the dictionary grows, a clear code whenever it holds `_LZW_CODES`
    codes, and the end code last."""
    data = indices.ravel().tobytes()
    out = bytearray()
    table = {}
    acc, n_bits, width, next_code = 256, 9, 9, 258  # the clear code
    prefix = data[0]
    for c in data[1:]:
        key = prefix << 8 | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << n_bits
        n_bits += width
        if next_code == _LZW_CODES:
            acc |= 256 << n_bits
            n_bits += width
            table.clear()
            width, next_code = 9, 258
        else:
            table[key] = next_code
            # the decoder adds this code one code later; both widen here
            if next_code == 1 << width:
                width += 1
            next_code += 1
        while n_bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            n_bits -= 8
        prefix = c
    acc |= prefix << n_bits  # the last code
    n_bits += width
    # the decoder adds an entry for the last code too, and may widen before
    # it reads the end code
    if next_code == 1 << width and width < 12:
        width += 1
    acc |= 257 << n_bits
    n_bits += width
    out += acc.to_bytes((n_bits + 7) // 8, "little")
    blocks = bytearray()
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks.append(len(chunk))
        blocks += chunk
    return bytes(blocks) + b"\x00"


def _lzw_decode(data, min_size):
    """The indices of one GIF LZW stream of minimum code size `min_size`
    (the sub-blocks' bytes joined), up to its end code."""
    clear = 1 << min_size
    data = bytes(data) + b"\x00\x00\x00"
    out = bytearray()
    table = []
    pos, width, prev = 0, min_size + 1, None
    end_bits = (len(data) - 3) * 8
    while pos + width <= end_bits:
        code = (int.from_bytes(data[pos >> 3:(pos >> 3) + 3], "little")
                >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev = min_size + 1, None
            continue
        if code == clear + 1:
            return out
        if not table:
            raise ValueError("LZW stream without a leading clear code")
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < _LZW_CODES:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("LZW code {} beyond the dictionary".format(code))
        if len(table) == 1 << width and width < 12:
            width += 1
        out += entry
        prev = entry
    return out


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
            f.write(b"\x08" + _lzw_encode(indices))
        f.write(b"\x3b")


def _sub_blocks(buf, pos):
    out = bytearray()
    while buf[pos]:
        out += buf[pos + 1:pos + 1 + buf[pos]]
        pos += 1 + buf[pos]
    return bytes(out), pos + 1


def read_gif(filename):
    """Decode a GIF into a list of uint8 (H, W, 3) frames. Returns (frames,
    delays in centiseconds, loop count or None). Each frame is drawn over
    the previous one (disposal 0 or 1; a transparent index keeps what is
    under it); the other disposals raise ValueError."""
    with open(filename, "rb") as f:
        buf = f.read()
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("{} is not a GIF".format(filename))
    w, h, flags = struct.unpack("<HHB", buf[6:11])
    pos, table = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        table = np.frombuffer(buf[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
    canvas = np.zeros((h, w, 3), np.uint8)
    frames, delays, loop = [], [], None
    delay, transparent = 0, None
    while buf[pos] != 0x3B:
        if buf[pos] == 0x21:
            label = buf[pos + 1]
            body, pos = _sub_blocks(buf, pos + 2)
            if label == 0xF9:
                if (body[0] >> 2) & 7 > 1:
                    raise ValueError("{}: a frame disposal other than 'keep'"
                                     .format(filename))
                delay = struct.unpack("<H", body[1:3])[0]
                transparent = body[3] if body[0] & 1 else None
            elif label == 0xFF and body[:11] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", body[12:14])[0]
            continue
        if buf[pos] != 0x2C:
            raise ValueError("{}: unknown block 0x{:02x}".format(filename,
                                                                 buf[pos]))
        x, y, fw, fh, fflags = struct.unpack("<HHHHB", buf[pos + 1:pos + 10])
        pos += 10
        palette = table
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            palette = np.frombuffer(buf[pos:pos + n], np.uint8).reshape(-1, 3)
            pos += n
        if palette is None or x + fw > w or y + fh > h:
            raise ValueError("{}: a frame without colours or beyond the "
                             "screen".format(filename))
        data, end = _sub_blocks(buf, pos + 1)
        idx = np.frombuffer(_lzw_decode(data, buf[pos]), np.uint8)
        pos = end
        if idx.size != fw * fh:
            raise ValueError("{}: a frame of {} indices for {} x {} pixels"
                             .format(filename, idx.size, fw, fh))
        rows = np.arange(fh)
        if fflags & 0x40:  # interlaced: rows 0::8, 4::8, 2::4, 1::2
            rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                                   rows[1::2]])
        idx = idx.reshape(fh, fw)[np.argsort(rows)]
        keep = (idx == transparent if transparent is not None
                else np.zeros(idx.shape, bool))
        if (idx[~keep] >= len(palette)).any():
            raise ValueError("{}: an index beyond the frame's colour table"
                             .format(filename))
        region = canvas[y:y + fh, x:x + fw]
        region[~keep] = palette[idx[~keep]]
        frames.append(canvas.copy())
        delays.append(delay)
        delay, transparent = 0, None
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
