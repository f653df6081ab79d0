"""Host-side data pipeline: datasets, the loader and the batch gathers.

Copied from disvae_tpu/data/datasets.py: importing it from the JAX package
would load JAX through disvae_tpu/__init__.py. Same registry, `DataLoader`,
`BaseDataset.get_batch/get_batch_raw/get_batch_bits`, `ArrayDataset` and the
five datasets, over the same uint8 NHWC caches that the `tools/fabricate_*.py`
scripts write. Batches of a C-contiguous uint8 store (an array or a disk
memmap) are gathered by the port's copy of the JAX package's native host
gather (`disvae_tpu_torch/native`, built with g++ at first use); other
stores by numpy, with the same bits. One difference:

- The port never downloads. A missing source file raises with the path to
  place it at (or the `tools/fabricate_*.py` script that writes the cache).

Arrays are NHWC; `get_img_size` reports (C, H, W) for CLI/spec compatibility.
The device side (decompressing wire-format batches) is in train/steps.py.
"""

import abc
import glob
import gzip
import hashlib
import logging
import os
import struct
import zipfile

import numpy as np

from disvae_tpu_torch import native

DATA_ROOT = os.environ.get("DISVAE_DATA_ROOT",
                           os.path.join(os.getcwd(), "data"))

COLOUR_BLACK = 0
COLOUR_WHITE = 1

DATASETS_DICT = {}  # name -> class, filled by @_register
DATASETS = []


def _register(name):
    def wrap(cls):
        DATASETS_DICT[name] = cls
        DATASETS.append(name)
        cls.name = name
        return cls
    return wrap


def get_dataset(dataset):
    """Return the dataset class for `dataset`."""
    dataset = dataset.lower()
    try:
        return DATASETS_DICT[dataset]
    except KeyError:
        raise ValueError("Unknown dataset: {}".format(dataset))


def get_img_size(dataset):
    """(C, H, W) of `dataset`."""
    return get_dataset(dataset).img_size


def get_background(dataset):
    """Background colour of `dataset`, the pad colour of the plots."""
    return get_dataset(dataset).background_color


def get_dataloaders(dataset, root=None, shuffle=True, batch_size=128,
                    logger=logging.getLogger(__name__), seed=None, **kwargs):
    """Build a DataLoader for a registered dataset."""
    Dataset = get_dataset(dataset)
    ds = Dataset(logger=logger) if root is None else Dataset(root=root,
                                                             logger=logger)
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, seed=seed,
                      **kwargs)


class DataLoader:
    """Minimal numpy batch iterator.

    Yields `(images, labels)` with images float32 NHWC in [0, 1] (or the
    uint8 wire format with `raw=True`). Shuffling draws a fresh permutation
    per epoch from a (seed, epoch)-keyed PRNG; `drop_last=False` keeps the
    final partial batch.

    Data-parallel feeding (disvae_tpu/data/datasets.py:95-160):
    `host_slice=(rank, world_size)` makes the loader yield only this rank's
    rows of every global batch, contiguous shares whose union is the
    global permutation; the permutation is (seed, epoch)-keyed, hence the
    same on every rank. With `pad_global_to=M` (the data-axis size) each
    global batch's index list is first padded to the next multiple of M
    by repeating its last index, then split into equal shares, so every
    rank yields equally shaped batches and the pad rows sit at the global
    end, where the mask-aware padded step expects them; the true global
    sizes come from `global_batch_sizes()`. Without pad_global_to the
    shares are np.array_split's (possibly uneven or empty).
    """

    def __init__(self, dataset, batch_size=128, shuffle=False, seed=None,
                 drop_last=False, raw=False, host_slice=None,
                 pad_global_to=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.raw = raw  # yield wire-format uint8 (see get_batch_raw)
        self.host_slice = host_slice
        self.pad_global_to = pad_global_to
        if host_slice is not None and pad_global_to is not None:
            if pad_global_to % host_slice[1]:
                raise ValueError(
                    "pad_global_to={} must be divisible by process_count={}"
                    .format(pad_global_to, host_slice[1]))
        if host_slice is not None and host_slice[1] > 1 and shuffle \
                and seed is None:
            # each rank draws the permutation itself: without a shared
            # seed the shares come from different permutations
            raise ValueError(
                "host_slice feeding with shuffle=True requires a seed: the "
                "(seed, epoch)-keyed permutation must be identical on every "
                "host.")
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def global_batch_sizes(self):
        """True global size of each batch of an epoch, whatever the
        host_slice and padding: the padded step needs the global (not the
        rank's) count of valid rows."""
        n = len(self.dataset)
        sizes = [self.batch_size] * (n // self.batch_size)
        if not self.drop_last and n % self.batch_size:
            sizes.append(n % self.batch_size)
        return sizes

    def epoch_order(self):
        """This epoch's index order; advances the epoch counter."""
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        if self.seed is None:
            rng = np.random.default_rng()
        else:
            rng = np.random.default_rng((int(self.seed), self._epoch))
        self._epoch += 1
        return rng.permutation(n)

    def __iter__(self):
        n = len(self.dataset)
        order = self.epoch_order()
        end = (n - n % self.batch_size) if self.drop_last else n
        for i in range(0, end, self.batch_size):
            idcs = order[i:i + self.batch_size]
            if self.drop_last and len(idcs) < self.batch_size:
                break
            if self.host_slice is not None:
                pi, pn = self.host_slice
                if self.pad_global_to is not None:
                    m = self.pad_global_to
                    padded_n = -(-len(idcs) // m) * m
                    if padded_n > len(idcs):
                        idcs = np.concatenate(
                            [idcs, np.repeat(idcs[-1:],
                                             padded_n - len(idcs))])
                    share = padded_n // pn
                    idcs = idcs[pi * share:(pi + 1) * share]
                else:
                    idcs = np.array_split(idcs, pn)[pi]
                    if len(idcs) == 0:
                        continue
            if self.raw:
                yield self.dataset.get_batch_raw(idcs)
            else:
                yield self.dataset.get_batch(idcs)


class BaseDataset(abc.ABC):
    """A dataset is a uint8 NHWC array (usually a disk memmap) + labels.

    Subclasses set class attrs `img_size` (C, H, W), `background_color`, and
    optionally the dsprites factor lattice (`lat_sizes`, `lat_names`,
    `lat_values`). `_scale` converts stored uint8 to [0,1] floats.
    """

    img_size = None
    background_color = COLOUR_BLACK
    lat_sizes = None
    lat_names = None
    _scale = 1.0 / 255.0

    def __init__(self, imgs, labels=None):
        self.imgs = imgs
        if labels is None:
            labels = np.zeros((len(imgs),), np.int32)
        self.labels = labels

    def __len__(self):
        return len(self.imgs)

    def _native(self):
        """The native gather serves C-contiguous uint8 stores (arrays and
        memmaps alike)."""
        return (isinstance(self.imgs, np.ndarray)
                and self.imgs.dtype == np.uint8
                and self.imgs.flags["C_CONTIGUOUS"])

    def get_batch(self, idcs):
        """Gather a batch: float32 (B, H, W, C) in [0,1] plus labels."""
        idcs = np.asarray(idcs)
        if self._native():
            imgs = native.gather_u8_f32(self.imgs, idcs, self._scale)
        else:
            imgs = np.asarray(self.imgs[idcs], np.float32) * self._scale
        return imgs, np.asarray(self.labels[idcs])

    # binary datasets (values in {0, 1}) additionally support the bitpacked
    # wire format below — 32x fewer host->device bytes than f32
    is_binary = False

    def get_batch_raw(self, idcs):
        """Gather a batch as WIRE-FORMAT uint8 (intensity = value / 255) plus
        labels; train/steps.py `_decompress_batch` converts on the device.
        Storage conventions are renormalized here (dsprites stores {0,1})."""
        idcs = np.asarray(idcs)
        if self.is_binary:
            return self.get_batch_bits(idcs)
        mul = int(round(255 * self._scale))
        if self._native():
            out = native.gather_u8_mul(self.imgs, idcs, mul)
        else:
            out = (np.asarray(self.imgs[idcs]) * mul).astype(np.uint8)
        return out, np.asarray(self.labels[idcs])

    def get_batch_bits(self, idcs):
        """Binary-dataset wire format: 1 bit per pixel, (B, n_pixels/8)
        uint8 (np.packbits big-endian bit order)."""
        idcs = np.asarray(idcs)
        if self._native():
            rows = native.gather_u8(self.imgs, idcs)
        else:
            rows = np.asarray(self.imgs[idcs], np.uint8)
        packed = np.packbits(rows.reshape(len(idcs), -1), axis=1)
        return packed, np.asarray(self.labels[idcs])


class ArrayDataset(BaseDataset):
    """In-memory dataset over a uint8 (N, H, W, C) array, with optional
    factor metadata so synthetic lattices can exercise the MIG/AAM path."""

    def __init__(self, imgs, labels=None, lat_sizes=None, lat_names=None):
        super().__init__(np.asarray(imgs, np.uint8), labels)
        if lat_sizes is not None:
            self.lat_sizes = np.asarray(lat_sizes)
        if lat_names is not None:
            self.lat_names = tuple(lat_names)
        h, w, c = self.imgs.shape[1:]
        self.img_size = (c, h, w)


# --------------------------------------------------------------------------
# cache helpers
# --------------------------------------------------------------------------

def _require_file(path, url):
    """The port reads only local files: a missing source raises with the
    path to place it at (and the URL it comes from)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            "{} not found. Place the file from {} there, or write the "
            "dataset cache with tools/fabricate_*.py.".format(path, url))
    return path


def _md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_idx(path):
    """Parse an (optionally gzipped) IDX file (MNIST format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def _resize_batch(imgs, size, resample="bilinear", grayscale=False):
    """Resize a uint8 (N, H, W[, C]) stack with PIL (bilinear, as
    torchvision.transforms.Resize defaults)."""
    from PIL import Image
    rs = Image.BILINEAR if resample == "bilinear" else Image.LANCZOS
    out = []
    for img in imgs:
        im = Image.fromarray(img)
        if grayscale:
            im = im.convert("L")
        im = im.resize((size, size), rs)
        out.append(np.asarray(im, np.uint8))
    out = np.stack(out)
    if out.ndim == 3:
        out = out[..., None]
    return out


def _memmap_cache(cache_path, builder, logger):
    """Build `cache_path` (uint8 .npy) once via `builder()` then memory-map
    it, so multi-GB stacks never have to fit in host RAM."""
    if not os.path.exists(cache_path):
        arr = builder()
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        tmp = cache_path + ".tmp.npy"
        np.save(tmp, np.ascontiguousarray(arr, dtype=np.uint8))
        os.replace(tmp, cache_path)
        if logger:
            logger.info("Cached {} ({} images)".format(cache_path, len(arr)))
    return np.load(cache_path, mmap_mode="r")


# --------------------------------------------------------------------------
# real datasets
# --------------------------------------------------------------------------

@_register("mnist")
class MNIST(BaseDataset):
    """MNIST train split, resized 28->32."""

    img_size = (1, 32, 32)
    background_color = COLOUR_BLACK
    urls = {
        "images": "https://storage.googleapis.com/cvdf-datasets/mnist/"
                  "train-images-idx3-ubyte.gz",
        "labels": "https://storage.googleapis.com/cvdf-datasets/mnist/"
                  "train-labels-idx1-ubyte.gz",
    }
    files = {"images": "train-images-idx3-ubyte.gz",
             "labels": "train-labels-idx1-ubyte.gz"}

    def __init__(self, root=None, logger=logging.getLogger(__name__)):
        root = root or os.path.join(DATA_ROOT, type(self).name)
        cache = os.path.join(root, "train32.npz")

        if not os.path.exists(cache):
            raw = _require_file(os.path.join(root, self.files["images"]),
                                self.urls["images"])
            imgs = _resize_batch(_load_idx(raw), 32)
            labels_path = _require_file(
                os.path.join(root, self.files["labels"]),
                self.urls["labels"])
            labels = _load_idx(labels_path).astype(np.int32)
            os.makedirs(root, exist_ok=True)
            tmp = cache + ".tmp.npz"
            np.savez_compressed(tmp, imgs=imgs, labels=labels)
            os.replace(tmp, cache)
            if logger:
                logger.info("Cached {} ({} images)".format(cache, len(imgs)))

        with np.load(cache) as z:
            imgs = np.asarray(z["imgs"], np.uint8)
            labels = np.asarray(z["labels"], np.int32)
        super().__init__(imgs, labels)


@_register("fashion")
class FashionMNIST(MNIST):
    """FashionMNIST train split."""

    urls = {
        "images": "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com"
                  "/train-images-idx3-ubyte.gz",
        "labels": "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com"
                  "/train-labels-idx1-ubyte.gz",
    }


@_register("dsprites")
class DSprites(BaseDataset):
    """dSprites: 737,280 binary 64x64 sprites on a (3,6,40,32,32) factor
    lattice. Stored values are {0,1} so `_scale` is 1. Labels are the
    6-vector `latents_values`."""

    img_size = (1, 64, 64)
    background_color = COLOUR_BLACK
    lat_sizes = np.array([3, 6, 40, 32, 32])
    lat_names = ("shape", "scale", "orientation", "posX", "posY")
    lat_values = {
        "posX": np.linspace(0, 1, 32),
        "posY": np.linspace(0, 1, 32),
        "scale": np.linspace(0.5, 1, 6),
        "orientation": np.linspace(0, 2 * np.pi, 40),
        "shape": np.array([1., 2., 3.]),
        "color": np.array([1.]),
    }
    urls = {"train": "https://github.com/deepmind/dsprites-dataset/blob/"
                     "master/dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
                     "?raw=true"}
    files = {"train": "dsprite_train.npz"}
    _scale = 1.0
    is_binary = True

    def __init__(self, root=None, logger=logging.getLogger(__name__)):
        root = root or os.path.join(DATA_ROOT, type(self).name)
        npz_path = os.path.join(root, self.files["train"])
        imgs_cache = os.path.join(root, "dsprites_imgs.npy")
        lat_cache = os.path.join(root, "dsprites_latents.npy")

        if not (os.path.exists(imgs_cache) and os.path.exists(lat_cache)):
            _require_file(npz_path, self.urls["train"])
            with np.load(npz_path, allow_pickle=True) as z:
                imgs = z["imgs"][..., None]  # (N, 64, 64, 1) uint8 {0,1}
                lat = z["latents_values"].astype(np.float32)
            os.makedirs(root, exist_ok=True)
            np.save(lat_cache, lat)
            tmp = imgs_cache + ".tmp.npy"
            np.save(tmp, np.ascontiguousarray(imgs, np.uint8))
            os.replace(tmp, imgs_cache)

        imgs = np.load(imgs_cache, mmap_mode="r")
        labels = np.load(lat_cache)
        super().__init__(imgs, labels)


@_register("celeba")
class CelebA(BaseDataset):
    """CelebA aligned faces, resized to 64x64 and packed into one memmapped
    uint8 stack."""

    img_size = (3, 64, 64)
    background_color = COLOUR_WHITE
    urls = {"train": "https://s3-us-west-1.amazonaws.com/udacity-dlnfd/"
                     "datasets/celeba.zip"}
    files = {"train": "img_align_celeba.zip"}
    zip_md5 = "00d2c5bc6d35e252742224ab0c1e8fcb"

    def __init__(self, root=None, logger=logging.getLogger(__name__)):
        root = root or os.path.join(DATA_ROOT, type(self).name)
        cache = os.path.join(root, "celeba_64.npy")

        def build():
            img_dir = os.path.join(root, "img_align_celeba")
            if not os.path.isdir(img_dir):
                zip_path = os.path.join(root, self.files["train"])
                _require_file(zip_path, self.urls["train"])
                got = _md5(zip_path)
                if got != self.zip_md5:
                    raise RuntimeError("{} md5 mismatch: {} != {}".format(
                        zip_path, got, self.zip_md5))
                with zipfile.ZipFile(zip_path) as zf:
                    zf.extractall(root)
            from PIL import Image
            paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
            if not paths:
                raise RuntimeError("No images under {}".format(img_dir))
            out = np.empty((len(paths), 64, 64, 3), np.uint8)
            for i, p in enumerate(paths):
                out[i] = np.asarray(
                    Image.open(p).convert("RGB").resize((64, 64),
                                                        Image.LANCZOS))
            return out

        imgs = _memmap_cache(cache, build, logger)
        super().__init__(imgs)


@_register("chairs")
class Chairs(BaseDataset):
    """3D chairs renders: grayscale 64x64 plain resizes (the reference's
    center-crop is a no-op, reproduced as such)."""

    img_size = (1, 64, 64)
    background_color = COLOUR_WHITE
    urls = {"train": "https://www.di.ens.fr/willow/research/seeing3Dchairs/"
                     "data/rendered_chairs.tar"}
    files = {"train": "chairs.tar"}

    def __init__(self, root=None, logger=logging.getLogger(__name__)):
        root = root or os.path.join(DATA_ROOT, type(self).name)
        cache = os.path.join(root, "chairs_64.npy")

        def build():
            img_root = os.path.join(root, "rendered_chairs")
            if not os.path.isdir(img_root):
                tar_path = os.path.join(root, self.files["train"])
                _require_file(tar_path, self.urls["train"])
                import tarfile
                with tarfile.open(tar_path) as tf:
                    tf.extractall(root)
            paths = sorted(glob.glob(os.path.join(img_root, "**", "*.png"),
                                     recursive=True))
            if not paths:
                raise RuntimeError("No images under {}".format(img_root))
            from PIL import Image
            out = np.empty((len(paths), 64, 64, 1), np.uint8)
            for i, p in enumerate(paths):
                im = Image.open(p).convert("L").resize((64, 64),
                                                       Image.LANCZOS)
                out[i, ..., 0] = np.asarray(im)
            return out

        imgs = _memmap_cache(cache, build, logger)
        super().__init__(imgs)
