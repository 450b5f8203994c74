"""Real-dataset ingest: standard on-disk formats -> the native raw store
(``ddlbench_tpu/data/imagefolder.py``).

Imports, once, into the store the native loader reads (``images.bin``
N*H*W*C uint8 + ``labels.bin`` N int32 + ``meta.json``):

* ImageFolder: ``<split>/<class_dir>/*.{jpeg,jpg,png,bmp,ppm,pgm}``; class
  ids in sorted class-directory order; decoded with PIL (imported only
  here: without it the import raises, naming PIL), converted to the
  spec's channels (L/RGB) and resized bilinearly to the spec's size;
* MNIST IDX: ``train-images-idx3-ubyte[.gz]`` + labels (and ``t10k-*``);
* CIFAR-10 python pickles: ``data_batch_1..5`` / ``test_batch`` (CHW rows,
  stored as HWC).

:func:`resolve_split` is the entry OnDiskData uses: the store directory
for (spec, split) under the user's ``--data-dir``, importing a recognised
layout on first use into ``<data_dir>/_imported/<name>/<split>`` (or,
where that is not writable, a directory under the system's temporary
directory keyed by the data directory's path). None means nothing
recognisable is there.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import pickle
import struct
import tempfile
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

_IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".ppm", ".pgm")
# the reference's scripts name the eval split "val"; stores use "test"
_SPLIT_ALIASES = {"train": ("train",), "test": ("test", "val", "valid")}


def _write_meta(out_dir: str, hwc, classes: int, count: int,
                source: str) -> None:
    h, w, c = hwc
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"h": h, "w": w, "c": c, "classes": classes,
                   "count": count, "seed": 0, "kind": "image",
                   "source": os.path.abspath(source)}, f)


def _is_imagefolder(split_dir: str) -> bool:
    if not os.path.isdir(split_dir):
        return False
    for entry in sorted(os.listdir(split_dir))[:64]:
        cls_dir = os.path.join(split_dir, entry)
        if os.path.isdir(cls_dir) and any(
                f.lower().endswith(_IMG_EXTS) for f in os.listdir(cls_dir)):
            return True
    return False


def _list_imagefolder(split_dir: str) -> List[Tuple[str, int]]:
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    samples = []
    for idx, cls in enumerate(classes):
        cls_dir = os.path.join(split_dir, cls)
        samples += [(os.path.join(cls_dir, f), idx)
                    for f in sorted(os.listdir(cls_dir))
                    if f.lower().endswith(_IMG_EXTS)]
    return samples


def import_imagefolder(split_dir: str, out_dir: str, hwc, num_classes: int,
                       limit: Optional[int] = None) -> str:
    """Decode an ImageFolder split into the raw store at ``out_dir``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"importing the ImageFolder tree {split_dir} needs PIL "
            "(Pillow), which is not installed") from e
    h, w, c = hwc
    n_dirs = sum(os.path.isdir(os.path.join(split_dir, d))
                 for d in os.listdir(split_dir))
    if n_dirs > num_classes:
        raise ValueError(
            f"{split_dir} has {n_dirs} class directories but the benchmark "
            f"expects only {num_classes} classes")
    samples = _list_imagefolder(split_dir)[:limit or None]
    if not samples:
        raise ValueError(f"no images found under {split_dir}")
    os.makedirs(out_dir, exist_ok=True)
    mode = "L" if c == 1 else "RGB"
    labels = np.empty(len(samples), np.int32)
    with open(os.path.join(out_dir, "images.bin"), "wb") as fi:
        for i, (path, label) in enumerate(samples):
            with Image.open(path) as im:
                im = im.convert(mode)
                if im.size != (w, h):
                    im = im.resize((w, h), Image.BILINEAR)
                fi.write(np.asarray(im, np.uint8).reshape(h, w, c).tobytes())
            labels[i] = label
    labels.tofile(os.path.join(out_dir, "labels.bin"))
    _write_meta(out_dir, hwc, num_classes, len(samples), split_dir)
    return out_dir


def read_idx(path: str) -> np.ndarray:
    """A uint8 IDX array (MNIST's container; ``.gz`` read through
    gzip)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = data[0] << 8 | data[1], data[2], data[3]
    if zero != 0 or dtype_code != 0x08:
        raise ValueError(f"unsupported IDX file {path}")
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find_idx_pair(root: str, split: str) -> Optional[Tuple[str, str]]:
    prefix = "train" if split == "train" else "t10k"
    imgs = lbls = None
    for d in (root, os.path.join(root, "MNIST", "raw"),
              os.path.join(root, "raw")):
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            if f.startswith(f"{prefix}-images-idx3-ubyte"):
                imgs = os.path.join(d, f)
            if f.startswith(f"{prefix}-labels-idx1-ubyte"):
                lbls = os.path.join(d, f)
        if imgs and lbls:
            return imgs, lbls
    return None


def import_mnist_idx(root: str, out_dir: str, split: str, hwc) -> str:
    pair = _find_idx_pair(root, split)
    if not pair:
        raise FileNotFoundError(
            f"no MNIST IDX files for split {split} under {root}")
    imgs = read_idx(pair[0])  # [N, H, W]
    lbls = read_idx(pair[1]).astype(np.int32)
    h, w, c = hwc
    if imgs.shape[1:] != (h, w) or c != 1:
        raise ValueError(f"IDX images {imgs.shape[1:]} do not match the "
                         f"spec's {hwc}")
    os.makedirs(out_dir, exist_ok=True)
    imgs.tofile(os.path.join(out_dir, "images.bin"))
    lbls.tofile(os.path.join(out_dir, "labels.bin"))
    _write_meta(out_dir, hwc, 10, int(imgs.shape[0]), root)
    return out_dir


def _find_cifar_dir(root: str) -> Optional[str]:
    for d in (root, os.path.join(root, "cifar-10-batches-py")):
        if os.path.exists(os.path.join(d, "data_batch_1")):
            return d
    return None


def import_cifar10(root: str, out_dir: str, split: str, hwc) -> str:
    src = _find_cifar_dir(root)
    if not src:
        raise FileNotFoundError(f"no CIFAR-10 python batches under {root}")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    imgs, lbls = [], []
    for n in names:
        with open(os.path.join(src, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        # rows are 3072 bytes in CHW plane order; the store is HWC
        arr = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
        imgs.append(arr.transpose(0, 2, 3, 1))
        lbls.append(np.asarray(d[b"labels"], np.int32))
    imgs, lbls = np.concatenate(imgs), np.concatenate(lbls)
    if imgs.shape[1:] != tuple(hwc):
        raise ValueError(f"CIFAR images {imgs.shape[1:]} do not match the "
                         f"spec's {hwc}")
    os.makedirs(out_dir, exist_ok=True)
    np.ascontiguousarray(imgs).tofile(os.path.join(out_dir, "images.bin"))
    lbls.tofile(os.path.join(out_dir, "labels.bin"))
    _write_meta(out_dir, hwc, 10, int(imgs.shape[0]), root)
    return out_dir


def _import_cache_dir(data_dir: str, name: str, split: str) -> str:
    base = os.path.join(data_dir, "_imported", name, split)
    try:
        os.makedirs(base, exist_ok=True)
        probe = os.path.join(base, ".w")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return base
    except OSError:
        tag = hashlib.sha1(
            os.path.abspath(data_dir).encode()).hexdigest()[:12]
        alt = os.path.join(tempfile.gettempdir(), "ddlbench_imports", tag,
                           name, split)
        os.makedirs(alt, exist_ok=True)
        return alt


def normalize_split(split: str) -> str:
    """Map the split spellings users write (val, valid) to the store's
    train/test."""
    s = split.strip().lower()
    for canon, aliases in _SPLIT_ALIASES.items():
        if s in aliases:
            return canon
    raise ValueError(
        f"unknown split {split!r}; expected one of "
        f"{sorted(a for al in _SPLIT_ALIASES.values() for a in al)}")


def detect_and_import(data_dir: str, spec, split: str,
                      out_dir: Union[str, Callable[[], str]]
                      ) -> Optional[str]:
    """Find a recognisable layout for (spec, split) under ``data_dir`` and
    import it into the store at ``out_dir`` (a path, or a callable that
    returns one, so a cache directory is made only on a hit). Returns the
    store directory, or None."""
    hwc = tuple(spec.image_size)

    def out():
        return out_dir() if callable(out_dir) else out_dir

    for alias in _SPLIT_ALIASES[split]:
        for d in (os.path.join(data_dir, spec.name, alias),
                  os.path.join(data_dir, alias)):
            if _is_imagefolder(d):
                dest = out()
                print(f"importing ImageFolder {d} -> {dest}", flush=True)
                return import_imagefolder(d, dest, hwc, spec.num_classes)
    if spec.name == "mnist" and _find_idx_pair(data_dir, split):
        dest = out()
        print(f"importing MNIST IDX {data_dir} -> {dest}", flush=True)
        return import_mnist_idx(data_dir, dest, split, hwc)
    if spec.name == "cifar10" and _find_cifar_dir(data_dir):
        dest = out()
        print(f"importing CIFAR-10 batches {data_dir} -> {dest}", flush=True)
        return import_cifar10(data_dir, dest, split, hwc)
    return None


def resolve_split(data_dir: str, spec, split: str) -> Optional[str]:
    """The store directory for (spec, split) under ``data_dir``, searched
    per split alias (train; test, val, valid): a store at
    ``<data_dir>/<name>/<alias>/meta.json``, then an earlier import, then
    an ImageFolder tree (``<data_dir>/<name>/<alias>/`` or
    ``<data_dir>/<alias>/``), MNIST IDX files or CIFAR-10 batches
    (mnist/cifar10 only), imported on first use. None when nothing
    recognisable is there (the caller generates a synthetic store)."""
    if spec.kind != "image":
        return None
    for alias in _SPLIT_ALIASES[split]:
        d = os.path.join(data_dir, spec.name, alias)
        if os.path.exists(os.path.join(d, "meta.json")):
            return d
    base = os.path.join(data_dir, "_imported", spec.name, split)
    if os.path.exists(os.path.join(base, "meta.json")):
        return base
    return detect_and_import(
        data_dir, spec, split,
        lambda: _import_cache_dir(data_dir, spec.name, split))
