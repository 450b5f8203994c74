"""scikit-learn's handwritten digits written as MNIST IDX files
(``ddlbench_tpu/data/digits.py``): a small real dataset that needs no
download, the accuracy check of the real-data path.

The 1 797 scans (8x8, values 0..16) are scaled to 0..255, upscaled to the
mnist spec's 28x28 with PIL's bilinear filter, and split, stratified by
class, into about 1 500 train and 300 test images by a fixed seed. Point
the CLI at the directory with ``-b mnist -s --data-dir DIR``; the IDX
import (data/imagefolder.py) turns the files into a raw store on first
use. scikit-learn and PIL are imported only when the files are written.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

TEST_FRACTION = 1.0 / 6.0
_SEED = 20260731
NAMES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
         "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _upscale(images8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """[N, 8, 8] floats in 0..16 -> [N, H, W] uint8 in 0..255 (PIL
    bilinear)."""
    from PIL import Image

    h, w = hw
    scaled = np.clip(images8 * (255.0 / 16.0), 0, 255).astype(np.uint8)
    out = np.empty((scaled.shape[0], h, w), np.uint8)
    for i, im in enumerate(scaled):
        out[i] = np.asarray(
            Image.fromarray(im, mode="L").resize((w, h), Image.BILINEAR))
    return out


def write_idx_images(path: str, images: np.ndarray) -> None:
    n, h, w = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x08, 3))
        f.write(struct.pack(">3I", n, h, w))
        f.write(np.ascontiguousarray(images, np.uint8).tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x08, 1))
        f.write(struct.pack(">I", labels.shape[0]))
        f.write(np.ascontiguousarray(labels, np.uint8).tobytes())


def split_indices(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The stratified (train_idx, test_idx), the same for every call."""
    rng = np.random.default_rng(_SEED)
    train, test = [], []
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        k = max(1, int(round(len(idx) * TEST_FRACTION)))
        test.append(idx[:k])
        train.append(idx[k:])
    train_idx, test_idx = np.concatenate(train), np.concatenate(test)
    rng.shuffle(train_idx)
    rng.shuffle(test_idx)
    return train_idx, test_idx


def export_digits_idx(data_dir: str, hw: Tuple[int, int] = (28, 28)) -> str:
    """Write the train and t10k IDX pairs of the digits under ``data_dir``
    (nothing when all four files are there already); returns
    ``data_dir``."""
    paths = [os.path.join(data_dir, n) for n in NAMES]
    if all(os.path.exists(p) for p in paths):
        return data_dir
    from sklearn.datasets import load_digits

    ds = load_digits()
    images = _upscale(ds.images, hw)
    labels = ds.target.astype(np.uint8)
    train_idx, test_idx = split_indices(labels)
    os.makedirs(data_dir, exist_ok=True)
    write_idx_images(paths[0], images[train_idx])
    write_idx_labels(paths[1], labels[train_idx])
    write_idx_images(paths[2], images[test_idx])
    write_idx_labels(paths[3], labels[test_idx])
    return data_dir
