"""On-disk data with SyntheticData's interface
(``ddlbench_tpu/data/ondisk.py``): image, token and seq2seq stores.

Behind the CLI's ``-s``: raw uint8 batches come from the native loader
(data/native_loader.py), which copies each into a fresh host buffer
(pinned on the card); it is uploaded, augmented there and normalised.
The training transforms are the reference training scripts':

* mnist: normalise only;
* cifar10: pad 4 + random 32x32 crop + random horizontal flip;
* imagenet, highres: random horizontal flip (the store holds images at
  the target size, so RandomResizedCrop's rescale has nothing to act on).

Augmentation is keyed as the reference keys it, bit for bit: the key
``fold_in(key(seed), epoch * steps + step)`` is split into a crop key,
which draws each sample's (dy, dx) with ``randint(0, 2 * pad + 1)``, and a
flip key, which draws ``bernoulli(0.5)`` per sample (ops/threefry.py); the
crop reads the zero-padded image at (dy, dx) and the flip reverses W. The
draws are made on the host, an epoch's at once (one vectorised threefry
pass over its steps' keys, on the epoch's first batch), and each batch's
(2B + B words) is uploaded with it.

Normalisation is ``(x / 255 - 0.5) / 0.2887`` in float32, then the
compute dtype: a 256-entry table indexed by the bytes, whose entries are
the reference's jitted formula as XLA computes it (``x * f32(1/255) -
0.5`` in one fused multiply-add, times ``f32(1) / f32(0.2887)``), so the
float32 batch equals the reference's exactly and every device gives the
same bits. Batches are NCHW: the NHWC bytes permuted, which on the card
is the channels_last layout the models run in; labels are int64.

A token or seq2seq store (native_loader.store_hwc: (T+1, 4, 1) bytes a
sample) holds T+1 token ids a sample as little-endian int32, reduced
modulo the vocabulary, as in the reference; a batch is the two length-T
next-token shifts (int64, on the device), and a seq2seq stream masks its
source-internal labels (data/synthetic.mask_source_labels). Its store
labels are not read.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.config import STREAM_KINDS, DatasetSpec
from ddlbench_tpu_torch.data.imagefolder import resolve_split
from ddlbench_tpu_torch.data.native_loader import (NativeDataLoader,
                                                   generate_dataset,
                                                   store_hwc)
from ddlbench_tpu_torch.data.synthetic import mask_source_labels
from ddlbench_tpu_torch.ops import threefry

# dataset -> training augmentation (module docstring)
AUGMENT = {
    "cifar10": dict(pad=4, flip=True),
    "imagenet": dict(pad=0, flip=True),
    "highres": dict(pad=0, flip=True),
}


def normalize_table() -> torch.Tensor:
    """float32 [256]: the normalised value of each byte (module
    docstring). The product u * f32(1/255) is exact in float64, so
    subtracting 0.5 there and rounding once is the fused multiply-add."""
    u = np.arange(256, dtype=np.float64)
    fma = (u * np.float64(np.float32(1 / 255.0)) - 0.5).astype(np.float32)
    return torch.from_numpy(fma * (np.float32(1) / np.float32(0.2887)))


def augment_key(seed: int, epoch: int, steps: int,
                step: Union[int, torch.Tensor]) -> threefry.Key:
    """The key of (epoch, step): ``fold_in(key(seed), epoch * steps +
    step)``; a tensor of steps gives one key per step."""
    return threefry.fold_in(threefry.prng_key(seed), epoch * steps + step)


def draws(key: threefry.Key, batch: int, pad: int, flip: bool):
    """The augmentation's per-sample draws under ``key`` (or under each
    of ``[N]`` keys, with a leading N axis): (crop offsets [B, 2] int64 in
    [0, 2 pad] or None, flips [B] bool or None)."""
    k_crop, k_flip = threefry.split(key)
    offs = threefry.randint(k_crop, (batch, 2), 0, 2 * pad + 1) \
        if pad else None
    flips = threefry.bernoulli(k_flip, 0.5, (batch,)) if flip else None
    return offs, flips


def apply_draws(imgs: torch.Tensor, offs: Optional[torch.Tensor],
                flips: Optional[torch.Tensor], pad: int) -> torch.Tensor:
    """Crop each sample of a uint8 batch [B, H, W, C] out of its
    zero-padded self at its (dy, dx) offset and flip the W axis where its
    flip is set, on the batch's device."""
    B, H, W, _ = imgs.shape
    dev = imgs.device
    if offs is not None:
        offs = offs.to(dev, non_blocking=True)
        padded = F.pad(imgs, (0, 0, pad, pad, pad, pad))
        rows = offs[:, :1] + torch.arange(H, device=dev)
        cols = offs[:, 1:] + torch.arange(W, device=dev)
        imgs = padded[torch.arange(B, device=dev)[:, None, None],
                      rows[:, :, None], cols[:, None, :]]
    if flips is not None:
        m = flips.to(dev, non_blocking=True)
        imgs = torch.where(m[:, None, None, None], imgs.flip(2), imgs)
    return imgs


def augment_u8(imgs: torch.Tensor, key: threefry.Key, pad: int,
               flip: bool) -> torch.Tensor:
    """Random pad-crop and horizontal flip of a uint8 batch [B, H, W, C]
    on its device (module docstring)."""
    return apply_draws(imgs, *draws(key, imgs.shape[0], pad, flip), pad)


class OnDiskData:
    """SyntheticData's interface over raw stores: ``batch(epoch, step,
    train)`` returns (x [B, C, H, W] in ``dtype``, y [B] int64) on
    ``device``, or for a token stream (x, y) int64 [B, T] (module
    docstring). Each split's store is the one :func:`resolve_split` finds
    under ``data_dir`` (a store, an earlier import, or a recognised layout
    imported now), else a synthetic store of ``train_count``/``test_count``
    samples generated there."""

    # batch() advances the loader's sequential stream, whatever (epoch,
    # step) it is asked for: a probe or a warm-up needs its own instance
    stateful_stream = True

    def __init__(self, data_dir: str, spec: DatasetSpec, batch_size: int,
                 device: torch.device, seed: int = 1,
                 dtype: torch.dtype = torch.float32,
                 train_count: Optional[int] = None,
                 test_count: Optional[int] = None, augment: bool = True):
        self.spec, self.batch_size = spec, batch_size
        self.device, self.seed, self.dtype = torch.device(device), seed, dtype
        self.augment_policy = AUGMENT.get(spec.name) if augment else None
        self.table = normalize_table().to(self.device, dtype)
        self._epoch_draws = (None, None)  # (epoch, its draws)
        self._pin = self.device.type == "cuda"
        self._loaders = {}
        for split, count in (("train", train_count), ("test", test_count)):
            split_dir = resolve_split(data_dir, spec, split)
            if split_dir is None:
                split_dir = os.path.join(data_dir, spec.name, split)
                if not os.path.exists(os.path.join(split_dir, "meta.json")):
                    generate_dataset(data_dir, spec, split, count=count,
                                     seed=seed)
            with open(os.path.join(split_dir, "meta.json")) as f:
                meta = json.load(f)
            got, want = (meta["h"], meta["w"], meta["c"]), store_hwc(spec)
            if got != want or meta.get("kind", "image") != spec.kind:
                raise ValueError(
                    f"the store at {split_dir} holds kind="
                    f"{meta.get('kind', 'image')} shape={got}, but the spec "
                    f"wants kind={spec.kind} shape={want}; delete the "
                    "directory or point --data-dir elsewhere")
            self._loaders[split] = NativeDataLoader(
                split_dir, batch_size, seed=seed, shuffle=split == "train")

    def steps_per_epoch(self, train: bool = True) -> int:
        return self._loaders["train" if train else "test"].steps_per_epoch

    def raw(self, train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stream's next batch as host tensors of its own (pinned on
        the card), which the loader copies the batch into: (images [B, H,
        W, C] uint8, labels [B] int32)."""
        loader = self._loaders["train" if train else "test"]
        return loader.next(into=(
            torch.empty(loader.shape, dtype=torch.uint8,
                        pin_memory=self._pin),
            torch.empty((self.batch_size,), dtype=torch.int32,
                        pin_memory=self._pin)))

    def augmented(self, imgs: torch.Tensor, epoch: int, step: int,
                  train: bool = True) -> torch.Tensor:
        """``imgs`` uploaded and, for a training batch under an
        augmentation policy, augmented: uint8 [B, H, W, C] on the
        device."""
        imgs = imgs.to(self.device, non_blocking=True)
        if train and self.augment_policy:
            if self._epoch_draws[0] != epoch:
                steps = self.steps_per_epoch(True)
                key = augment_key(self.seed, epoch, steps,
                                  torch.arange(steps))
                self._epoch_draws = (epoch, draws(
                    key, self.batch_size, **self.augment_policy))
            offs, flips = self._epoch_draws[1]
            imgs = apply_draws(imgs, None if offs is None else offs[step],
                               None if flips is None else flips[step],
                               self.augment_policy["pad"])
        return imgs

    def prepare(self, imgs: torch.Tensor, labels: torch.Tensor, epoch: int,
                step: int, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A raw batch as the model's input on the device: uploaded,
        augmented, normalised, NCHW."""
        u8 = self.augmented(imgs, epoch, step, train)
        x = self.table[u8.int()].permute(0, 3, 1, 2)
        if self.device.type != "cuda":
            x = x.contiguous()
        return x, labels.to(self.device, non_blocking=True).long()

    def tokens(self, raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A token store's raw batch [B, T+1, 4, 1] as the (inputs,
        labels) shifts on the device (module docstring)."""
        flat = raw.numpy().reshape(raw.shape[0], -1)
        ids = torch.from_numpy(flat.view("<i4") % self.spec.num_classes)
        ids = ids.to(self.device).long()
        labels = ids[:, 1:]
        if self.spec.kind == "seq2seq":
            labels = mask_source_labels(labels, self.spec.src_len)
        return ids[:, :-1], labels

    def skip(self, n: int, train: bool = True) -> None:
        """The stream's next ``n`` batches read and dropped, neither
        uploaded nor augmented (a mid-epoch resume's fast-forward,
        data/prefetch.py)."""
        for _ in range(n):
            self.raw(train)

    def batch(self, epoch: int, step: int,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.spec.kind in STREAM_KINDS:
            return self.tokens(self.raw(train)[0])
        return self.prepare(*self.raw(train), epoch, step, train)

    def close(self) -> None:
        for loader in self._loaders.values():
            loader.close()
