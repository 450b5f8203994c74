"""Synthetic batches made on the device (``ddlbench_tpu/data/synthetic.py``).

Each batch comes from a ``torch.Generator`` seeded per (seed, epoch, step),
so every batch is distinct and reproducible, and is drawn on the device the
model runs on: no host I/O. Images: uniform [0, 1) pixels normalised as
``(x - 0.5) / 0.2887`` (the std of U[0, 1)), float32 ``[B, C, H, W]``
(channels_last on the card, the layout the image models run in there), and
labels uniform over the classes. Tokens: T+1 tokens are drawn, and the
inputs and labels are their two length-T shifts; a seq2seq stream
([source | target]) also masks the source-internal labels
(:func:`mask_source_labels`). The streams are not JAX's (the two
generators differ); tests feed both packages one numpy batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ddlbench_tpu_torch.config import DatasetSpec

# odd multiplier that folds (seed, epoch, step) into one generator seed
_FOLD = 1_000_003


def mask_source_labels(labels: torch.Tensor, src_len: int) -> torch.Tensor:
    """Mask (-1) the source-internal label positions of a seq2seq stream:
    position src_len-1 predicts the first target token, so positions
    < src_len-1 are masked and the loss covers exactly the target
    segment."""
    pos = torch.arange(labels.shape[-1], device=labels.device)
    return torch.where(pos >= src_len - 1, labels, -1)


@dataclasses.dataclass(frozen=True)
class SyntheticData:
    """Synthetic dataset bound to one DatasetSpec and device."""

    spec: DatasetSpec
    batch_size: int
    device: torch.device
    seed: int = 1
    train_size_override: Optional[int] = None
    test_size_override: Optional[int] = None

    @property
    def train_size(self) -> int:
        return self.train_size_override or self.spec.train_size

    @property
    def test_size(self) -> int:
        return self.test_size_override or self.spec.test_size

    def steps_per_epoch(self, train: bool = True) -> int:
        n = self.train_size if train else self.test_size
        return max(1, n // self.batch_size)

    def batch(self, epoch: int, step: int,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, y) on the device: images float32 [batch, C, H, W] and int64
        labels [batch]; tokens int64 [batch, T], y being x shifted by one
        (source positions masked for a seq2seq stream)."""
        seed = self.seed + (0 if train else 1_000_003)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((seed * _FOLD + epoch) * _FOLD + step) % (1 << 63))
        if self.spec.kind == "image":
            h, w, c = self.spec.image_size
            x = torch.rand((self.batch_size, c, h, w), generator=gen,
                           device=self.device)
            x = (x - 0.5) / 0.2887
            if self.device.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            y = torch.randint(0, self.spec.num_classes, (self.batch_size,),
                              generator=gen, device=self.device)
            return x, y
        T = self.spec.seq_len
        seq = torch.randint(0, self.spec.num_classes, (self.batch_size, T + 1),
                            generator=gen, device=self.device)
        if self.spec.kind == "seq2seq":
            return seq[:, :-1], mask_source_labels(seq[:, 1:],
                                                   self.spec.src_len)
        return seq[:, :-1], seq[:, 1:]


def make_synthetic(spec: DatasetSpec, batch_size: int, device: torch.device,
                   seed: int = 1,
                   steps_per_epoch: Optional[int] = None) -> SyntheticData:
    """Build a SyntheticData; ``steps_per_epoch`` overrides the dataset-size
    step counts, as in the reference."""
    train = steps_per_epoch * batch_size if steps_per_epoch else None
    test = (max(batch_size, steps_per_epoch * batch_size // 5)
            if steps_per_epoch else None)
    return SyntheticData(spec, batch_size, device, seed, train, test)
