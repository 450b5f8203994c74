"""Synthetic token batches made on the device (the token and seq2seq
branches of ``ddlbench_tpu/data/synthetic.py``).

Each batch comes from a ``torch.Generator`` seeded per (seed, epoch, step),
so every batch is distinct and reproducible, and is drawn on the device the
model runs on: no host I/O. Next-token setup: T+1 tokens are drawn, and the
inputs and labels are their two length-T shifts; a seq2seq stream
([source | target]) also masks the source-internal labels
(:func:`mask_source_labels`). The stream is not JAX's (the two generators
differ); tests feed both packages one numpy batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ddlbench_tpu_torch.config import STREAM_KINDS, DatasetSpec

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
    """Synthetic token dataset bound to one DatasetSpec and device."""

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
        """(x, y) int64 [batch, T] on the device: y is x shifted by one
        (source positions masked for a seq2seq stream)."""
        seed = self.seed + (0 if train else 1_000_003)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((seed * _FOLD + epoch) * _FOLD + step) % (1 << 63))
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
    if spec.kind not in STREAM_KINDS:
        raise ValueError(f"{spec.name}: the port makes token and seq2seq "
                         "batches only")
    train = steps_per_epoch * batch_size if steps_per_epoch else None
    test = (max(batch_size, steps_per_epoch * batch_size // 5)
            if steps_per_epoch else None)
    return SyntheticData(spec, batch_size, device, seed, train, test)
