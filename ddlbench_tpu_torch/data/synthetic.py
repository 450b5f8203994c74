"""Synthetic token batches made on the device (the token branch of
``ddlbench_tpu/data/synthetic.py``).

Each batch comes from a ``torch.Generator`` seeded per (seed, epoch, step),
so every batch is distinct and reproducible, and is drawn on the device the
model runs on: no host I/O. Next-token setup: T+1 tokens are drawn, and the
inputs and labels are their two length-T shifts. The stream is not JAX's
(the two generators differ); tests feed both packages one numpy batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ddlbench_tpu_torch.config import DatasetSpec

# odd multiplier that folds (seed, epoch, step) into one generator seed
_FOLD = 1_000_003


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
        """(x, y) int64 [batch, T] on the device: y is x shifted by one."""
        seed = self.seed + (0 if train else 1_000_003)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((seed * _FOLD + epoch) * _FOLD + step) % (1 << 63))
        T = self.spec.seq_len
        seq = torch.randint(0, self.spec.num_classes, (self.batch_size, T + 1),
                            generator=gen, device=self.device)
        return seq[:, :-1], seq[:, 1:]


def make_synthetic(spec: DatasetSpec, batch_size: int, device: torch.device,
                   seed: int = 1,
                   steps_per_epoch: Optional[int] = None) -> SyntheticData:
    """Build a SyntheticData; ``steps_per_epoch`` overrides the dataset-size
    step counts, as in the reference."""
    if spec.kind != "tokens":
        raise ValueError(f"{spec.name}: the port makes token batches only")
    train = steps_per_epoch * batch_size if steps_per_epoch else None
    test = (max(batch_size, steps_per_epoch * batch_size // 5)
            if steps_per_epoch else None)
    return SyntheticData(spec, batch_size, device, seed, train, test)
