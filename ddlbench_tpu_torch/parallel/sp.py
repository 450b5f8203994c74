"""Sequence parallelism with ring attention (``ddlbench_tpu/parallel/
sp.py``): strategy ``sp``.

Every rank holds the whole model and the contiguous T/n slice ``rank`` of
every sequence of the global batch; attention runs the ring
(models/transformer.ring_attention: every rank's K/V block in one
all-gather, the flash kernels B1-B3 on each visible block through
``flash_attention_lse``), and every pointwise layer (LayerNorm, MLP, the
embeddings, the fused head B4-B6, the loss) is local. Parameters are
replicated; their gradients are all-reduced. The step is
parallel/axis_sharded.py's.
"""

from __future__ import annotations

import torch

from ddlbench_tpu_torch.models.transformer import sequence_parallel
from ddlbench_tpu_torch.parallel.axis_sharded import AxisShardedStrategy


class SPStrategy(AxisShardedStrategy):
    """strategy='sp': activations sharded on the sequence axis."""

    def _check_divisibility(self, n: int) -> None:
        T = self.model.in_shape[0]
        if T % n:
            raise ValueError(f"sequence length {T} not divisible by {n} "
                             "devices")

    def _context(self):
        return sequence_parallel(self.comm)

    def _local_batch(self, x: torch.Tensor, y: torch.Tensor):
        Tl = x.shape[1] // self.comm.world
        cols = slice(self.comm.rank * Tl, (self.comm.rank + 1) * Tl)
        return x[:, cols], y[:, cols]
