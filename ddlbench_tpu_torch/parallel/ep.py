"""Expert parallelism (``ddlbench_tpu/parallel/ep.py``): strategy ``ep``.

The rank axis plays both roles, as in the reference: the batch is split
over it (rank r takes its contiguous rows, distributed.local_batch_slice)
and every MoE block's stacked ``experts`` are sharded on it, rank r
holding experts [r E/n, (r + 1) E/n) of each (:func:`expert_param_specs`
names them). Each rank routes its own tokens (the capacity counts them,
so drops differ from single's), the dispatch buffer goes to the experts'
ranks and back by two all_to_alls (models/moe.moe_mlp), and the experts
run as two batched matmuls over the local stack. The replicated
parameters' gradients are all-reduced; an expert shard's gradient is its
rank's own (the exchange's backward brought every rank's tokens to it),
and so is its optimizer state. The step is parallel/axis_sharded.py's.
"""

from __future__ import annotations

from typing import Dict

import torch

from ddlbench_tpu_torch.distributed import local_batch_slice
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.moe import Experts, expert_parallel
from ddlbench_tpu_torch.parallel.axis_sharded import AxisShardedStrategy


def expert_param_specs(model: LayerModel) -> Dict[str, bool]:
    """{"<layer>.<name>": sharded?} for every parameter of ``model``: the
    leaves of an ``experts`` stack are sharded on their leading (expert)
    dimension, everything else is replicated."""
    return {f"{i}.{n}": ".experts." in f".{n}"
            for i, layer in enumerate(model.layers)
            for n, _ in layer.named_parameters()}


class EPStrategy(AxisShardedStrategy):
    """strategy='ep': batch and experts sharded over the ranks."""

    def _check_divisibility(self, n: int) -> None:
        self._specs = expert_param_specs(self.model)
        for i, layer in enumerate(self.model.layers):
            for name, p in layer.named_parameters():
                if self._specs[f"{i}.{name}"] and p.shape[0] % n:
                    raise ValueError(f"{p.shape[0]} experts not divisible "
                                     f"by {n} devices")

    def _context(self):
        return expert_parallel(self.comm)

    def _local_batch(self, x: torch.Tensor, y: torch.Tensor):
        rows = local_batch_slice(x.shape[0], self.comm.rank, self.comm.world)
        return x[rows], y[rows]

    def _is_sharded(self, name: str) -> bool:
        return self._specs[name]

    def _localize(self) -> None:
        """Each expert stack to this rank's E/n experts (once: a stack
        that holds E/n already stays)."""
        n, r = self.comm.world, self.comm.rank
        for m in self.model.modules():
            if not isinstance(m, Experts) or getattr(m, "local", False):
                continue
            per = m.w1.shape[0] // n
            for name, p in list(m.named_parameters(recurse=False)):
                setattr(m, name, torch.nn.Parameter(
                    p.detach()[r * per:(r + 1) * per].clone()))
            m.local = True

    def _gather_sharded(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_gather(t.contiguous()).view(
            self.comm.world * t.shape[0], *t.shape[1:])
