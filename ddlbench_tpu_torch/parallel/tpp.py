"""Composed tensor x pipeline parallelism: Megatron-sliced stages inside
GPipe's fill-drain (``ddlbench_tpu/parallel/tpp.py``
``TPGPipeStrategy``): strategy ``gpipe`` with ``tp_size`` > 1.

The reference compiles one SPMD program over a ``('data', 'stage',
'model')`` mesh. The port runs one process per tensor-parallel shard
(distributed.spawn; rank r is shard r), and each rank walks gpipe's
fill-drain timetable over its own stage devices (parallel/gpipe.py;
distributed.tp_stage_devices: stage s of rank r on ``cuda:(s * tp +
r)``, or every one on a shared card):

* the stage bounds come from the unsliced model's layer costs, as the
  reference computes them before it slices;
* every dense block holds the rank's Megatron slice
  (models/transformer.slice_block): its contiguous head group and its
  MLP columns. Inside every chunk the two row-parallel products are
  summed over the ranks, and the replicated activation entering each
  sliced branch sums its gradient over them
  (models/transformer.tensor_parallel), so every rank computes the same
  activations, loss and replicated gradients (LayerNorms, ``b2``, the
  embedding, the head). Nothing sums those gradients again: the
  reference gets the same math by psumming the replicated leaves'
  gradients over 'model' instead, and doing both would count them tp
  times;
* the update is gpipe's (common.flat_optimizer, per chunk) on the
  rank's parameters: its slices and its copy of the replicated ones
  (``reduced_grads`` gives the rank's gradients, a sliced leaf's its
  shard's);
* a chunk's sums run on its stage's device; over NCCL, whose group is
  bound to the rank's first card, a later stage's sums are staged
  through that card (distributed.Comm);
* the head is the unfused CE head, the reference's scope: with
  ``fused_head_loss`` set it prints the reference's note on stderr
  (rank 0, as the reference's one process prints it once).

Every rank builds the whole model from ``cfg.seed`` before it slices,
so the ranks start from one set of weights. ``dp_replicas`` > 1 with
``tp_size`` > 1 (3-D parallelism) is refused by RunConfig (ROADMAP A.7b:
it needs dp x tp ranks); hybrid PP x DP alone runs on gpipe's replicas
(parallel/gpipe.py).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.transformer import (TP_SLICED_KEYS,
                                                   slice_block,
                                                   tensor_parallel)
from ddlbench_tpu_torch.parallel.common import head_fusable
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy


class TPGPipeStrategy(GPipeStrategy):
    """strategy='gpipe' + tp_size > 1 on rank ``comm.rank`` of the tp
    group ``comm`` (module docstring): S stages on ``devices``."""

    def __init__(self, model: LayerModel, cfg: RunConfig,
                 devices: Sequence[torch.device], comm: Comm,
                 stage_bounds: Optional[Sequence[int]] = None):
        if comm.world != cfg.tp_size:
            raise ValueError(f"a world of {comm.world} ranks for "
                             f"tp_size={cfg.tp_size}")
        self.comm = comm
        self.tp = cfg.tp_size
        # the bounds and boundary shapes are the unsliced model's
        super().__init__(model, cfg, devices, stage_bounds)
        sliced = [slice_block(layer, comm.rank, self.tp)
                  for layer in model.layers]
        if not any(sliced):
            raise ValueError(
                f"tp_size={self.tp}: no layer of {model.name} is "
                "TP-shardable (models/transformer.tp_split_layer_params)")
        # each stage's count of replicated elements (the reference's
        # _rp_lens: comm_stats prices their all-reduce over the tp group)
        self._rp_lens = [
            sum(p.numel() for i in range(self.bounds[c], self.bounds[c + 1])
                for name, p in model.layers[i].named_parameters()
                if not (sliced[i] and name in TP_SLICED_KEYS))
            for c in range(self.num_chunks)]
        if cfg.fused_head_loss and head_fusable(model) and comm.rank == 0:
            print("tpp: fused projection+loss head is not supported under "
                  "tp_size > 1; using the unfused CE head", file=sys.stderr,
                  flush=True)
        self.fused = False

    @property
    def world_size(self) -> int:
        return len(self.devices) * self.tp

    def _chunk_obj(self, c: int, *args, **kw):
        # the forward's sums, and the backward's through the autograd
        # nodes that keep the Comm they were built with
        with tensor_parallel(self.comm):
            return super()._chunk_obj(c, *args, **kw)
