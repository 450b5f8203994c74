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
so the ranks start from one set of weights.

3-D tpp (``dp_replicas`` R > 1 with ``tp_size`` T > 1: the reference's
``('data', 'stage', 'model')`` mesh) runs R x T ranks, rank ``d * T +
t`` shard t of replica d (distributed.tpp3d_stage_devices: its stage s
on ``cuda:(d*S*T + s*T + t)``), each holding two groups
(distributed.tpp3d_comms): ``comm``, the T shards of its replica, and
``dp_comm``, shard t of every replica. The walk above is unchanged and
stays on ``comm``; on top of it comes gpipe's hybrid, on ``dp_comm``:

* replica d takes rows ``[m R mb + d mb, ...+ mb)`` of microbatch m, as
  gpipe's hybrid does (:meth:`GPipeStrategy.shard_batch`);
* after the backward every chunk's gradient, sliced and replicated
  leaves alike, is summed over the replicas and divided by R
  (:meth:`GPipeStrategy._finish_step`). That is the only reduction
  added: the replicated leaves already have their sum over the shards
  from ``tensor_parallel``'s backward, where the reference's
  ``pcast``/``vary`` psums them over 'model' and then 'data'; summing
  them over the tp group again would count them T times;
* the loss is averaged over the replicas and the counts summed (the
  reference's ``fold_mean``/``fold_count``), every shard of a replica
  holding the same values already.

``materialize_params`` gives the rank's rows of the reference's two
packed matrices (``sliced`` [S, tp, L_sl]: this shard's row of each
stage; ``repl`` [S, L_rp]); convert.load_tpp_rows loads them.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.parallel.common import _key_part, to_ref_layout
from ddlbench_tpu_torch.models.transformer import (TP_SLICED_KEYS,
                                                   slice_block,
                                                   tensor_parallel)
from ddlbench_tpu_torch.parallel.common import head_fusable
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy


class TPGPipeStrategy(GPipeStrategy):
    """strategy='gpipe' + tp_size > 1 on rank ``comm.rank`` of the tp
    group ``comm`` (module docstring): S stages on ``devices``; with
    ``dp_replicas`` > 1, replica ``dp_comm.rank`` of the 3-D mesh."""

    def __init__(self, model: LayerModel, cfg: RunConfig,
                 devices: Sequence[torch.device], comm: Comm,
                 stage_bounds: Optional[Sequence[int]] = None,
                 dp_comm: Optional[Comm] = None):
        if comm.world != cfg.tp_size:
            raise ValueError(f"a world of {comm.world} ranks for "
                             f"tp_size={cfg.tp_size}")
        self.tp = cfg.tp_size
        # the bounds and boundary shapes are the unsliced model's
        super().__init__(model, cfg, devices, stage_bounds, dp_comm)
        self.tp_comm = comm
        if dp_comm is None:
            self.comm = comm  # rank 0 prints (train/loop.py)
        self._sliced = sliced = [slice_block(layer, comm.rank, self.tp)
                                 for layer in model.layers]
        if not any(sliced):
            raise ValueError(
                f"tp_size={self.tp}: no layer of {model.name} is "
                "TP-shardable (models/transformer.tp_split_layer_params)")
        # each stage's count of replicated elements and of one shard's
        # sliced ones (the reference's _rp_lens, _sl_lens: comm_stats
        # prices their all-reduces over the tp and data groups)
        self._rp_lens, self._sl_lens = [], []
        for c in range(self.num_chunks):
            rows = self._rows(c)
            self._sl_lens.append(sum(p.numel() for p in rows[0]))
            self._rp_lens.append(sum(p.numel() for p in rows[1]))
        if cfg.fused_head_loss and head_fusable(model) and \
                self.comm.rank == comm.rank == 0:
            print("tpp: fused projection+loss head is not supported under "
                  "tp_size > 1; using the unfused CE head", file=sys.stderr,
                  flush=True)
        self.fused = False

    @property
    def world_size(self) -> int:
        return len(self.devices) * self.tp * self.dp

    def _rows(self, c: int):
        """Chunk c's parameters as the reference packs them: (this
        shard's sliced leaves, the replicated leaves), each in the
        reference's leaf order (per layer, the names sorted part by
        part)."""
        sliced, repl = [], []
        for i in range(self.bounds[c], self.bounds[c + 1]):
            named = sorted(self.model.layers[i].named_parameters(),
                           key=lambda kv: tuple(map(_key_part,
                                                    kv[0].split("."))))
            for name, p in named:
                (sliced if self._sliced[i] and name in TP_SLICED_KEYS
                 else repl).append(p)
        return sliced, repl

    def materialize_params(self) -> dict:
        """This rank's rows of the reference's two packed matrices, on the
        CPU in float32: ``sliced`` [S, L_sl] (this shard's row of each
        stage, zero-padded to the longest) and ``repl`` [S, L_rp]."""
        out = {}
        for k, key in enumerate(("sliced", "repl")):
            rows = []
            for c in range(self.num_chunks):
                leaves = self._rows(c)[k]
                rows.append(torch.cat(
                    [to_ref_layout(p.detach()).float().reshape(-1).cpu()
                     for p in leaves]) if leaves else torch.zeros(0))
            L = max(max(r.numel() for r in rows), 1)
            out[key] = torch.stack([torch.nn.functional.pad(
                r, (0, L - r.numel())) for r in rows])
        return out

    def checkpoint_state(self) -> dict:
        """gpipe's packed rows of this shard's parameters and optimizer
        ``m``/``v`` (sliced and replicated leaves in the reference's
        order), the tp shards' rows stacked on a new first axis
        (parallel/state.py; collectives every rank calls)."""
        saved = super().checkpoint_state()
        saved["params"] = state.gather_stack(self.tp_comm, saved["params"])
        for k in state.OPT_TENSOR_KEYS:
            if k in saved["opt"]:
                saved["opt"][k] = state.gather_stack(self.tp_comm,
                                                     saved["opt"][k])
        return saved

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`: this shard's rows."""
        opt = dict(saved["opt"])
        for k in state.OPT_TENSOR_KEYS:
            if k in opt:
                opt[k] = state.own_part(opt[k], self.tp_comm)
        super().load_checkpoint_state(dict(
            saved, params=state.own_part(saved["params"], self.tp_comm),
            opt=opt))

    def _chunk_obj(self, c: int, *args, **kw):
        # the forward's sums, and the backward's through the autograd
        # nodes that keep the Comm they were built with
        with tensor_parallel(self.tp_comm):
            return super()._chunk_obj(c, *args, **kw)
