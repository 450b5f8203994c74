"""Synchronous micro-batch pipeline: GPipe's fill-drain
(``ddlbench_tpu/parallel/gpipe.py`` ``GPipeStrategy``).

The reference compiles the schedule into one SPMD program over a
``('data', 'stage')`` mesh: a ``lax.scan`` over ticks with a ``ppermute``
ring, whose meaning its tests pin as a sequential replay of
per-(chunk, microbatch) events. The port executes that replay: one
process walks the fill-drain timetable's events (partition/schedule.py),
chunk ``c = v*S + s`` lives on ``devices[s]``, and an activation crosses a
stage boundary with ``.to(devices[s+1])`` (a no-op when both stages share
a card) — torchgpipe's own model, one process over a list of devices. On
separate cards the host issues each event in the table's order and every
card runs its queue concurrently.

A train step:

* the global batch splits into M microbatches of ``mb`` contiguous rows
  (:meth:`shard_batch`);
* every chunk runs every microbatch in the timetable's forward order,
  BatchNorm's running statistics updating once per (chunk, microbatch);
* the objective is the mean over microbatches of each microbatch's loss
  (its mean over valid labels, label-smoothed as configured) plus
  ``moe_aux_weight`` x the MoE router losses summed over chunks, over M;
  the reported loss is the unsmoothed CE, averaged the same way;
* with ``remat_stages`` (the default, torchgpipe's checkpointing) the
  forward keeps only each (chunk, microbatch)'s input, and the backward
  walks the table in reverse, recomputing each chunk from its stashed
  input with BatchNorm's running statistics frozen
  (models/layers.py ``apply_chunk``), the cotangent seeded with 1/M as
  the reference's autodiff seeds it; without, autograd keeps every
  chunk's graph and one backward runs;
* one optimizer update per step (parallel/common.py ``flat_optimizer``:
  the reference's formulas, per chunk on its device).

Eval runs the same fill-drain forward in eval mode (the reference's
eval step): the loss is the mean of the microbatches' means.

Hybrid PP x DP (``dp_replicas`` R > 1: the reference's ``('data',
'stage')`` mesh): one process a replica (distributed.spawn; rank d's
stage s on ``cuda:(d*S + s)``, distributed.hybrid_stage_devices), each
walking its own pipeline, joined by the replica group ``dp_comm``:

* the global batch is [M*mb*R] rows; microbatch m of replica d is rows
  ``[m*R*mb + d*mb, m*R*mb + (d+1)*mb)``, the reference's reshape to
  [M, R*mb] with the second axis sharded (:meth:`shard_batch`);
* after the backward each chunk's gradient is summed over the replicas
  and divided by R (the event schedules divide the sum by R, then by
  M); the loss is averaged over the replicas, ``correct`` and the valid
  count summed, and BatchNorm's running statistics averaged over them
  at the step's end (the reference's sync of the state rows);
* with ``dp_shard_update`` (hybrid PP x ZeRO-1, gpipe and the event
  schedules) each chunk's parameters, packed in the reference's leaf
  order and layout into one row (common.row_flat_meta: ``comm_buckets``
  stretches, padded), and their optimizer state stay device-major and
  1/R a rank between steps: each bucket is all-gathered into the
  chunk's parameters before its first forward of a step, each bucket of
  the summed gradient row is reduce-scattered after the backward, the
  shard divided by R then M, and one sharded update runs
  (:meth:`_shard_update`). The parameters the model holds are stale
  between an update and the next gather; :meth:`sync_params` gathers
  them (eval and :meth:`materialize_params` call it).
:class:`ScheduledPipelineStrategy` (parallel/pipeline_rt.py) and
:class:`PipeDreamStrategy` (parallel/pipedream.py) subclass this one for
their train steps.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.models.layers import (BatchNorm, LayerModel,
                                              apply_chunk)
from ddlbench_tpu_torch.models.moe import MoEBlock
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.common import (
    cast_input, correct_and_count, correct_topk, cross_entropy_loss,
    flat_optimizer, from_ref_layout, fused_chunk_eval_sums,
    fused_chunk_loss_sums, head_fusable, ref_param_order, row_flat_meta,
    to_ref_layout)
from ddlbench_tpu_torch.parallel.packing import (balanced_stage_bounds,
                                                 layer_flop_costs,
                                                 model_shapes)
from ddlbench_tpu_torch.partition.schedule import fill_drain_timetable


def chunk_aux(layers: Sequence[torch.nn.Module]) -> Optional[torch.Tensor]:
    """Sum, in layer order, of the router losses the chunk's MoE blocks
    recorded on its last forward; None for a dense chunk."""
    aux = [m.last_route.aux for layer in layers for m in layer.modules()
           if isinstance(m, MoEBlock)]
    return sum(aux) if aux else None


def bn_layers(layers: Sequence[torch.nn.Module]) -> List[BatchNorm]:
    """The BatchNorm modules of ``layers``, in order."""
    return [m for layer in layers for m in layer.modules()
            if isinstance(m, BatchNorm)]


def sum_over(comm: Optional[Comm], tensors: Sequence[torch.Tensor],
             div: int = 1) -> None:
    """In place: each of ``tensors`` (one device, one type) summed over
    ``comm``'s ranks in one all-reduce of their concatenation, then
    divided by ``div`` (a no-op without a group)."""
    if comm is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comm.all_reduce(flat)
    if div != 1:
        flat /= div
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def mean_over(comm: Comm, tensors: Sequence[torch.Tensor]) -> None:
    """In place: ``tensors`` averaged over ``comm``'s ranks (the sum, then
    / world)."""
    sum_over(comm, tensors, comm.world)


class GPipeStrategy:
    """strategy='gpipe': fill-drain over S stages (V chunks each) on
    ``devices`` (one per stage; distributed.stage_devices). The model's
    chunk layers are moved to their devices here. With ``dp_replicas`` R
    > 1 this is replica ``dp_comm.rank`` of R (module docstring)."""

    def __init__(self, model: LayerModel, cfg: RunConfig,
                 devices: Sequence[torch.device],
                 stage_bounds: Optional[Sequence[int]] = None,
                 dp_comm: Optional[Comm] = None):
        self.model = model
        self.cfg = cfg
        self.dp = max(1, cfg.dp_replicas)
        if (dp_comm.world if dp_comm is not None else 1) != self.dp:
            raise ValueError(
                f"dp_replicas={self.dp} needs a replica group of {self.dp} "
                "ranks (distributed.spawn)")
        self.dp_comm = dp_comm
        if dp_comm is not None:
            self.comm = dp_comm  # rank 0 prints (train/loop.py)
        self.pipe_shard = cfg.pipe_shard_engine()
        self.num_stages = S = cfg.resolved_stages()
        self.vstages = V = max(1, cfg.virtual_stages)
        self.num_chunks = C = S * V
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != S:
            raise ValueError(f"{S} stages need {S} devices, got "
                             f"{len(self.devices)}")
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.mb, self.num_microbatches = cfg.resolved_batches()
        self.smoothing = cfg.resolved_label_smoothing()
        self.aux_weight = cfg.moe_aux_weight
        self.shapes = model_shapes(model)
        if stage_bounds is None:
            bounds = balanced_stage_bounds(
                layer_flop_costs(model, self.shapes), C)
        else:
            bounds = [int(b) for b in stage_bounds]
        assert (len(bounds) == C + 1 and bounds[0] == 0
                and bounds[-1] == len(model.layers)), bounds
        self.bounds = bounds
        # the largest activation crossing a chunk boundary, one microbatch
        interior = [self.mb * math.prod(self.shapes[bounds[c]])
                    for c in range(1, C)]
        self._act_size = max(interior) if interior else 1
        self.fused = cfg.fused_head_loss and head_fusable(model)
        for c in range(C):
            for layer in self.chunk_layers(c):
                layer.to(self.chunk_device(c))
        # the train step's table (the event schedules replace it); eval
        # always walks fill-drain's forward
        self.timetable = self._fill_drain = fill_drain_timetable(
            S, self.num_microbatches, V)
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        self.opt: Optional[List[dict]] = None
        # ZeRO-1: each chunk's parameters in the reference's leaf order
        # (its row), the rows' metas, this rank's shards
        self._ref_params: List[List[torch.nn.Parameter]] = []
        self._row_meta = []
        if self.pipe_shard:
            self._ref_params = [ref_param_order(LayerModel(
                "chunk", list(self.chunk_layers(c)), (1,), 1))[0]
                for c in range(C)]
            self._row_meta = [row_flat_meta(
                sum(p.numel() for p in ps), self.dp,
                max(1, cfg.comm_buckets)) for ps in self._ref_params]
        self._shards: Optional[List[torch.Tensor]] = None
        self._stale = [False] * C
        if dp_comm is not None and self.dp > 1:
            # one set of starting weights and statistics: rank 0's
            for c in range(C):
                for t in (self.chunk_params(c) + [
                        b for layer in self.chunk_layers(c)
                        for b in layer.buffers()]):
                    with torch.no_grad():
                        dp_comm.broadcast(t.data)

    # -- layout --------------------------------------------------------------

    def chunk_layers(self, c: int) -> Sequence[torch.nn.Module]:
        return self.model.layers[self.bounds[c]:self.bounds[c + 1]]

    def chunk_device(self, c: int) -> torch.device:
        return self.devices[c % self.num_stages]

    def chunk_params(self, c: int) -> List[torch.nn.Parameter]:
        return [p for layer in self.chunk_layers(c)
                for p in layer.parameters()]

    @property
    def world_size(self) -> int:
        return len(self.devices) * self.dp

    def init(self) -> None:
        """Fresh optimizer state, one per chunk, for the current
        parameters (ZeRO-1: this rank's shard of each chunk's row, cut
        from the parameters, and its state)."""
        if not self.pipe_shard:
            self.opt = [self._opt_init([p.detach() for p in
                                        self.chunk_params(c)])
                        for c in range(self.num_chunks)]
            return
        self._shards = [self._own_shard(c, self._pack_row(
            c, [p.detach() for p in self._ref_params[c]]))
            for c in range(self.num_chunks)]
        self._stale = [False] * self.num_chunks
        self.opt = [self._opt_init([sh]) for sh in self._shards]

    # -- hybrid PP x ZeRO-1 --------------------------------------------------

    def _rank(self) -> int:
        return self.dp_comm.rank if self.dp_comm is not None else 0

    def _pack_row(self, c: int, leaves: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
        """Chunk c's leaves (the reference's order) raveled in its layout
        into one padded row (float32, float64 for a float64 model)."""
        meta = self._row_meta[c]
        dev = self.chunk_device(c)
        dtype = torch.promote_types(leaves[0].dtype, torch.float32) \
            if leaves else torch.float32
        row = torch.zeros(meta.padded, dtype=dtype, device=dev)
        off = 0
        for t in leaves:
            n = t.numel()
            row[off:off + n] = to_ref_layout(t).reshape(-1).to(dtype)
            off += n
        return row

    def _own_shard(self, c: int, row: torch.Tensor) -> torch.Tensor:
        """This rank's device-major shard of a plain padded row: its 1/R
        slice of each bucket, concatenated."""
        meta, r = self._row_meta[c], self._rank()
        parts = []
        for o, bp in zip(meta.bucket_offsets, meta.bucket_padded):
            bl = bp // self.dp
            parts.append(row[o + r * bl:o + (r + 1) * bl])
        return torch.cat(parts).clone()

    def _gather(self, c: int) -> None:
        """ZeRO-1: chunk c's buckets all-gathered from the ranks' shards
        into its parameters (a no-op when they are current)."""
        if not self._stale[c]:
            return
        meta, shard = self._row_meta[c], self._shards[c]
        parts = []
        for o, bp in zip(meta.bucket_offsets, meta.bucket_padded):
            piece = shard[o // self.dp:(o + bp) // self.dp]
            parts.append(piece if self.dp_comm is None
                         else self.dp_comm.all_gather(piece))
        row = torch.cat(parts)
        off = 0
        with torch.no_grad():
            for p in self._ref_params[c]:
                n = p.numel()
                ref_shape = to_ref_layout(p).shape
                p.copy_(from_ref_layout(row[off:off + n].view(ref_shape)))
                off += n
        self._stale[c] = False

    def sync_params(self) -> None:
        """The model's parameters current: every stale chunk gathered
        (ZeRO-1; a no-op otherwise)."""
        if self.pipe_shard:
            for c in range(self.num_chunks):
                self._gather(c)

    def _shard_update(self, c: int, grads: Sequence[torch.Tensor],
                      lr: float, div: int) -> None:
        """ZeRO-1: chunk c's summed gradient (chunk_params order) packed
        into its row, each bucket reduce-scattered over the replicas, the
        shard divided by R then ``div``, and the sharded update."""
        params = self.chunk_params(c)
        if not params:
            return
        by_id = {id(p): g for p, g in zip(params, grads)}
        row = self._pack_row(c, [by_id[id(p)] for p in self._ref_params[c]])
        meta = self._row_meta[c]
        parts = []
        for o, bp in zip(meta.bucket_offsets, meta.bucket_padded):
            piece = row[o:o + bp]
            parts.append(piece if self.dp_comm is None
                         else self.dp_comm.reduce_scatter(piece))
        g = torch.cat(parts) / self.dp
        if div != 1:
            g = g / div
        with torch.no_grad():
            self._opt_update([self._shards[c]], [g], self.opt[c], lr)
        self._stale[c] = True

    def opt_state_bytes(self) -> int:
        """This rank's optimizer-state bytes (every tensor of every
        chunk's state)."""
        return sum(t.numel() * t.element_size() for st in self.opt
                   for v in st.values() if isinstance(v, list) for t in v)

    # -- the replicas' reductions ------------------------------------------

    def _finish_step(self, grads: Sequence[Sequence[torch.Tensor]],
                     lr: float, div: int = 1) -> None:
        """The step's end: each chunk's summed gradient reduced over the
        replicas (the sum / R, or ZeRO-1's reduce-scatter), divided by
        ``div`` and applied; BatchNorm's running statistics averaged
        over the replicas."""
        for c in range(self.num_chunks):
            g = list(grads[c])
            if self.pipe_shard:
                self._shard_update(c, g, lr, div)
                continue
            if self.dp > 1:
                mean_over(self.dp_comm, g)
            if div != 1:
                g = [t / div for t in g]
            self._update(c, g, lr)
        self._sync_stats()

    def _sync_stats(self) -> None:
        """BatchNorm's running statistics averaged over the replicas."""
        if self.dp_comm is None or self.dp == 1:
            return
        for c in range(self.num_chunks):
            bns = bn_layers(self.chunk_layers(c))
            mean_over(self.dp_comm, [t for bn in bns
                                     for t in (bn.mean, bn.var)])

    def _replica_metrics(self, loss: torch.Tensor, correct: torch.Tensor,
                         valid: torch.Tensor, correct5=None):
        """(the loss averaged over the replicas, correct, valid[,
        correct5] summed over them)."""
        if self.dp_comm is None or self.dp == 1:
            return loss, correct, valid, correct5
        loss = self.dp_comm.all_reduce(loss.reshape(1).clone())[0] / self.dp
        ints = [correct, valid] + ([] if correct5 is None else [correct5])
        ints = self.dp_comm.all_reduce(torch.stack(
            [t.to(torch.int64) for t in ints]))
        return (loss, ints[0], ints[1],
                None if correct5 is None else ints[2])

    def materialize_params(self) -> torch.Tensor:
        """The reference's packed stage-parameter matrix, on the CPU in
        float32: row c holds chunk c's parameters raveled in the
        reference's leaf order and layout (parallel/common.py
        ``ref_param_order``), zero-padded to the longest row; [S, L] at
        V 1, [V, S, L] (row [v, s] = chunk v*S + s) above."""
        self.sync_params()
        rows = []
        for c in range(self.num_chunks):
            sub = LayerModel("chunk", list(self.chunk_layers(c)), (1,), 1)
            params, _ = ref_param_order(sub)
            rows.append(torch.cat(
                [to_ref_layout(p.detach()).float().reshape(-1).cpu()
                 for p in params]) if params else torch.zeros(0))
        L = max(max(r.numel() for r in rows), 1)
        mat = torch.stack([torch.nn.functional.pad(r, (0, L - r.numel()))
                           for r in rows])
        if self.vstages > 1:
            mat = mat.reshape(self.vstages, self.num_stages, L)
        return mat

    # -- checkpoints (parallel/state.py) ------------------------------------

    def ref_row_meta(self):
        """ZeRO-1's row layout as the reference holds it: one
        ``row_flat_meta`` of the longest chunk row over the replicas (the
        port keeps one per chunk, of the chunk's own length)."""
        return row_flat_meta(max(m.length for m in self._row_meta), self.dp,
                             max(1, self.cfg.comm_buckets))

    def _chunk_order(self, c: int):
        """(chunk c's parameters in the reference's leaf order, the index
        of each in ``chunk_params(c)``, which the optimizer state
        follows)."""
        params = state.ref_params(self.chunk_layers(c))
        return params, state.order_of(params, self.chunk_params(c))

    def _stage_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[C, ...] -> [V, S, ...] when interleaved (row [v, s] = chunk
        v*S + s), as the reference's stage matrices."""
        if self.vstages == 1:
            return t
        return t.reshape(self.vstages, self.num_stages, *t.shape[1:])

    def _ref_row(self, c: int, dm: torch.Tensor, to_ref: bool):
        """A device-major ZeRO-1 row of chunk c between the port's layout
        (its own row meta) and the reference's (:meth:`ref_row_meta`)."""
        from ddlbench_tpu_torch.train.reshard import relayout_row

        mine, ref = self._row_meta[c], self.ref_row_meta()
        src, dst = (mine, ref) if to_ref else (ref, mine)
        return torch.from_numpy(relayout_row(dm.numpy(), src, dst, self.dp))

    def checkpoint_state(self) -> dict:
        """The reference's pipeline train state (parallel/state.py): the
        packed stage rows of the parameters, the BatchNorm statistics and
        the optimizer's ``m``/``v``, and one ``step`` a row; under
        hybrid ZeRO-1 the rows gathered from the replicas' shards,
        device-major in the reference's row layout."""
        C = self.num_chunks
        opt: dict = {}
        if self.pipe_shard:
            def rows(get):
                return torch.stack([self._ref_row(c, state.gather_stack(
                    self.dp_comm, get(c)), True) for c in range(C)])

            params = rows(lambda c: self._shards[c])
            for k in state.OPT_TENSOR_KEYS:
                if k in self.opt[0]:
                    opt[k] = rows(lambda c: self.opt[c][k][0])
        else:
            orders = [self._chunk_order(c) for c in range(C)]
            params = state.pack_rows([p for p, _ in orders])
            for k in state.OPT_TENSOR_KEYS:
                if k in self.opt[0]:
                    opt[k] = state.pack_rows([
                        [self.opt[c][k][i] for i in order]
                        for c, (_, order) in enumerate(orders)])
        if "step" in self.opt[0]:
            opt["step"] = torch.tensor([[st["step"]] for st in self.opt],
                                       dtype=torch.int32)
        return {"params": self._stage_rows(params),
                "model_state": self._stage_rows(state.pack_rows(
                    [state.ref_buffers(self.chunk_layers(c))
                     for c in range(C)])),
                "opt": {k: self._stage_rows(v) for k, v in opt.items()}}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`, in place (ZeRO-1: each
        replica takes its shard of every row)."""
        C = self.num_chunks

        def rows(t):  # [V, S, L] -> [C, L]
            return t.reshape(C, t.shape[-1])

        state.unpack_rows([state.ref_buffers(self.chunk_layers(c))
                           for c in range(C)], rows(saved["model_state"]))
        sopt = saved["opt"]
        if self.pipe_shard:
            def load(get, mat):
                mat = rows(mat)
                for c in range(C):
                    state.put(get(c), state.own_part(
                        self._ref_row(c, mat[c], False), self.dp_comm))

            load(lambda c: self._shards[c], saved["params"])
            for k in state.OPT_TENSOR_KEYS:
                if k in self.opt[0]:
                    load(lambda c: self.opt[c][k][0], sopt[k])
            self._stale = [True] * C
            self.sync_params()
        else:
            orders = [self._chunk_order(c) for c in range(C)]
            state.unpack_rows([p for p, _ in orders], rows(saved["params"]))
            for k in state.OPT_TENSOR_KEYS:
                if k in self.opt[0]:
                    state.unpack_rows([[self.opt[c][k][i] for i in order]
                                       for c, (_, order) in
                                       enumerate(orders)], rows(sopt[k]))
        if "step" in self.opt[0]:
            steps = sopt["step"].reshape(C)
            for st, n in zip(self.opt, steps.tolist()):
                st["step"] = int(n)

    def shard_batch(self, x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Global batch [M*mb*R, ...] -> this replica's M microbatches of
        mb rows: microbatch m is rows [m*R*mb + d*mb, m*R*mb + (d+1)*mb)
        for replica d (the reference's [M, R*mb] layout, its second axis
        sharded; contiguous blocks of mb at R 1); inputs on chunk 0's
        device, labels on the last chunk's."""
        M, mb, R = self.num_microbatches, self.mb, self.dp
        if x.shape[0] != M * mb * R:
            raise ValueError(f"batch of {x.shape[0]} rows; the pipeline "
                             f"takes {M} microbatches of {mb}"
                             + (f" on each of {R} replicas" if R > 1
                                else ""))
        last = self.chunk_device(self.num_chunks - 1)
        d = self._rank()
        xs = [t[d * mb:(d + 1) * mb]
              for t in x.to(self.chunk_device(0)).split(R * mb)]
        ys = [t[d * mb:(d + 1) * mb] for t in y.to(last).split(R * mb)]
        return xs, ys

    # -- one chunk -----------------------------------------------------------

    def _send(self, t: torch.Tensor, c: int) -> torch.Tensor:
        """An activation or cotangent to chunk c's device, in the compute
        dtype (the reference's boundary buffers)."""
        if t.is_floating_point():
            t = t.to(self.compute_dtype)
        return t.to(self.chunk_device(c))

    def _chunk_obj(self, c: int, x: torch.Tensor,
                   labels: Optional[torch.Tensor],
                   params: Optional[Sequence[dict]] = None,
                   update_stats: bool = True, train: bool = True
                   ) -> Dict[str, Optional[torch.Tensor]]:
        """Chunk c on x (cast to the compute dtype). Returns ``y`` (the
        output, None on the last chunk), ``aux`` (the chunk's MoE router
        losses, None for a dense chunk) and on the last chunk ``obj``
        (this microbatch's training objective: the label-smoothed mean CE
        over valid labels plus moe_aux_weight x aux), ``ce`` (the
        unsmoothed mean CE) and ``correct``; in eval mode also
        ``correct5`` (``train=False``: the objective is the CE)."""
        layers = self.chunk_layers(c)
        x = cast_input(x, self.compute_dtype)
        out: Dict[str, Optional[torch.Tensor]] = {"y": None}
        if c < self.num_chunks - 1:
            out["y"] = apply_chunk(layers, x, self.compute_dtype, params,
                                   update_stats)
            out["aux"] = chunk_aux(layers)
            return out
        if self.fused and train:
            obj_sum, ce_sum, correct, valid = fused_chunk_loss_sums(
                layers, x, labels, self.compute_dtype, self.smoothing,
                params, update_stats)
            denom = valid.clamp(min=1).float()
            obj, ce = obj_sum / denom, ce_sum / denom
        elif self.fused:
            ce_sum, correct, correct5, valid = fused_chunk_eval_sums(
                layers, x, labels, self.compute_dtype)
            obj = ce = ce_sum / valid.clamp(min=1).float()
            out["correct5"] = correct5
        else:
            logits = apply_chunk(layers, x, self.compute_dtype, params,
                                 update_stats)
            ce = cross_entropy_loss(logits, labels)
            obj = (cross_entropy_loss(logits, labels, self.smoothing)
                   if train and self.smoothing else ce)
            correct = correct_and_count(logits, labels)[0]
            if not train:
                out["correct5"] = correct_topk(logits, labels)
        aux = chunk_aux(layers)
        if train and aux is not None:
            obj = obj + self.aux_weight * aux
        out.update(aux=aux, obj=obj, ce=ce, correct=correct)
        return out

    def _aux_part(self, out) -> Optional[torch.Tensor]:
        return (None if out["aux"] is None
                else self.aux_weight * out["aux"])

    def _forward_order(self) -> List[Tuple[int, int]]:
        """(chunk, microbatch) of every forward event, in the fill-drain
        table's tick order."""
        tv, tm, valid = self._fill_drain.forward_tick_arrays()
        S = self.num_stages
        return [(int(tv[t, s]) * S + s, int(tm[t, s]))
                for t in range(tv.shape[0]) for s in range(S)
                if valid[t, s]]

    # -- the step ------------------------------------------------------------

    def _grads(self, c: int) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.chunk_params(c)]

    def _update(self, c: int, grads: Sequence[torch.Tensor],
                lr: float) -> None:
        """Chunk c's optimizer update with ``grads`` (float32)."""
        params = self.chunk_params(c)
        if not params:
            return
        with torch.no_grad():
            self._opt_update([p.detach() for p in params], list(grads),
                             self.opt[c], lr)

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One fill-drain step on the global batch (x, y) at ``lr``;
        returns {"loss": the unsmoothed CE, "accuracy": top-1 over valid
        labels}."""
        metrics = self._forward_backward(x, y)
        self._finish_step([self._grads(c) for c in range(self.num_chunks)],
                          lr)
        return metrics

    def reduced_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The step's forward and backward on the global batch (x, y),
        without the update: (metrics, {"<layer>.<name>": gradient}), the
        gradient this rank's (its replica's share at R > 1: the sum over
        the replicas / R is the step's)."""
        metrics = self._forward_backward(x, y)
        grads = {}
        for c in range(self.num_chunks):
            for i in range(self.bounds[c], self.bounds[c + 1]):
                for n, p in self.model.layers[i].named_parameters():
                    grads[f"{i}.{n}"] = (torch.zeros_like(p) if p.grad is None
                                         else p.grad)
        return metrics, grads

    def _forward_backward(self, x: torch.Tensor, y: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
        """The fill-drain forward and backward, the parameters' gradients
        left in ``.grad``."""
        xs, ys = self.shard_batch(x, y)
        self.model.train()
        M, C = self.num_microbatches, self.num_chunks
        for c in range(C):
            for p in self.chunk_params(c):
                p.grad = None
        remat = self.cfg.remat_stages
        order = self._forward_order()
        acts: Dict[Tuple[int, int], torch.Tensor] = {}
        stash: Dict[Tuple[int, int], torch.Tensor] = {}
        parts: List[torch.Tensor] = []
        ce_acc = correct = None
        with torch.no_grad() if remat else contextlib.nullcontext():
            for c, m in order:
                self._gather(c)
                xin = xs[m] if c == 0 else acts.pop((c - 1, m))
                if remat:
                    stash[(c, m)] = xin
                out = self._chunk_obj(c, xin, ys[m] if c == C - 1 else None)
                if c < C - 1:
                    acts[(c, m)] = self._send(out["y"], c + 1)
                    aux = self._aux_part(out)
                    if aux is not None:
                        parts.append(aux)
                else:
                    parts.append(out["obj"])
                    ce_acc = (out["ce"] if ce_acc is None
                              else ce_acc + out["ce"])
                    correct = (out["correct"] if correct is None
                               else correct + out["correct"])
        if remat:
            self._remat_backward(order, stash, ys)
        else:
            last = self.chunk_device(C - 1)
            torch.stack([p.to(last) for p in parts]).sum().div(M).backward()
        valid = sum((t >= 0).sum() for t in ys)
        loss, correct, valid, _ = self._replica_metrics(
            ce_acc.detach() / M, correct, valid)
        return {"loss": loss,
                "accuracy": correct.float() / valid.clamp(min=1).float()}

    def _remat_backward(self, order, stash, ys) -> None:
        """The fill-drain backward: the forward events in reverse, each
        chunk recomputed from its stashed input (running statistics
        frozen), seeded with the downstream cotangent and 1/M for its
        objective part; parameter gradients accumulate in ``.grad``."""
        M, C = self.num_microbatches, self.num_chunks
        seed = 1.0 / M
        cots: Dict[Tuple[int, int], torch.Tensor] = {}
        for c, m in reversed(order):
            xin = stash.pop((c, m))
            needs_x = c > 0
            if needs_x:
                xin = xin.detach().requires_grad_(True)
            with torch.enable_grad():
                out = self._chunk_obj(c, xin, ys[m] if c == C - 1 else None,
                                      update_stats=False)
                if c == C - 1:
                    tensors, grads = [out["obj"]], [torch.full_like(
                        out["obj"], seed)]
                else:
                    tensors, grads = [out["y"]], [cots.pop((c, m))]
                    aux = self._aux_part(out)
                    if aux is not None:
                        tensors.append(aux)
                        grads.append(torch.full_like(aux, seed))
                keep = [i for i, t in enumerate(tensors) if t.requires_grad]
                if keep:  # none: a first chunk without parameters
                    torch.autograd.backward([tensors[i] for i in keep],
                                            [grads[i] for i in keep])
            if needs_x:
                g = (torch.zeros_like(xin) if xin.grad is None
                     else xin.grad)
                cots[(c - 1, m)] = self._send(g, c - 1)

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The fill-drain forward in eval mode: {loss (the mean of the
        microbatches' mean CEs), correct, correct5, count}."""
        xs, ys = self.shard_batch(x, y)
        self.sync_params()
        self.model.eval()
        M, C = self.num_microbatches, self.num_chunks
        acts: Dict[Tuple[int, int], torch.Tensor] = {}
        loss = correct = correct5 = None
        with torch.no_grad():
            for c, m in self._forward_order():
                xin = xs[m] if c == 0 else acts.pop((c - 1, m))
                out = self._chunk_obj(c, xin, ys[m] if c == C - 1 else None,
                                      train=False)
                if c < C - 1:
                    acts[(c, m)] = self._send(out["y"], c + 1)
                    continue
                loss = out["ce"] if loss is None else loss + out["ce"]
                correct = (out["correct"] if correct is None
                           else correct + out["correct"])
                correct5 = (out["correct5"] if correct5 is None
                            else correct5 + out["correct5"])
        count = sum((t >= 0).sum() for t in ys)
        loss, correct, count, correct5 = self._replica_metrics(
            loss / M, correct, count, correct5)
        return {"loss": loss, "correct": correct, "correct5": correct5,
                "count": count}
