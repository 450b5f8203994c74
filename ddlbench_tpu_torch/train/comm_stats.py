"""Per-step communication volume (``ddlbench_tpu/train/comm_stats.py``),
for the strategies the port carries: ``single`` (none), ``dp`` and the
pipelines. ``sp``, ``ep`` and ``fsdp`` report zeros, as the reference's
accounting has no branch for them (their K/V and weight gathers,
reduce-scatters and all_to_alls are not counted).

The numbers are analytic, from the strategy's world, its wire dtype and
its model's float32 parameter bytes, as the reference computes them (its
counterpart of PipeDream's RuntimeStats):

* dp, replicated: a ring all-reduce of the gradients, ``2 (r-1)/r x``
  their wire bytes;
* dp with ``dp_shard_update``: the reduce-scatter of the gradients,
  ``(r-1)/r x`` their wire bytes, plus the all-gather of the float32
  params, ``(r-1)/r x`` their bytes. The ``physical_*`` twins price the
  padded flat vector the explicit engine ships; the explicit engines
  (sharded, bucketed or a narrowed wire) also report ``comm_buckets`` and
  ``wire_dtype``, and the int8 wire the all-reduced f32 scale of each
  bucket (``scale_bytes``);
* gpipe, the event schedules and pipedream (one replica per stage):
  every microbatch crosses every interior stage boundary twice (its
  activation forward, its gradient backward) in the compute dtype. The
  reference reckons the boundaries at the first S chunk bounds (at
  V > 1 as at V 1); gpipe's ``physical_boundary_bytes`` prices the
  reference's conveyor: the largest boundary activation of one
  microbatch (``_act_size``) over each of the S-1 links, forward and
  back, on each of the M*V + S - 1 ticks. The port's pipelines ship only
  the real boundaries; the figure is the reference's, kept for the line's
  parity;
* the hybrid pipelines (``dp_replicas`` R > 1): each replica's
  boundaries (x R), plus each step's ring all-reduce of every chunk's
  float32 gradient over the replicas (pipedream: once a microbatch,
  ``allreduce`` x M); under ZeRO-1 (``dp_shard_update`` on gpipe) that
  all-reduce splits into its reduce-scatter, ``(R-1)/R x`` the gradient
  bytes, and the next step's all-gather of the parameters, as much
  again, with ``physical_*`` twins over the padded rows the port ships
  (its own rows, one a chunk: common.row_flat_meta) and
  ``comm_buckets``;
* the hetero pipelines (uneven ``stage_replication``): the logical
  boundary bytes (each activation across its boundary once forward,
  once back: the replicas split the rows, so no factor), and each
  stage's ring all-reduce of its float32 gradient over its replicas
  once a step (pipedream: a microbatch). The reference's
  ``physical_*`` figures price its flat-axis conveyor and masked rings,
  kept for parity; the port moves only the rows a replica reads;
* tpp and 3-D tpp (``tp_size`` T, ``dp_replicas`` R >= 1): each
  replica's boundaries (x R), each stage's sliced rows' float32
  gradient all-reduced over the R replicas (T of them) and its
  replicated leaves' over R x T, and ``tp_psum_payload_bytes``, one
  row-parallel sum's payload (a microbatch's block output), with the
  rows' sizes (``tp_grad_sliced_row_bytes``, ``tp_grad_repl_row_bytes``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def _ring_allreduce_bytes(payload: float, r: int) -> float:
    return 2.0 * (r - 1) / r * payload if r > 1 else 0.0


def comm_stats(strategy) -> Dict[str, float]:
    """Analytic communication bytes per train step for a built strategy."""
    name = type(strategy).__name__
    out: Dict[str, float] = {
        "boundary_bytes": 0.0,
        "allreduce_bytes": 0.0,
        "reduce_scatter_bytes": 0.0,
        "all_gather_bytes": 0.0,
    }
    if name == "DPStrategy":
        r = strategy.world_size
        pbytes = float(sum(4 * p.numel()
                           for p in strategy.model.parameters()))
        wire = strategy.wire_dtype
        wire_itemsize = _ITEMSIZE[wire]
        grad_wire = pbytes / 4.0 * wire_itemsize
        meta = strategy._flat_meta
        if meta is not None:
            out["comm_buckets"] = float(meta.num_buckets)
            out["wire_dtype"] = wire
        if strategy.shard_update:
            out["reduce_scatter_bytes"] = (r - 1) / r * grad_wire
            out["all_gather_bytes"] = (r - 1) / r * pbytes
            out["physical_reduce_scatter_bytes"] = (
                (r - 1) / r * meta.padded * wire_itemsize)
            out["physical_all_gather_bytes"] = (r - 1) / r * meta.padded * 4.0
            if wire == "int8":
                out["scale_bytes"] = _ring_allreduce_bytes(
                    4.0 * meta.num_buckets, r)
        else:
            out["allreduce_bytes"] = _ring_allreduce_bytes(grad_wire, r)
            if meta is not None:
                out["physical_allreduce_bytes"] = _ring_allreduce_bytes(
                    float(meta.padded * wire_itemsize), r)
                if wire == "int8":
                    out["scale_bytes"] = _ring_allreduce_bytes(
                        4.0 * meta.num_buckets, r)
    elif name in ("GPipeStrategy", "ScheduledPipelineStrategy",
                  "PipeDreamStrategy"):
        itemsize = torch.empty((), dtype=strategy.compute_dtype
                               ).element_size()
        M, mb, dp = strategy.num_microbatches, strategy.mb, strategy.dp
        bounds, shapes = strategy.bounds, strategy.shapes
        S = strategy.num_stages
        boundary = 0.0
        for s in range(1, S):
            act = mb * math.prod(shapes[bounds[s]]) * itemsize
            boundary += 2.0 * M * act  # activation fwd + gradient bwd
        out["boundary_bytes"] = boundary * dp  # a replica's column each
        if name == "GPipeStrategy":
            V = strategy.num_chunks // S
            T = M * V + S - 1
            out["physical_boundary_bytes"] = (
                2.0 * T * (S - 1) * dp * strategy._act_size * itemsize)
        if dp > 1:
            p_lens = [sum(p.numel() for p in strategy.chunk_params(c))
                      for c in range(strategy.num_chunks)]
            grad_bytes = 4.0 * sum(p_lens)
            if strategy.pipe_shard:
                metas = strategy._row_meta
                padded = 4.0 * sum(m.padded for m in metas)
                out["reduce_scatter_bytes"] = (dp - 1) / dp * grad_bytes
                out["all_gather_bytes"] = (dp - 1) / dp * grad_bytes
                out["physical_reduce_scatter_bytes"] = (dp - 1) / dp * padded
                out["physical_all_gather_bytes"] = (dp - 1) / dp * padded
                out["comm_buckets"] = float(metas[0].num_buckets)
            else:
                syncs = M if name == "PipeDreamStrategy" else 1
                out["allreduce_bytes"] = _ring_allreduce_bytes(
                    grad_bytes, dp) * syncs
    elif name in ("HeteroGPipeStrategy", "HeteroPipeDreamStrategy"):
        itemsize = torch.empty((), dtype=strategy.compute_dtype
                               ).element_size()
        M, mb = strategy.num_microbatches, strategy.mb
        bounds, shapes = strategy.bounds, strategy.shapes
        S = strategy.num_stages
        out["boundary_bytes"] = sum(
            2.0 * M * mb * math.prod(shapes[bounds[s]]) * itemsize
            for s in range(1, S))
        per_sync = sum(_ring_allreduce_bytes(4.0 * strategy._p_lens[s], r)
                       for s, r in enumerate(strategy.repl))
        asynch = name == "HeteroPipeDreamStrategy"
        out["allreduce_bytes"] = per_sync * (M if asynch else 1)
        N, R = strategy.N, strategy._R
        buf = float(strategy._act_size) * itemsize
        ticks = 2 * M + 2 * S - 2 if asynch else M + S - 1
        n_ring = sum(r for r in strategy.repl if r > 1)
        out["physical_conveyor_bytes"] = 2.0 * ticks * R * (N - 1) * buf
        out["physical_allreduce_bytes"] = float(
            (max(strategy.repl) - 1) * (ticks if asynch else 1) * n_ring
        ) * 4.0 * max(strategy._p_lens)
    elif name == "TPGPipeStrategy":
        # the reference's logical accounting: each replica's boundaries as
        # gpipe's, each stage's sliced rows' gradient all-reduce over the
        # replicas (one a shard) and its replicated leaves' over replicas
        # x shards (the port sums the activations' gradients over the
        # shards instead: parallel/tpp.py; the same bytes); and the
        # payload of one row-parallel sum, one microbatch's block output
        itemsize = torch.empty((), dtype=strategy.compute_dtype
                               ).element_size()
        M, mb = strategy.num_microbatches, strategy.mb
        dp, tp = strategy.dp, strategy.tp
        bounds, shapes = strategy.bounds, strategy.shapes
        out["boundary_bytes"] = dp * sum(
            2.0 * M * mb * math.prod(shapes[bounds[s]]) * itemsize
            for s in range(1, strategy.num_stages))
        out["allreduce_bytes"] = sum(
            tp * _ring_allreduce_bytes(4.0 * sl, dp)
            + _ring_allreduce_bytes(4.0 * rp, dp * tp)
            for sl, rp in zip(strategy._sl_lens, strategy._rp_lens))
        out["tp_psum_payload_bytes"] = (float(mb) * math.prod(shapes[1])
                                        * itemsize)
        out["tp_grad_sliced_row_bytes"] = 4.0 * max(max(strategy._sl_lens),
                                                    1)
        out["tp_grad_repl_row_bytes"] = 4.0 * max(max(strategy._rp_lens), 1)
    elif name not in ("SingleStrategy", "SPStrategy", "EPStrategy",
                      "FSDPStrategy", "TPStrategy"):
        raise NotImplementedError(f"comm_stats of {name} is not ported")
    out["total_bytes"] = (out["boundary_bytes"] + out["allreduce_bytes"]
                          + out["reduce_scatter_bytes"]
                          + out["all_gather_bytes"])
    return out


def comm_line(cs: Dict[str, float]) -> str:
    """The training loop's ``comm volume/step`` line (the reference's)."""
    parts = [f"boundaries {cs['boundary_bytes'] / 1e6:.2f} MB",
             f"allreduce {cs['allreduce_bytes'] / 1e6:.2f} MB"]
    if cs.get("reduce_scatter_bytes") or cs.get("all_gather_bytes"):
        parts.append(f"reduce-scatter "
                     f"{cs['reduce_scatter_bytes'] / 1e6:.2f} MB")
        parts.append(f"all-gather {cs['all_gather_bytes'] / 1e6:.2f} MB")
    return (f"comm volume/step: {cs['total_bytes'] / 1e6:.2f} MB "
            f"({', '.join(parts)})")
