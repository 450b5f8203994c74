"""Per-step communication volume (``ddlbench_tpu/train/comm_stats.py``),
for the strategies the port carries: ``single`` (none) and ``dp``.

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
  bucket (``scale_bytes``).

The other strategies' branches wait for the pipelines (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Dict

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
    elif name != "SingleStrategy":
        raise NotImplementedError(
            f"comm_stats of {name} is not ported (ROADMAP A.7)")
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
