"""Topology-portable checkpoints: the world-size check and the reshard
(``ddlbench_tpu/train/reshard.py``).

Every checkpoint carries logical metadata (:func:`logical_meta`, written
as ``logical.json`` inside the commit and covered by its manifest): the
leaves' shapes and dtypes, the flat bucket layout, and the world, dp and
stage shape it was saved under. At resume :func:`compare` holds it to the
live strategy's. Without ``elastic_resume`` a mismatch raises the named
:class:`CheckpointShapeError` (both shapes in the message, a warn-once
pointer at ``--elastic-resume``); with it, :func:`elastic_restore` reads
the checkpoint at its saved shapes and converts its flat state to the
current world.

The conversion is a permutation, never a reduction: the ZeRO-1 layout
keeps every logical element's value independent of the world size (world
padding only moves zeros between buckets; the device-major layout is an
index permutation, parallel/common.py ``device_major_perm``), so a float32
round trip save@N -> reshard -> M is bitwise: strip each bucket's pad,
re-pad for the new world, re-permute. Covered layouts, as the
reference's:

* ``dp_shard``: dp's ZeRO-1 flat optimizer state (``dp_shard_update``,
  SGD momentum and Adam m/v, any ``comm_buckets`` on either side) and the
  overlapped engine's flat device-major parameters;
* ``pipe_shard``: hybrid PP x ZeRO-1's stage rows (parameters and
  optimizer state sharded over the replicas) for a changed replica count
  at the same stage split. A changed stage count is a re-planning
  problem (``--plan auto`` pins it: partition/planner.py), so it raises.

The (epoch, step)-addressed data and the per-step streams need nothing
new, provided the global batch is kept across the reshape (the loop warns
otherwise); a bitwise trajectory across worlds also needs dp's
``elastic_slices`` reduction order, and the loop pins the learning rate's
world scaling to the launch world recorded here.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ddlbench_tpu_torch.parallel.common import (bucket_content_lengths,
                                                device_major_perm,
                                                row_flat_meta)
from ddlbench_tpu_torch.parallel.state import leaf_meta

LOGICAL_SCHEMA = 1

_warned_flag = False  # warn-once pointer at --elastic-resume


class CheckpointShapeError(RuntimeError):
    """A checkpoint's recorded world shape mismatches the current one and
    the elastic reshard is not enabled (or cannot cover the change)."""


def logical_meta(strategy, cfg, saved_tree, lr_world: int
                 ) -> Dict[str, Any]:
    """World-agnostic description of the layout of ``saved_tree`` (the
    strategy's ``checkpoint_state``), written beside every checkpoint.
    ``lr_world`` is the world the run's lr scaling was computed with (the
    launch world, carried through elastic resumes)."""
    meta: Dict[str, Any] = {
        "schema": LOGICAL_SCHEMA,
        "strategy": cfg.strategy,
        "world": int(getattr(strategy, "world_size", cfg.num_devices)),
        "global_batch": int(cfg.global_batch()),
        "lr_world": int(lr_world),
        "elastic_slices": cfg.elastic_slices,
        "kind": "replicated",
        "leaves": leaf_meta(saved_tree),
    }
    if getattr(strategy, "pipe_shard", False):
        rm = strategy.ref_row_meta()
        meta.update(
            kind="pipe_shard", dp=int(strategy.dp),
            stages=int(strategy.num_stages), vstages=int(strategy.vstages),
            buckets=int(max(1, cfg.comm_buckets)),
            length=int(rm.length), padded=int(rm.padded),
            bucket_padded=[int(b) for b in rm.bucket_padded])
    elif getattr(strategy, "shard_update", False) and \
            getattr(strategy, "_flat_meta", None) is not None:
        fm = strategy._flat_meta
        meta.update(
            kind="dp_shard", buckets=int(max(1, cfg.comm_buckets)),
            overlap=bool(getattr(strategy, "overlap", False)),
            length=int(fm.length), padded=int(fm.padded),
            bucket_padded=[int(b) for b in fm.bucket_padded])
    return meta


def compare(saved: Optional[Dict[str, Any]], cur: Dict[str, Any],
            elastic: bool) -> Optional[str]:
    """None = the shapes agree (plain restore); "reshard" = a world-size
    mismatch the permutation covers. Raises :class:`CheckpointShapeError`
    where the mismatch is not covered, or is but ``elastic`` is False
    (with a warn-once pointer at --elastic-resume)."""
    global _warned_flag
    if saved is None:
        # no recorded shape to compare: restore as before (a genuine
        # mismatch still fails at the load's payload check)
        return None
    schema = saved.get("schema")
    if schema != LOGICAL_SCHEMA:
        raise CheckpointShapeError(
            f"checkpoint logical metadata has schema {schema!r}; this "
            f"build understands schema {LOGICAL_SCHEMA} — resume with a "
            f"build at least as new as the one that wrote the checkpoint")
    if saved.get("strategy") != cur["strategy"]:
        raise CheckpointShapeError(
            f"checkpoint was saved by the {saved.get('strategy')!r} strategy "
            f"but this run uses {cur['strategy']!r}; resharding converts "
            f"world sizes, not engines")
    if saved.get("kind") != cur["kind"]:
        raise CheckpointShapeError(
            f"checkpoint engine layout {saved.get('kind')!r} != current "
            f"{cur['kind']!r} (e.g. --dp-shard-update toggled between save "
            f"and resume); rerun with the saving run's engine flags")
    kind = cur["kind"]
    if kind == "pipe_shard" and (saved["stages"] != cur["stages"]
                                 or saved["vstages"] != cur["vstages"]):
        raise CheckpointShapeError(
            f"checkpoint stage split S={saved['stages']} V={saved['vstages']}"
            f" != current S={cur['stages']} V={cur['vstages']}: a changed "
            f"stage count is a re-planning problem, not a permutation — "
            f"with --plan auto the resume re-plans automatically (the "
            f"planner pins the stage count to the checkpoint's and "
            f"re-solves dp for the new world, partition/planner.py); "
            f"otherwise re-plan via --auto-partition at the new topology "
            f"and restart (elastic resume covers the 'data'-axis world "
            f"only)")
    if kind != "replicated" and saved.get("length") != cur.get("length"):
        raise CheckpointShapeError(
            f"checkpoint packed length {saved.get('length')} != current "
            f"{cur.get('length')}: the MODEL differs, not just the world")
    same = (saved.get("world") == cur["world"]
            and saved.get("padded") == cur.get("padded")
            and saved.get("bucket_padded") == cur.get("bucket_padded")
            and saved.get("dp", saved.get("world")) ==
            cur.get("dp", cur["world"])
            and bool(saved.get("overlap")) == bool(cur.get("overlap")))
    if same:
        return None
    if kind == "replicated":
        if saved.get("leaves") == cur.get("leaves"):
            print(f"elastic resume: world changed {saved.get('world')} -> "
                  f"{cur['world']} (state shapes world-agnostic; no "
                  f"reshard needed)", flush=True)
            return None
        raise CheckpointShapeError(
            f"checkpoint state shapes (saved at world {saved.get('world')})"
            f" differ from the live strategy's (world {cur['world']}) and "
            f"the {cur['strategy']!r} engine's layout has no reshard path "
            f"— elastic resume covers the dp ZeRO-1 and pipe-mesh hybrid "
            f"flat layouts; restart at the saved topology (or re-plan)")
    shapes = (f"saved world {saved.get('world')} "
              f"(dp {saved.get('dp', saved.get('world'))}, "
              f"buckets {saved.get('buckets')}, padded {saved.get('padded')})"
              f" vs current world {cur['world']} "
              f"(dp {cur.get('dp', cur['world'])}, buckets "
              f"{cur.get('buckets')}, padded {cur.get('padded')})")
    if not elastic:
        if not _warned_flag:
            print("WARNING: checkpoint world shape mismatches the current "
                  "mesh; pass --elastic-resume to reshard the ZeRO-1 flat "
                  "state through the topology-portable permutation path",
                  file=sys.stderr, flush=True)
            _warned_flag = True
        raise CheckpointShapeError(
            f"checkpoint/mesh world-shape mismatch: {shapes}; enable "
            f"--elastic-resume to reshard instead of crashing in the "
            f"restore")
    return "reshard"


# ---- the permutation itself (pure numpy, bitwise) --------------------------


def to_logical(flat: np.ndarray, meta) -> np.ndarray:
    """Padded bucket-layout vector -> the [length] logical vector (pads
    stripped). Inverse of :func:`from_logical`."""
    lens = bucket_content_lengths(meta)
    parts = [flat[off:off + bl]
             for off, bl in zip(meta.bucket_offsets, lens)]
    return np.concatenate(parts) if parts else flat[:0]


def from_logical(vec: np.ndarray, meta) -> np.ndarray:
    """[length] logical vector -> the padded bucket layout of ``meta``."""
    lens = bucket_content_lengths(meta)
    parts: List[np.ndarray] = []
    c = 0
    for bp, bl in zip(meta.bucket_padded, lens):
        parts.append(vec[c:c + bl])
        c += bl
        if bp > bl:
            parts.append(np.zeros((bp - bl,), vec.dtype))
    return np.concatenate(parts) if parts else vec[:0]


def _dm_perm(meta, world):
    return device_major_perm(meta, world)[0]


def _undo_dm(vec: np.ndarray, meta, world) -> np.ndarray:
    return vec[device_major_perm(meta, world)[1]]


def reshard_flat(vec: np.ndarray, meta_src, world_src: int, meta_dst,
                 world_dst: int, dm_src: bool = False,
                 dm_dst: bool = False) -> np.ndarray:
    """One packed flat vector between world layouts along its last axis:
    undo the source device-major permutation (``dm_src``), strip each
    source bucket's pad, re-pad for the destination buckets, apply the
    destination permutation (``dm_dst``). An index permutation plus zero
    pads: bitwise for any dtype."""
    lead = vec.shape[:-1]
    flat = vec.reshape(-1, vec.shape[-1])
    if dm_src:
        _, inv = device_major_perm(meta_src, world_src)
        flat = flat[:, inv]
    out = np.stack([from_logical(to_logical(row, meta_src), meta_dst)
                    for row in flat])
    if dm_dst:
        out = out[:, _dm_perm(meta_dst, world_dst)]
    return out.reshape(*lead, meta_dst.padded)


def relayout_row(vec: np.ndarray, src, dst, world: int) -> np.ndarray:
    """A device-major ZeRO-1 row between two row metas of one world whose
    lengths may differ (a pipeline chunk's own row and the reference's
    row of the longest chunk): the shorter logical row is zero padded,
    the longer one's tail (pads) dropped."""
    v = to_logical(_undo_dm(vec, src, world), src)
    v = np.pad(v, (0, max(0, dst.length - v.size)))[:dst.length]
    return from_logical(v, dst)[_dm_perm(dst, world)]


# ---- the end-to-end elastic restore ---------------------------------------


def _dp_metas(strategy, saved: Dict[str, Any]):
    meta_src = strategy.flat_meta_for_world(saved["world"], saved["buckets"])
    if list(meta_src.bucket_padded) != list(saved["bucket_padded"]) or \
            meta_src.padded != saved["padded"]:
        raise CheckpointShapeError(
            f"reconstructed flat layout for world {saved['world']} x "
            f"{saved['buckets']} buckets (padded {meta_src.padded}, "
            f"{list(meta_src.bucket_padded)}) disagrees with the recorded "
            f"one (padded {saved['padded']}, {saved['bucket_padded']}): "
            f"the model or packing changed since the save")
    return meta_src, strategy._flat_meta


def _pipe_metas(strategy, saved: Dict[str, Any]):
    meta_src = row_flat_meta(saved["length"], saved["dp"], saved["buckets"])
    if list(meta_src.bucket_padded) != list(saved["bucket_padded"]) or \
            meta_src.padded != saved["padded"]:
        raise CheckpointShapeError(
            f"reconstructed row layout for dp {saved['dp']} x "
            f"{saved['buckets']} buckets disagrees with the recorded one: "
            f"the stage packing changed since the save")
    return meta_src, strategy.ref_row_meta()


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _unpack_logical(vec: np.ndarray, meta) -> List[torch.Tensor]:
    """[length] logical vector -> one tensor per leaf of ``meta`` (the
    reference's layout)."""
    out, off = [], 0
    for size, shape in zip(meta.sizes, meta.shapes):
        out.append(torch.from_numpy(vec[off:off + size].reshape(shape)
                                    .copy()))
        off += size
    return out


def elastic_restore(restored: Dict[str, Any], saved: Dict[str, Any],
                    strategy) -> Dict[str, Any]:
    """A checkpoint's state tree ``restored`` (written at the saved world
    shape ``saved``) converted to the live strategy's layout: every flat
    leaf permuted between the world layouts on the host. The caller
    loads the result (``load_checkpoint_state``)."""
    opt = dict(restored["opt"])
    if saved["kind"] == "dp_shard":
        meta_src, meta_dst = _dp_metas(strategy, saved)
        world_src, world_dst = saved["world"], strategy.world_size
        overlap_src = bool(saved.get("overlap"))
        overlap_dst = bool(getattr(strategy, "overlap", False))

        def conv(v):
            return torch.from_numpy(reshard_flat(
                _np(v), meta_src, world_src, meta_dst, world_dst,
                dm_src=True, dm_dst=True))

        params = restored["params"]
        if overlap_src and overlap_dst:
            params = conv(params)
        elif overlap_src:
            # the flat device-major vector -> the per-leaf tensors
            params = _unpack_logical(to_logical(
                _undo_dm(_np(params), meta_src, world_src), meta_src),
                meta_dst)
        elif overlap_dst:
            logical = np.concatenate([_np(t).ravel() for t in params]) \
                if params else np.zeros((0,), np.float32)
            params = torch.from_numpy(
                from_logical(logical, meta_dst)[_dm_perm(meta_dst,
                                                         world_dst)])
        # m/v are device-major on both sides (the ranks' shards
        # concatenated)
        for k in ("m", "v"):
            if k in opt:
                opt[k] = conv(opt[k])
        return {**restored, "params": params, "opt": opt}
    # pipe_shard: every row leaf converts along its last axis,
    # device-major on both sides
    meta_src, meta_dst = _pipe_metas(strategy, saved)
    world_src, world_dst = saved["dp"], strategy.dp

    def conv(v):
        return torch.from_numpy(reshard_flat(
            _np(v), meta_src, world_src, meta_dst, world_dst, dm_src=True,
            dm_dst=True))

    for k in ("m", "v"):
        if k in opt:
            opt[k] = conv(opt[k])
    return {**restored, "params": conv(restored["params"]), "opt": opt}
