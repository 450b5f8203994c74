"""A strategy's train state as one tree, for checkpoints
(train/checkpoint.py) and their reshard (train/reshard.py).

Every strategy has ``checkpoint_state()``, which returns its state
gathered to the global layout the reference's orbax checkpoint holds for
the same run: ``{"params": ..., "model_state": ..., "opt": {...}}`` of
CPU tensors (the reference's TrainState), and
``load_checkpoint_state(state)``, which scatters such a tree back onto
its devices and ranks. Both are collectives on a strategy of ranks:
every rank calls them. The leaves come in the reference's order
(:func:`tree_leaves`: dict keys sorted, lists in order) and layouts:

* single and dp's replicated engines: one tensor per parameter in the
  reference's leaf order (parallel/common.ref_param_order) and layout (a
  convolution kernel HWIO), the BatchNorm statistics per layer (names
  sorted), and the optimizer's ``m``/``v`` like the parameters, ``step``
  and int8's ``qstep`` as int32 scalars;
* dp's ZeRO-1 engines: ``m``/``v`` (and the overlapped engine's
  parameters) as the packed flat vector, the device-major concatenation
  of the ranks' shards;
* the pipelines: the packed stage rows ([C, L], [V, S, L] interleaved;
  hybrid ZeRO-1's rows in the reference's ``row_flat_meta`` of the
  longest row, device-major), ``step`` one per row;
* the strategies whose shards the reference lays out otherwise (fsdp,
  tp, sp, ep, the tp shards of tpp): each tensor a rank holds a part
  of, the ranks' parts stacked in rank order on a new first axis
  (concatenated, for a flat vector: fsdp's per-layer shards give the
  layer's whole padded vector), each replicated tensor once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.parallel.common import (from_ref_layout,
                                                ref_param_order,
                                                to_ref_layout)

OPT_TENSOR_KEYS = ("m", "v")
OPT_SCALAR_KEYS = ("qstep", "step")
# the reference's TrainState fields, in its (NamedTuple) order
TRAIN_STATE_KEYS = ("params", "model_state", "opt")


def _keys(tree: dict) -> List[Any]:
    if set(tree) == set(TRAIN_STATE_KEYS):
        return list(TRAIN_STATE_KEYS)
    return sorted(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples in jax.tree.leaves'
    order: a dict's keys sorted, the train state's in TrainState order."""
    if isinstance(tree, dict):
        return [x for k in _keys(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _dtype_name(t: Any) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return "int32" if isinstance(t, int) else "float32"


def leaf_meta(tree: Any) -> List[Dict[str, Any]]:
    """[{"shape", "dtype"}] of every leaf (train/reshard.logical_meta)."""
    return [{"shape": list(getattr(t, "shape", ())), "dtype": _dtype_name(t)}
            for t in tree_leaves(tree)]


def check_payload(saved: Any, current: Any) -> None:
    """Raise ValueError unless ``saved`` has ``current``'s structure, leaf
    shapes and dtypes: a checkpoint that does not fit the strategy is an
    error, never a partial load."""
    def walk(a, b, path):
        if isinstance(b, dict):
            if not isinstance(a, dict) or sorted(a) != sorted(b):
                raise ValueError(
                    f"checkpoint payload at {path or 'the root'}: keys "
                    f"{sorted(a) if isinstance(a, dict) else type(a)} != "
                    f"the strategy's {sorted(b)}")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            if not isinstance(a, (list, tuple)) or len(a) != len(b):
                raise ValueError(
                    f"checkpoint payload at {path}: "
                    f"{len(a) if isinstance(a, (list, tuple)) else type(a)}"
                    f" entries != the strategy's {len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            ga, gb = leaf_meta(a)[0], leaf_meta(b)[0]
            if ga != gb:
                raise ValueError(
                    f"checkpoint payload at {path}: shape {ga['shape']} "
                    f"{ga['dtype']} != the strategy's {gb['shape']} "
                    f"{gb['dtype']}")
    walk(saved, current, "")


def host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` (detached, contiguous)."""
    return t.detach().to("cpu", copy=True).contiguous()


def int32(n) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32)


@torch.no_grad()
def put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst`` := ``src`` (shapes must be equal: no broadcast)."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint tensor of shape {tuple(src.shape)} "
                         f"for one of {tuple(dst.shape)}")
    dst.copy_(src.to(dst.device, dst.dtype))


def ref_params(layers: Sequence[torch.nn.Module]
               ) -> List[torch.nn.Parameter]:
    """``layers``' parameters in the reference's leaf order."""
    return ref_param_order(LayerModel("chunk", list(layers), (1,), 1))[0]


def ref_buffers(layers: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """``layers``' BatchNorm statistics (the reference's model_state):
    per layer the floating-point buffers, names sorted."""
    out = []
    for layer in layers:
        out += [b for _, b in sorted(layer.named_buffers())
                if b.is_floating_point()]
    return out


def leaves_ref(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """CPU copies in the reference's layout."""
    return [host(to_ref_layout(t)) for t in tensors]


def load_leaves_ref(tensors: Sequence[torch.Tensor],
                    saved: Sequence[torch.Tensor]) -> None:
    if len(tensors) != len(saved):
        raise ValueError(f"{len(saved)} checkpoint tensors for "
                         f"{len(tensors)}")
    for t, s in zip(tensors, saved):
        put(t, from_ref_layout(s))


def opt_scalars(opt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: int32(opt[k]) for k in OPT_SCALAR_KEYS if k in opt}


def load_opt_scalars(opt: Dict[str, Any], saved: Dict[str, Any]) -> None:
    for k in OPT_SCALAR_KEYS:
        if k in opt:
            opt[k] = int(saved[k])


def opt_ref(opt: Dict[str, Any], order: Sequence[int]) -> Dict[str, Any]:
    """``opt`` (flat_optimizer's: ``m``/``v`` lists) with its tensors
    ``order``-ed and in the reference's layout, its counters int32."""
    out = {k: leaves_ref([opt[k][i] for i in order])
           for k in OPT_TENSOR_KEYS if k in opt}
    out.update(opt_scalars(opt))
    return out


def load_opt_ref(opt: Dict[str, Any], saved: Dict[str, Any],
                 order: Sequence[int]) -> None:
    for k in OPT_TENSOR_KEYS:
        if k in opt:
            load_leaves_ref([opt[k][i] for i in order], saved[k])
    load_opt_scalars(opt, saved)


def order_of(params: Sequence[torch.Tensor],
             held: Sequence[torch.Tensor]) -> List[int]:
    """The index in ``held`` of each of ``params`` (by identity)."""
    idx = {id(p): i for i, p in enumerate(held)}
    return [idx[id(p)] for p in params]


def pack_rows(groups: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """[G, L] on the CPU: row g the tensors of ``groups[g]`` raveled in
    the reference's layout, zero-padded to the longest row (float32,
    float64 for float64 tensors)."""
    flat = [torch.cat([to_ref_layout(t.detach()).reshape(-1).cpu()
                       for t in g]) if g else None for g in groups]
    dtypes = [f.dtype for f in flat if f is not None]
    dtype = torch.promote_types(dtypes[0] if dtypes else torch.float32,
                                torch.float32)
    L = max([f.numel() for f in flat if f is not None] or [0])
    out = torch.zeros(len(groups), L, dtype=dtype)
    for g, f in enumerate(flat):
        if f is not None:
            out[g, :f.numel()] = f
    return out


def unpack_rows(groups: Sequence[Sequence[torch.Tensor]],
                rows: torch.Tensor) -> None:
    """Inverse of :func:`pack_rows`: each row into its group's tensors."""
    rows = rows.reshape(len(groups), -1)
    for g, row in zip(groups, rows):
        off = 0
        for t in g:
            n = t.numel()
            if off + n > row.numel():
                raise ValueError(f"a checkpoint row of {row.numel()} "
                                 f"elements for {off + n}")
            put(t, from_ref_layout(row[off:off + n].view(
                to_ref_layout(t).shape)))
            off += n


def gather_stack(comm, t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` stacked in rank order, on the CPU (a flat ``t``:
    concatenated). A collective every rank of ``comm`` calls."""
    if comm is None or comm.world == 1:
        return host(t if t.dim() == 1 else t.unsqueeze(0))
    t = t.detach().contiguous()
    out = comm.all_gather(t).cpu()
    return out if t.dim() == 1 else out.view(comm.world, *t.shape)


def own_part(t: torch.Tensor, comm) -> torch.Tensor:
    """Inverse of :func:`gather_stack`: this rank's part of ``t``."""
    n, r = (1, 0) if comm is None else (comm.world, comm.rank)
    if t.dim() == 1:
        if t.numel() % n:
            raise ValueError(f"a flat checkpoint vector of {t.numel()} for "
                             f"{n} ranks")
        per = t.numel() // n
        return t[r * per:(r + 1) * per]
    if t.shape[0] != n:
        raise ValueError(f"a stack of {t.shape[0]} rank parts for {n} ranks")
    return t[r]


def rank_parts(comm, tensors: Sequence[torch.Tensor],
               sharded: Optional[Sequence[bool]] = None) -> List[torch.Tensor]:
    """Each tensor the ranks hold a part of (``sharded``; all by
    default) gathered by :func:`gather_stack`, each replicated one once."""
    sharded = [True] * len(tensors) if sharded is None else sharded
    return [gather_stack(comm, t) if sh else host(t)
            for t, sh in zip(tensors, sharded)]


def load_rank_parts(comm, tensors: Sequence[torch.Tensor],
                    saved: Sequence[torch.Tensor],
                    sharded: Optional[Sequence[bool]] = None) -> None:
    """Inverse of :func:`rank_parts`, in place."""
    if len(tensors) != len(saved):
        raise ValueError(f"{len(saved)} checkpoint tensors for "
                         f"{len(tensors)}")
    sharded = [True] * len(tensors) if sharded is None else sharded
    for t, s, sh in zip(tensors, saved, sharded):
        put(t, own_part(s, comm) if sh else s)


def opt_rank_parts(comm, opt: Dict[str, Any],
                   sharded: Optional[Sequence[bool]] = None) -> Dict[str, Any]:
    """``opt``'s tensors as :func:`rank_parts`, its counters int32."""
    out = {k: rank_parts(comm, opt[k], sharded)
           for k in OPT_TENSOR_KEYS if k in opt}
    out.update(opt_scalars(opt))
    return out


def load_opt_rank_parts(comm, opt: Dict[str, Any], saved: Dict[str, Any],
                        sharded: Optional[Sequence[bool]] = None) -> None:
    for k in OPT_TENSOR_KEYS:
        if k in opt:
            load_rank_parts(comm, opt[k], saved[k], sharded)
    load_opt_scalars(opt, saved)
