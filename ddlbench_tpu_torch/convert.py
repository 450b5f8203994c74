"""Carry the JAX package's weights into the port's modules.

``from_jax_params(model, params_np)`` copies the reference's per-layer
param list — each layer's dict of arrays, as numpy (``jax.device_get`` of
``init_model``'s params) — into the port's ``LayerModel``:

* embed: ``tok``, ``pos`` (and ``seg``, the seq2seq embedding's segment
  table);
* block: ``ln1``/``ln2`` ``scale``/``bias``, ``wqkv``, ``wo``, ``w1``,
  ``b1``, ``w2``, ``b2``; an MoE block's ``gate`` [d, E] and its stacked
  ``experts`` ``w1``/``b1``/``w2``/``b2`` [E, ...] (models/moe.py);
* the LSTM seq2seq (models/lstm.py): an LSTM layer's ``wx``, ``wh``,
  ``b``, the cross-attention's ``q``, ``k``, ``v``, ``o``, the
  embedding's ``tok`` and ``seg``;
* head: ``ln_f`` ``scale``/``bias``, ``head``;
* image layers: ``kernel``, ``conv1``.. ``conv3``, ``proj``, ``expand``,
  ``dw``, ``project``, ``pw``, ``c1``.. ``c3``, ``sq``, ``e1``, ``e3``,
  ``l<i>_c1``/``l<i>_c2``, ``conv`` (convolution kernels), ``bn*.scale``/
  ``bias``, ``w``/``b`` (dense; ``b`` also a plain convolution's bias);
* the composite layers of the branchy models (models/branchy.py): a list
  of such dicts, one per node of the span, whose k-th entry lands on the
  parameters named ``<k>.<name>``.

Parameters are matched by name, so a layer is covered whatever its
family. Dense weights stay ``[in, out]`` — the port computes ``x @ W``
exactly as the JAX code does — and are copied as they are. Convolution
kernels, the only 4-D arrays, go from the reference's HWIO to the port's
OIHW (``permute(3, 2, 0, 1)``; a depthwise ``(k, k, 1, c)`` becomes
``(c, 1, k, k)``, convolved with ``groups=c``, and resnext's grouped
``(3, 3, width / 32, width)`` becomes ``(width, width / 32, 3, 3)``,
convolved with ``groups=32``: both packages split the output channels
into contiguous groups). The port
flattens VGG's map in the reference's (H, W, C) order, so the
classifier's first dense rows need no reordering.

``load_packed_rows(chunks, rows)`` puts the pipelines' packed stage rows
(the reference's ``[S, L]`` / ``[V, S, L]`` parameter matrix, each row a
chunk's leaves in its order and layout) back into each chunk's
parameters; ``load_hetero_rows`` does it for the hetero pipelines from
the reference's ``[N, L]`` device rows, and ``zero1_plain_rows`` turns
its hybrid PP x ZeRO-1 device-major padded rows into plain ones.

``from_jax_state(model, states_np)`` copies the reference's per-layer
state list (``init_model``'s second output: BatchNorm's running ``mean``
and ``var``, of every BatchNorm, a composite layer's nodes' too) into the
port's buffers the same way.

``from_jax_opt_state(opt, model, opt_np)`` carries the reference's
optimizer state (``TrainState.opt``: SGD ``{"m"}``, Adam ``{"m", "v",
"step"}``, each m/v a per-layer param list like the params) into the
single strategy's state of ``model``'s parameters (the same keys,
parallel/common.flat_optimizer), so a run can resume the port from a JAX
TrainState mid-run.

``tp_shard_params(params_np, rank, n)`` gives a tensor-parallel shard's
part of the reference's weights, the dense blocks split by the port's
copy of the reference's splitter, for a model sliced to that shard.

The sharded strategies take the model's whole weights when they start
(parallel/ep.py, parallel/sharded.py: convert first, then build the
strategy). To carry the reference's weights into a running rank's shards:
``from_jax_params(model, params_np, expert_rank=(r, n))`` copies into an
ep rank's model, whose expert stacks hold experts [r E/n, (r + 1) E/n),
the reference's stacks sliced so; ``to_fsdp_shards(strategy, params_np)``
packs each layer as fsdp does and copies the rank's slice into its
shards.

This module imports no JAX: it takes numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ddlbench_tpu_torch.models.layers import LayerModel


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """Dotted names of a nested param dict: {"ln1": {"scale": a}} ->
    ("ln1.scale", a) — the port's module parameter names; a list's k-th
    entry is named "k" (a composite layer's nodes)."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def to_port_layout(arr) -> np.ndarray:
    """A reference array in the port's layout: a 4-D (HWIO convolution)
    kernel as OIHW, anything else as it is."""
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def _expert_slice(name: str, arr: np.ndarray,
                  expert_rank: Optional[Tuple[int, int]]) -> np.ndarray:
    """An ``experts`` leaf's rows of rank r of n (ep's shard)."""
    if expert_rank is None or ".experts." not in f".{name}":
        return arr
    r, n = expert_rank
    per = arr.shape[0] // n
    return arr[r * per:(r + 1) * per]


def _pairs(model: LayerModel, tree_np: List[Dict], buffers: bool = False,
           expert_rank: Optional[Tuple[int, int]] = None
           ) -> Iterator[Tuple[str, torch.Tensor, np.ndarray]]:
    """(name, port tensor, reference array in the port's layout) for every
    parameter of ``model`` (every buffer with ``buffers``) against
    ``tree_np`` (one nested dict of arrays per layer), which must cover
    exactly the port's tensors at their shapes (an ``experts`` leaf
    sliced to ep rank ``expert_rank`` = (r, n) where given)."""
    if len(tree_np) != len(model.layers):
        raise ValueError(f"{len(tree_np)} dicts for "
                         f"{len(model.layers)} layers")
    for i, (layer, tree) in enumerate(zip(model.layers, tree_np)):
        own = dict(layer.named_buffers() if buffers
                   else layer.named_parameters())
        given = {n: _expert_slice(n, to_port_layout(a), expert_rank)
                 for n, a in _flatten(tree)}
        if set(own) != set(given):
            raise ValueError(
                f"layer {i}: {sorted(given)} do not match the port's "
                f"{sorted(own)}")
        for name, arr in given.items():
            if tuple(np.shape(arr)) != tuple(own[name].shape):
                raise ValueError(
                    f"layer {i} {name}: shape {tuple(np.shape(arr))} vs "
                    f"{tuple(own[name].shape)}")
            yield f"{i}.{name}", own[name], arr


def _tensor_like(arr, p: torch.Tensor) -> torch.Tensor:
    # np.array: a writable copy
    return torch.from_numpy(np.array(arr)).to(p.device, p.dtype)


@torch.no_grad()
def from_jax_params(model: LayerModel, params_np: List[Dict],
                    expert_rank: Optional[Tuple[int, int]] = None
                    ) -> LayerModel:
    """Copy ``params_np`` (one nested dict of arrays per layer) into
    ``model`` in place and return it. Every array must land on a parameter
    of the same shape, and every parameter must be covered; with
    ``expert_rank`` = (r, n) the ``experts`` leaves land as ep rank r's
    slice (the model's expert stacks hold E/n)."""
    for _, p, arr in list(_pairs(model, params_np,
                                 expert_rank=expert_rank)):
        p.copy_(_tensor_like(arr, p))
    return model


@torch.no_grad()
def to_fsdp_shards(strategy, params_np: List[Dict]):
    """Copy ``params_np`` into a running fsdp rank's shards
    (parallel/sharded.FSDPStrategy): each layer's arrays in the port's
    layout, packed in the strategy's order and padded as it packs them,
    and this rank's slice copied into its shard. Returns the strategy."""
    if len(params_np) != len(strategy.shards):
        raise ValueError(f"{len(params_np)} dicts for "
                         f"{len(strategy.shards)} layers")
    n, r = strategy.comm.world, strategy.comm.rank
    for i, tree in enumerate(params_np):
        given = {name: to_port_layout(a) for name, a in _flatten(tree)}
        if set(given) != set(strategy.names[i]):
            raise ValueError(f"layer {i}: {sorted(given)} do not match the "
                             f"port's {sorted(strategy.names[i])}")
        flat = np.zeros(strategy.padded[i], np.float32)
        off = 0
        for name, shape in zip(strategy.names[i], strategy.shapes[i]):
            arr = np.asarray(given[name], np.float32)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"layer {i} {name}: shape {arr.shape} vs "
                                 f"{shape}")
            flat[off:off + arr.size] = arr.reshape(-1)
            off += arr.size
        per = strategy.padded[i] // n
        strategy.shards[i].copy_(_tensor_like(flat[r * per:(r + 1) * per],
                                              strategy.shards[i]))
    return strategy


def tp_shard_params(params_np: List[Dict], rank: int, n: int) -> List[Dict]:
    """Tensor-parallel shard ``rank`` of ``n`` of the reference's
    parameters (one nested dict of arrays per layer): each dense block
    split by the port's copy of the reference's splitter
    (models/transformer.tp_split_layer_params) into the shard's slices
    and the leaves kept whole, every other layer whole. Load the result
    with :func:`from_jax_params` into a model whose blocks hold that
    shard (models/transformer.slice_block)."""
    from ddlbench_tpu_torch.models.transformer import tp_split_layer_params

    out = []
    for tree in params_np:
        shards, repl = tp_split_layer_params(tree, n)
        out.append({**repl, **shards[rank]} if shards[rank] else tree)
    return out


@torch.no_grad()
def from_jax_state(model: LayerModel, states_np: List[Dict]) -> LayerModel:
    """Copy the reference's per-layer state list ``states_np`` (BatchNorm
    running statistics; ``{}`` for a stateless layer) into ``model``'s
    buffers in place and return it. Every buffer must be covered."""
    for _, b, arr in list(_pairs(model, states_np, buffers=True)):
        b.copy_(_tensor_like(arr, b))
    return model


def from_jax_opt_state(opt: dict, model: LayerModel,
                       opt_np: Mapping) -> dict:
    """Set a single-strategy optimizer state ``opt``
    (parallel/common.flat_optimizer's: ``m`` and for Adam ``v``, one
    tensor per ``model.parameters()``, and ``step``) from the reference's
    optimizer state ``opt_np`` (numpy leaves, the same keys), in place.
    Returns ``opt``."""
    want = {"m", "v", "step"} if "v" in opt else {"m"}
    if set(opt_np) != want:
        raise ValueError(f"the optimizer state must be {sorted(want)}, got "
                         f"{sorted(opt_np)}")
    index = {id(p): i for i, p in enumerate(model.parameters())}
    for key in sorted(want - {"step"}):
        for _, p, arr in list(_pairs(model, opt_np[key])):
            opt[key][index[id(p)]] = _tensor_like(arr, p)
    if "step" in want:
        opt["step"] = int(np.asarray(opt_np["step"]))
    return opt


def load_packed_rows(chunks, rows) -> None:
    """Each chunk's parameters (``chunks``: a list of layer lists) from its
    row of the reference's packed stage matrix (``rows``: [C, L] or [V,
    S, L], row c = chunk c, each holding the chunk's parameters in the
    reference's leaf order and layout, zero-padded; numpy), in place:
    the inverse of the pipelines' ``materialize_params``."""
    from ddlbench_tpu_torch.parallel.common import ref_param_order

    rows = np.asarray(rows).reshape(len(chunks), -1)
    for layers, row in zip(chunks, rows):
        params, _ = ref_param_order(LayerModel("chunk", list(layers), (1,),
                                               1))
        _load_row(params, row)


def _load_row(leaves, row) -> None:
    """``leaves`` (port tensors, in the row's order) from a packed row in
    the reference's layout, in place."""
    from ddlbench_tpu_torch.parallel.common import (from_ref_layout,
                                                    to_ref_layout)

    off = 0
    with torch.no_grad():
        for p in leaves:
            n = p.numel()
            flat = torch.from_numpy(np.array(row[off:off + n]))
            p.copy_(from_ref_layout(flat.view(to_ref_layout(p).shape)))
            off += n
    if off > row.size:
        raise ValueError(f"a row of {row.size} elements for {off} "
                         "parameters")


def load_tpp_rows(strategy, sliced_np, repl_np) -> None:
    """A tpp rank's parameters (parallel/tpp.py, 3-D or not) from the
    reference's two packed matrices, in place: ``sliced_np`` [S, tp,
    L_sl] (row [s, t]: shard t's sliced leaves of stage s), whose row of
    this rank's shard it takes, and ``repl_np`` [S, L_rp] (each stage's
    replicated leaves); each in the reference's leaf order, zero-padded.
    The inverse of the strategy's ``materialize_params``; call
    ``strategy.init()`` after it for a fresh optimizer state."""
    sliced_np, repl_np = np.asarray(sliced_np), np.asarray(repl_np)
    t = strategy.tp_comm.rank
    for c in range(strategy.num_chunks):
        sliced, repl = strategy._rows(c)
        _load_row(sliced, sliced_np[c, t])
        _load_row(repl, repl_np[c])


def load_hetero_rows(strategy, rows_np) -> None:
    """The hetero pipelines' parameters (parallel/hetero.py) from the
    reference's [N, L] device rows (row d = its stage's packed row; a
    stage's replicas hold one row), in place: each stage's first device
    row into its replica 0, then ``strategy.init()`` copies replica 0
    into the others (and starts a fresh optimizer state)."""
    rows_np = np.asarray(rows_np)
    load_packed_rows([strategy.replicas[s][0]
                      for s in range(strategy.num_stages)],
                     rows_np[strategy._offsets[:-1]])
    strategy.init()


def zero1_plain_rows(rows_np, length: int, world: int,
                     buckets: int = 1) -> np.ndarray:
    """The reference's hybrid PP x ZeRO-1 parameter rows ([.., L_pad]:
    device-major over ``world`` replicas in ``buckets`` stretches of its
    ``row_flat_meta(length, world, buckets)``) as the plain [.., length]
    rows :func:`load_packed_rows` takes."""
    from ddlbench_tpu_torch.parallel.common import (device_major_perm,
                                                    row_flat_meta)

    meta = row_flat_meta(length, world, buckets)
    _, inv = device_major_perm(meta, world)
    return np.take(np.asarray(rows_np), inv, axis=-1)[..., :length]
