"""Shared train-step machinery of the port: loss, metrics, optimizers.

The port of the one-apply pieces of ``ddlbench_tpu/parallel/common.py``:
the cross-entropy loss and the top-1/top-k counts, the last pipeline
chunk's fused-head loss and eval sums (``fused_chunk_loss_sums``,
``fused_chunk_eval_sums``), ``loss_with_moe_aux``
(the fused LM head or the full logits, plus the MoE router's aux losses,
which each MoE block records on its forward: models/moe.py), the
single-apply ``loss_and_grads``, ``eval_metrics`` (fused and logits),
the step-decay learning rate (``step_decay_lr``) and ``cast_input``;
the data-parallel pieces: the flat-vector layout of dp's collectives
(``FlatMeta`` .. ``from_device_major``), the int8 wire's quantisation, the
gradual warmup; and ``flat_optimizer``, the reference's ``make_optimizer``
update formulas on tensors, which every strategy runs.

The model is applied on compute-dtype casts of its float32 parameters
(models/layers.apply_slice) and of a floating-point input (images); the
logits loss upcasts the logits to float32, the fused head
(ops/fused_xent.py) computes in float32 without them. The loss applies the
model in train mode (BatchNorm normalises with the batch statistics and
updates its running ones), the eval metrics in eval mode. Metrics stay
tensors: nothing here waits for the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import (LayerModel, apply_chunk,
                                             apply_model, apply_slice,
                                             call_layer)
from ddlbench_tpu_torch.models.moe import aux_losses
from ddlbench_tpu_torch.ops import threefry
from ddlbench_tpu_torch.ops.fused_xent import fused_linear_xent


def step_decay_lr(base_lr: float, epoch: int, step_epochs: int,
                  gamma: float) -> float:
    """lr x gamma every ``step_epochs`` epochs (``epoch`` 0-based)."""
    return base_lr * (gamma ** (epoch // step_epochs))


def cast_input(x: torch.Tensor, dtype: Optional[torch.dtype]
               ) -> torch.Tensor:
    """A batch in the compute dtype; integer inputs (token ids) pass
    through."""
    if dtype is None or not x.is_floating_point():
        return x
    return x.to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over valid label positions (``labels >= 0``), in float32
    (float64 logits stay float64); logits [..., V], labels [...].
    ``smoothing`` is GNMT-style label smoothing: loss_tok =
    (1-s)*NLL(gold) - s*mean_v(logp_v)."""
    logp = F.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if smoothing:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def correct_and_count(logits: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, valid-position count) as int tensors."""
    valid = labels >= 0
    ok = (logits.argmax(-1) == labels) & valid
    return ok.sum(), valid.sum()


def correct_topk(logits: torch.Tensor, labels: torch.Tensor,
                 k: int = 5) -> torch.Tensor:
    """Count of valid positions whose label is in the top-k logits, with
    torch.topk's tie order (value descending, index ascending): the label
    ranks after every strictly greater logit and after equal logits at
    smaller class indices."""
    k = min(k, logits.shape[-1])
    safe = labels.clamp(min=0).long()
    gold = logits.gather(-1, safe[..., None])
    higher = (logits > gold).sum(-1)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    tie_before = ((logits == gold) & (idx < safe[..., None])).sum(-1)
    return ((higher + tie_before < k) & (labels >= 0)).sum()


def head_fusable(model: LayerModel) -> bool:
    """True when the model's last layer offers the fused projection+loss
    path (ops/fused_xent.py): the LM heads of the token/seq2seq
    workloads."""
    return hasattr(model.layers[-1], "fused_loss")


def fused_head_loss_sums(model: LayerModel, x: torch.Tensor,
                         y: torch.Tensor, compute_dtype: torch.dtype,
                         smoothing: float, remat: bool = False):
    """Apply layers[:-1] (with remat as configured), then the head's fused
    projection+CE. Returns (obj_sum, ce_sum, correct, valid): sums over
    valid label positions; callers normalise."""
    h = apply_slice(model.layers[:-1], x, compute_dtype, remat)
    obj_sum, ce_sum, correct = model.layers[-1].fused_loss(h, y, smoothing)
    return obj_sum, ce_sum, correct, (y >= 0).sum()


def fused_head_eval_sums(model: LayerModel, x: torch.Tensor,
                         y: torch.Tensor, compute_dtype: torch.dtype):
    """Eval twin of fused_head_loss_sums: (ce_sum, correct, correct5,
    valid)."""
    return fused_chunk_eval_sums(model.layers, x, y, compute_dtype)


def fused_chunk_head_inputs(layers: Sequence[torch.nn.Module],
                            x: torch.Tensor, compute_dtype: torch.dtype,
                            params: Optional[Sequence[dict]] = None,
                            update_stats: bool = True):
    """The last pipeline chunk up to its fused head: ``layers[:-1]``
    through models/layers.apply_chunk (on ``params`` when given), then the
    head's two operands (LMHead.fused_parts: the normalised rows and the
    projection, on the head's float32 masters as fused_head_loss_sums
    runs it)."""
    h = apply_chunk(layers[:-1], x, compute_dtype,
                    None if params is None else params[:-1], update_stats)
    return call_layer(layers[-1], None if params is None else params[-1],
                      h, "fused_parts")


def fused_chunk_loss_sums(layers: Sequence[torch.nn.Module],
                          x: torch.Tensor, y: torch.Tensor,
                          compute_dtype: torch.dtype, smoothing: float,
                          params: Optional[Sequence[dict]] = None,
                          update_stats: bool = True):
    """The last chunk's fused-head loss (the reference's
    ``fused_slice_loss_sums``): (obj_sum, ce_sum, correct, valid) over the
    valid labels of ``y``; callers normalise."""
    rows, w = fused_chunk_head_inputs(layers, x, compute_dtype, params,
                                      update_stats)
    obj_sum, ce_sum, correct = fused_linear_xent(rows, w, y.reshape(-1),
                                                 smoothing)
    return obj_sum, ce_sum, correct, (y >= 0).sum()


def fused_chunk_eval_sums(layers: Sequence[torch.nn.Module],
                          x: torch.Tensor, y: torch.Tensor,
                          compute_dtype: torch.dtype):
    """Eval twin of :func:`fused_chunk_loss_sums` (the reference's
    ``fused_slice_eval_sums``): (ce_sum, correct, correct5, valid)."""
    h = apply_chunk(layers[:-1], x, compute_dtype)
    return layers[-1].fused_eval(h, y)


def loss_with_moe_aux(model: LayerModel, x: torch.Tensor, y: torch.Tensor,
                      compute_dtype: torch.dtype, smoothing: float = 0.0,
                      fused: bool = False, remat: bool = False,
                      aux_weight: float = 0.0):
    """Apply the model and return (objective, ce, (correct, valid)). The
    objective is the (optionally label-smoothed) CE plus ``aux_weight``
    times the sum of the MoE blocks' router load-balance losses of this
    forward (none for a dense model); ``ce`` is the unsmoothed CE, the
    headline metric, without them. With ``fused`` (and a head that
    supports it) the projection+loss runs the fused path and the full
    logits are never materialised."""
    model.train()
    x = cast_input(x, compute_dtype)
    if fused and head_fusable(model):
        obj_sum, ce_sum, correct, valid = fused_head_loss_sums(
            model, x, y, compute_dtype, smoothing, remat)
        denom = valid.clamp(min=1).float()
        obj, ce, stats = obj_sum / denom, ce_sum / denom, (correct, valid)
    else:
        logits = apply_model(model, x, compute_dtype, remat)
        ce = cross_entropy_loss(logits, y)
        obj = cross_entropy_loss(logits, y, smoothing) if smoothing else ce
        stats = correct_and_count(logits, y)
    aux = aux_losses(model)
    if aux:  # summed in layer order, as the reference's collector
        obj = obj + aux_weight * sum(aux)
    return obj, ce, stats


# ---- the rank-local sums of the data- and axis-sharded strategies ----------


def local_loss_sums(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                    y: torch.Tensor, compute_dtype: torch.dtype,
                    smoothing: float):
    """(obj_sum, ce_sum, correct, valid) over this rank's rows or sequence
    shard, the model in train mode (the reference's ``_local_loss_sums``
    and ``fwd_local``): through the fused head where it is enabled and
    the head supports it, else the logits; the objective label-smoothed,
    the CE not. Callers reduce the sums over the ranks
    (:func:`reduce_loss_sums`)."""
    model.train()
    xc = cast_input(x, compute_dtype)
    if cfg.fused_head_loss and head_fusable(model):
        return fused_head_loss_sums(model, xc, y, compute_dtype, smoothing,
                                    cfg.remat_layers)
    logits = apply_model(model, xc, compute_dtype, cfg.remat_layers)
    return logits_loss_sums(logits, y, smoothing)


def logits_loss_sums(logits: torch.Tensor, y: torch.Tensor,
                     smoothing: float):
    """(obj_sum, ce_sum, correct, valid) of ``logits`` against ``y``
    (valid where ``y >= 0``): the sums :func:`local_loss_sums` takes
    from the full logits."""
    logp = F.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)),
        dim=-1)
    maskf = (y >= 0).to(logp.dtype)
    nll = -logp.gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
    ce_sum = (nll * maskf).sum()
    obj_sum = ce_sum
    if smoothing:
        s = smoothing
        obj_sum = (((1.0 - s) * nll - s * logp.mean(-1)) * maskf).sum()
    correct, valid = correct_and_count(logits, y)
    return obj_sum, ce_sum, correct, valid


def local_eval_sums(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                    y: torch.Tensor, compute_dtype: torch.dtype):
    """(ce_sum, correct, correct5, count) over this rank's rows or
    sequence shard, the model in eval mode, without gradients: through
    the fused head where enabled, else the logits."""
    model.eval()
    xc = cast_input(x, compute_dtype)
    with torch.no_grad():
        if cfg.fused_head_loss and head_fusable(model):
            return fused_head_eval_sums(model, xc, y, compute_dtype)
        return logits_eval_sums(apply_model(model, xc, compute_dtype), y)


def logits_eval_sums(logits: torch.Tensor, y: torch.Tensor):
    """(ce_sum, correct, correct5, count) of ``logits`` against ``y``."""
    logp = F.log_softmax(logits.to(torch.promote_types(
        logits.dtype, torch.float32)), dim=-1)
    nll = -logp.gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
    ce_sum = (nll * (y >= 0).to(nll.dtype)).sum()
    correct, count = correct_and_count(logits, y)
    return ce_sum, correct, correct_topk(logits, y), count


def reduce_loss_sums(comm, obj_sum: torch.Tensor, ce_sum: torch.Tensor,
                     correct: torch.Tensor, valid: torch.Tensor,
                     aux: Sequence[torch.Tensor] = (),
                     aux_weight: float = 0.0, aux_global: bool = False):
    """The reference's ``fwd_local`` reductions over ``comm``'s ranks:
    (this rank's part of the objective, the global CE, global correct,
    global count). ``count`` is all-reduced before the backward; the
    rank differentiates its objective sum over it plus ``aux_weight`` x
    its MoE aux sum over the world, so the ranks' gradients sum to those
    of ``psum(obj) / count + aux_weight x psum(aux) / n``. With
    ``aux_global`` the aux losses are the global batch's (the MoE blocks
    routed under models/moe.global_routing: each rank's gradient of them
    is its own tokens' part), so they enter whole and the ranks'
    gradients sum to the global objective's. The CE is the all-reduced
    sum over the count (no gradient)."""
    counts = comm.all_reduce(
        torch.stack([correct.to(torch.int64), valid.to(torch.int64)]))
    denom = counts[1].float().clamp(min=1.0)
    obj = obj_sum / denom
    if aux:
        obj = obj + aux_weight * sum(aux) / (1 if aux_global
                                             else comm.world)
    ce = comm.all_reduce(ce_sum.detach().to(
        torch.promote_types(ce_sum.dtype, torch.float32)).clone()) / denom
    return obj, ce, counts[0], counts[1]


def reduce_eval_sums(comm, ce_sum: torch.Tensor, correct: torch.Tensor,
                     correct5: torch.Tensor, count: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """The eval step's {loss, correct, correct5, count} from each rank's
    :func:`local_eval_sums`, all-reduced."""
    ce = comm.all_reduce(ce_sum.to(torch.promote_types(
        ce_sum.dtype, torch.float32)).reshape(1).clone())[0]
    ints = comm.all_reduce(torch.stack(
        [t.to(torch.int64) for t in (correct, correct5, count)]))
    return {"loss": ce / ints[2].clamp(min=1).float(),
            "correct": ints[0], "correct5": ints[1], "count": ints[2]}


def _micro_batch(t: torch.Tensor, K: int, k: int) -> torch.Tensor:
    """Rows k, k + K, k + 2K, ... of ``t`` (the reference's reshape to
    [B // K, K, ...] indexed on axis 1), in ``t``'s memory format."""
    part = t.reshape(t.shape[0] // K, K, *t.shape[1:])[:, k]
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return part.contiguous(memory_format=torch.channels_last)
    return part.contiguous()


def accum_loss_and_grads(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                         y: torch.Tensor, compute_dtype: torch.dtype,
                         smoothing: float, accum_steps: int):
    """K-way gradient accumulation (the reference's
    ``accum_loss_and_grads``): micro-step k takes every K-th row of the
    batch, starting at row k; the micro-steps run in order, so BatchNorm's
    running statistics take K updates as K separate batches would; the
    gradients are averaged with weights equal to each micro-step's count
    of valid labels, and so is the reported CE. An MoE arch routes each
    micro-step with its own capacity (over the micro-batch's tokens), as
    in the reference. Returns (ce, (correct, valid), grads) as
    loss_and_grads does."""
    K, B = accum_steps, x.shape[0]
    if B % K:
        raise ValueError(f"batch {B} not divisible by grad_accum_steps {K}")
    params = list(model.parameters())
    gsum, ces, wks, corr, valid = None, [], [], 0, 0
    for k in range(K):
        xk, yk = _micro_batch(x, K, k), _micro_batch(y, K, k)
        obj, ce, (c, v) = loss_with_moe_aux(model, xk, yk, compute_dtype,
                                            smoothing, cfg.fused_head_loss,
                                            cfg.remat_layers,
                                            cfg.moe_aux_weight)
        grads = torch.autograd.grad(obj, params)
        wk = v.float()
        gsum = ([wk * g for g in grads] if gsum is None
                else [a + wk * g for a, g in zip(gsum, grads)])
        ces.append(ce.detach())
        wks.append(wk)
        corr, valid = corr + c, valid + v
    wks = torch.stack(wks)
    total = wks.sum().clamp(min=1.0)
    for p, g in zip(params, gsum):
        p.grad = g / total
    return ((torch.stack(ces) * wks).sum() / total, (corr, valid),
            [p.grad for p in params])


def loss_and_grads(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                   y: torch.Tensor, compute_dtype: torch.dtype,
                   smoothing: float):
    """One-apply training loss and gradients: returns (ce, (correct,
    valid), grads), ``grads`` one tensor per ``model.parameters()`` (also
    left in each parameter's ``.grad``). ``cfg.grad_accum_steps`` > 1
    takes :func:`accum_loss_and_grads`."""
    if cfg.grad_accum_steps > 1:
        return accum_loss_and_grads(model, cfg, x, y, compute_dtype,
                                    smoothing, cfg.grad_accum_steps)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    obj, ce, stats = loss_with_moe_aux(model, x, y, compute_dtype, smoothing,
                                       cfg.fused_head_loss, cfg.remat_layers,
                                       cfg.moe_aux_weight)
    obj.backward()
    return ce.detach(), stats, [p.grad for p in params]


def eval_metrics(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                 y: torch.Tensor,
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The eval step's {loss, correct, correct5, count}, the model in eval
    mode: through the fused head (no [N, V] logits) when it is enabled and
    the head supports it, else through the full logits."""
    model.eval()
    x = cast_input(x, compute_dtype)
    with torch.no_grad():
        if cfg.fused_head_loss and head_fusable(model):
            ce_sum, correct, correct5, count = fused_head_eval_sums(
                model, x, y, compute_dtype)
            return {"loss": ce_sum / count.clamp(min=1).float(),
                    "correct": correct, "correct5": correct5,
                    "count": count}
        logits = apply_model(model, x, compute_dtype)
        correct, count = correct_and_count(logits, y)
        return {"loss": cross_entropy_loss(logits, y), "correct": correct,
                "correct5": correct_topk(logits, y), "count": count}


# ---- the flat-vector layout of dp's explicit collectives -------------------
#
# The port of the reference's FlatMeta machinery (parallel/common.py
# flat_meta .. shard_bucket_slice). The packed vector lays the leaves out
# as the reference does: per layer, the leaves in jax.tree.leaves order
# (dict keys sorted, list entries in order: :func:`ref_param_order`), each
# raveled in the reference's layout (a convolution kernel as HWIO, where
# the port keeps OIHW), so bucket boundaries, pads and the int8 wire's
# rounding bits fall where the reference's do.


class FlatMeta(NamedTuple):
    """Packing recipe for a list of leaves <-> one flat float32 vector.

    ``shapes`` are the leaves' shapes in the reference's layout, ``sizes``
    their element counts; ``length`` is the unpadded element count. The
    vector is ``num_buckets`` contiguous leaf-aligned buckets, bucket b
    holding leaves ``bucket_leaves[b]`` (a (start, stop) range) then pad
    zeros up to ``bucket_padded[b]`` elements (a multiple of the world),
    from offset ``bucket_offsets[b]``; ``padded`` is the total. The pads
    are inert through SGD and Adam: zero params with zero grads stay zero.
    """

    shapes: tuple
    sizes: tuple
    length: int
    padded: int
    bucket_leaves: tuple = ((0, 0),)
    bucket_padded: tuple = (0,)
    bucket_offsets: tuple = (0,)

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_padded)


def _bucket_bounds(group_sizes: Sequence[int], buckets: int) -> List[int]:
    """Greedy contiguous split of ``group_sizes`` (elements per leaf group)
    into <= ``buckets`` group-aligned chunks balancing element counts:
    boundary k falls where the cumulative count crosses k/buckets of the
    total, never leaving fewer groups than buckets still to fill, and no
    bucket is opened empty. Returns group-index boundaries
    [0, ..., len(group_sizes)]."""
    total = sum(group_sizes)
    buckets = max(1, min(buckets, len(group_sizes) or 1))
    bounds = [0]
    cum = 0
    acc = 0
    for i, s in enumerate(group_sizes):
        remaining_groups = len(group_sizes) - i
        remaining_buckets = buckets - len(bounds) + 1
        if (len(bounds) <= buckets - 1 and acc > 0
                and (cum >= total * len(bounds) / buckets
                     or remaining_groups <= remaining_buckets)):
            bounds.append(i)
            acc = 0
        cum += s
        acc += s
    bounds.append(len(group_sizes))
    return bounds


def flat_meta(shapes: Sequence[Sequence[int]], world: int, buckets: int = 1,
              leaf_groups: Optional[Sequence[int]] = None) -> FlatMeta:
    """The FlatMeta of leaves of ``shapes`` over ``world`` ranks in
    ``buckets`` buckets whose boundaries fall between ``leaf_groups``
    (leaves per group, e.g. per model layer; None: every leaf its own
    group). An empty bucket folds into its predecessor; one bucket is one
    tail pad."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    sizes = tuple(math.prod(s) for s in shapes)
    length = int(sum(sizes))
    if leaf_groups is None:
        leaf_groups = [1] * len(shapes)
    if sum(leaf_groups) != len(shapes):
        raise ValueError(f"leaf_groups {list(leaf_groups)} do not cover "
                         f"{len(shapes)} leaves")
    group_sizes, li = [], 0
    for g in leaf_groups:
        group_sizes.append(int(sum(sizes[li:li + g])))
        li += g
    gbounds = _bucket_bounds(group_sizes, buckets)
    leaf_starts = [0]
    for g in leaf_groups:
        leaf_starts.append(leaf_starts[-1] + g)
    bucket_leaves, bucket_padded, bucket_offsets = [], [], []
    off = 0
    for b in range(len(gbounds) - 1):
        l0, l1 = leaf_starts[gbounds[b]], leaf_starts[gbounds[b + 1]]
        blen = int(sum(sizes[l0:l1]))
        bpad = -(-blen // world) * world if blen else 0
        if bpad == 0 and bucket_leaves:
            bucket_leaves[-1] = (bucket_leaves[-1][0], l1)
            continue
        bucket_leaves.append((l0, l1))
        bucket_padded.append(bpad)
        bucket_offsets.append(off)
        off += bpad
    if not bucket_leaves:  # a model with no parameters
        bucket_leaves, bucket_padded, bucket_offsets = [(0, 0)], [0], [0]
    return FlatMeta(shapes, sizes, length, int(sum(bucket_padded)),
                    tuple(bucket_leaves), tuple(bucket_padded),
                    tuple(bucket_offsets))


def _key_part(part: str):
    return (0, int(part), "") if part.isdigit() else (1, 0, part)


def ref_param_order(model: LayerModel
                    ) -> Tuple[List[torch.nn.Parameter], List[int]]:
    """``model``'s parameters in the reference's leaf order and the leaf
    count of each layer: per layer, the dotted names (the reference's
    nested keys, convert.py) sorted part by part, a list index by its
    number."""
    params, groups = [], []
    for layer in model.layers:
        named = sorted(layer.named_parameters(),
                       key=lambda kv: tuple(map(_key_part,
                                                kv[0].split("."))))
        params += [p for _, p in named]
        groups.append(len(named))
    return params, groups


def to_ref_layout(t: torch.Tensor) -> torch.Tensor:
    """A port tensor as a view in the reference's layout: a 4-D
    convolution kernel OIHW -> HWIO, anything else as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def from_ref_layout(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_ref_layout`: HWIO -> OIHW, as a view."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def model_flat_meta(model: LayerModel, world: int,
                    buckets: int = 1) -> Tuple[FlatMeta,
                                               List[torch.nn.Parameter]]:
    """The model's layer-aligned FlatMeta and its parameters in the
    packing order."""
    params, groups = ref_param_order(model)
    shapes = [to_ref_layout(p).shape for p in params]
    return flat_meta(shapes, world, buckets, groups), params


def pack_flat(leaves: Sequence[torch.Tensor], meta: FlatMeta
              ) -> torch.Tensor:
    """The leaves (port layout) raveled in the reference's layout, bucket
    by bucket, each bucket followed by its pad zeros; float32 (float64
    for a float64 model's leaves)."""
    dtype = torch.promote_types(leaves[0].dtype, torch.float32)
    parts = []
    for (l0, l1), bpad in zip(meta.bucket_leaves, meta.bucket_padded):
        parts += [to_ref_layout(t).to(dtype).reshape(-1)
                  for t in leaves[l0:l1]]
        blen = int(sum(meta.sizes[l0:l1]))
        if bpad > blen:
            parts.append(leaves[0].new_zeros(bpad - blen, dtype=dtype))
    return torch.cat(parts)


def unpack_buckets(bucket_arrays: Sequence[torch.Tensor], meta: FlatMeta
                   ) -> List[torch.Tensor]:
    """The leaves (port layout, views) from per-bucket stretches, each
    ``bucket_padded[b]`` long: every leaf reads only its bucket's."""
    out = []
    for (l0, l1), arr in zip(meta.bucket_leaves, bucket_arrays):
        off = 0
        for i in range(l0, l1):
            out.append(from_ref_layout(
                arr[off:off + meta.sizes[i]].view(meta.shapes[i])))
            off += meta.sizes[i]
    return out


def bucket_slice(flat: torch.Tensor, meta: FlatMeta, b: int
                 ) -> torch.Tensor:
    """Bucket b's ``bucket_padded[b]`` stretch of a packed vector."""
    o = meta.bucket_offsets[b]
    return flat[o:o + meta.bucket_padded[b]]


def unpack_flat(flat: torch.Tensor, meta: FlatMeta) -> List[torch.Tensor]:
    """Inverse of :func:`pack_flat` (the pads dropped; views of ``flat``)."""
    return unpack_buckets([bucket_slice(flat, meta, b)
                           for b in range(meta.num_buckets)], meta)


def bucket_content_lengths(meta: FlatMeta) -> List[int]:
    """Each bucket's unpadded element count: a leaf-aligned meta's leaf
    sizes summed; a row meta (:func:`row_flat_meta`, no leaves) tiles the
    row [0, length), so a bucket holds its overlap with that range. In
    both ``flat = concat_b(logical[c_b:c_b + len_b] + zeros(pad_b))``,
    the invariant train/reshard.py permutes through."""
    if meta.sizes:
        return [int(sum(meta.sizes[l0:l1])) for l0, l1 in meta.bucket_leaves]
    return [max(0, min(meta.length, off + bp) - off)
            for off, bp in zip(meta.bucket_offsets, meta.bucket_padded)]


def shard_bucket_slice(shard: torch.Tensor, meta: FlatMeta, world: int,
                       b: int) -> torch.Tensor:
    """Bucket b's segment of one rank's ``padded / world`` shard (the
    concatenation of its 1/world slice of each bucket)."""
    o = meta.bucket_offsets[b] // world
    return shard[o:o + meta.bucket_padded[b] // world]


def row_flat_meta(length: int, world: int, buckets: int = 1) -> FlatMeta:
    """The FlatMeta of an already packed row of ``length`` elements (one
    pipeline chunk's parameters in the reference's leaf order, hybrid
    PP x ZeRO-1: parallel/gpipe.py) sharded 1/world a rank in ``buckets``
    contiguous pieces (the reference's ``row_flat_meta``). The row has no
    leaves to align to: the buckets are near-equal stretches of
    world-sized units, each a multiple of ``world`` long, the last
    padded, which is all :func:`to_device_major` and the per-bucket
    reduce-scatter and all-gather need. ``shapes`` and ``sizes`` are
    empty and ``bucket_leaves`` is (0, 0) a bucket."""
    units = -(-max(1, length) // world)
    buckets = max(1, min(buckets, units))
    base, rem = divmod(units, buckets)
    padded, offsets, off = [], [], 0
    for b in range(buckets):
        u = base + (1 if b < rem else 0)
        padded.append(u * world)
        offsets.append(off)
        off += u * world
    return FlatMeta((), (), int(length), int(off), ((0, 0),) * buckets,
                    tuple(padded), tuple(offsets))


def device_major_perm(meta: FlatMeta, world: int):
    """Index permutation ``p`` (numpy int64) with ``flat[p] ==
    to_device_major(flat)``, and its inverse."""
    parts = [np.arange(o + d * (bp // world), o + (d + 1) * (bp // world),
                       dtype=np.int64)
             for d in range(world)
             for o, bp in zip(meta.bucket_offsets, meta.bucket_padded)]
    perm = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv


def to_device_major(flat: torch.Tensor, meta: FlatMeta, world: int
                    ) -> torch.Tensor:
    """Bucket layout -> device-major layout: rank d's stretch is the
    concatenation over buckets of its 1/world slice of each (the layout a
    per-bucket reduce-scatter leaves, and the overlapped engine's params
    between steps). One bucket: the identity."""
    parts = []
    for d in range(world):
        for b in range(meta.num_buckets):
            o = meta.bucket_offsets[b]
            bl = meta.bucket_padded[b] // world
            parts.append(flat[o + d * bl:o + (d + 1) * bl])
    return torch.cat(parts) if parts else flat


def from_device_major(flat_dm: torch.Tensor, meta: FlatMeta, world: int
                      ) -> torch.Tensor:
    """Inverse of :func:`to_device_major`."""
    shard_len = meta.padded // world
    parts = []
    for b in range(meta.num_buckets):
        bo = meta.bucket_offsets[b] // world
        bl = meta.bucket_padded[b] // world
        parts += [flat_dm[d * shard_len + bo:d * shard_len + bo + bl]
                  for d in range(world)]
    return torch.cat(parts) if parts else flat_dm


# ---- the int8 wire ----------------------------------------------------------


def sum_safe_qmax(world: int) -> int:
    """The largest per-rank quantised magnitude whose sum over ``world``
    ranks fits int8 (the collective sums in int8): 127 // world."""
    if world > 127:
        raise ValueError(
            f"int8 wire supports up to 127 devices (got {world}): the "
            f"in-dtype collective sum would overflow")
    return max(1, 127 // world)


def stochastic_round_int8(v: torch.Tensor, key, qmax: int = 127
                          ) -> torch.Tensor:
    """Unbiased stochastic rounding of ``v`` (scaled into [-qmax, qmax])
    to int8: floor(v) + (u < frac(v)) with ``u`` the uniform draws of
    ``jax.random.uniform(key, v.shape)`` (ops/threefry.py, bit for bit),
    clipped at qmax against division round-off."""
    lo = torch.floor(v)
    frac = v - lo
    u = threefry.uniform(tuple(k.to(v.device) for k in key), v.shape)
    r = lo + (u < frac).float()
    return torch.clamp(r, -float(qmax), float(qmax)).to(torch.int8)


def quantize_int8(g: torch.Tensor, key, qmax: int = 127,
                  absmax: Optional[torch.Tensor] = None):
    """(q int8, scale float32): ``scale = absmax / qmax`` (1 for an
    all-zero block) and ``q`` the stochastic rounding of ``g / scale``.
    ``absmax`` defaults to ``max|g|``; dp passes the ranks' global one, so
    every rank shares the scale. Dequantise with ``q.float() * scale``."""
    if absmax is None:
        absmax = g.abs().max()
    absmax = absmax.float()
    scale = torch.where(absmax > 0, absmax / qmax,
                        torch.ones((), device=g.device))
    return stochastic_round_int8(g / scale, key, qmax), scale


def gradual_warmup_lr(scaled_lr: float, world: int, epoch0: int, step: int,
                      steps_per_epoch: int, warmup_epochs: int) -> float:
    """Goyal et al.'s gradual warmup: over the first ``warmup_epochs``
    (``epoch0`` 0-based) the lr ramps linearly, per step, from
    ``scaled_lr / world`` to the world-scaled ``scaled_lr``; untouched
    past the warmup or at world 1."""
    if epoch0 >= warmup_epochs or world <= 1:
        return scaled_lr
    frac = epoch0 + (step + 1) / max(1, steps_per_epoch)
    lr_adj = (1.0 / world) * (frac * (world - 1) / warmup_epochs + 1.0)
    return scaled_lr * lr_adj


# ---- the optimizers on tensors (dp) -----------------------------------------


def flat_optimizer(cfg: RunConfig):
    """(init, update) of cfg.resolved_optimizer() with the reference's
    ``make_optimizer`` formulas, for any tensor of parameters (a leaf, a
    slice of one, or a packed flat shard), so every dp engine runs the
    same arithmetic element for element:

    * sgd: ``g += wd * p; m = mu * m + g; p -= lr * m``;
    * adam: ``g += wd * p; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
      p -= (lr / bc1) m / (sqrt(v) / sqrt(bc2) + eps)``, the bias
      corrections ``bc = 1 - b^step`` in float32.

    Each product and sum is its own op (no fused multiply-add), so an
    element's result does not depend on which tensor it sits in; the ops
    run over the whole list at once (``torch._foreach_*``: a few launches
    for every leaf). ``init(like)`` returns the state of tensors like
    those (``m``, and for adam ``v`` and the shared ``step``);
    ``update(params, grads, state, lr)`` takes lists of tensors, updates
    ``params`` (through detached views) and ``state`` in place and returns
    (the views, the state); ``grads`` stay as they are."""
    name = cfg.resolved_optimizer()
    mom, wd = cfg.resolved_momentum(), cfg.resolved_weight_decay()
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps

    def init(like: Sequence[torch.Tensor]) -> Dict[str, Any]:
        state = {"m": [torch.zeros_like(t) for t in like]}
        if name == "adam":
            state["v"] = [torch.zeros_like(t) for t in like]
            state["step"] = 0
        return state

    def decayed(params, grads):
        if not wd:
            return list(grads)
        g = torch._foreach_mul(params, wd)  # wd * p + g: g + wd * p
        torch._foreach_add_(g, list(grads))
        return g

    def sgd(params, grads, state, lr):
        params, m = [p.detach() for p in params], state["m"]
        torch._foreach_mul_(m, mom)
        torch._foreach_add_(m, decayed(params, grads))
        torch._foreach_sub_(params, torch._foreach_mul(m, lr))
        return params, state

    def adam(params, grads, state, lr):
        params = [p.detach() for p in params]
        m, v = state["m"], state["v"]
        state["step"] += 1
        stepf = torch.tensor(float(state["step"]), dtype=torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf
        # float32 scalars, exact as Python floats
        rate, root_bc2 = (lr / bc1).item(), torch.sqrt(bc2).item()
        g = decayed(params, grads)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        denom = torch._foreach_sqrt(v)  # sqrt(v) / sqrt(bc2) + eps
        torch._foreach_div_(denom, root_bc2)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_mul(m, rate)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(params, step)
        return params, state

    return init, (sgd if name == "sgd" else adam)
