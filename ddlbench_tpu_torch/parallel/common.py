"""Shared train-step machinery of the port: loss, metrics, optimizers.

The port of the one-apply pieces of ``ddlbench_tpu/parallel/common.py``:
the cross-entropy loss and the top-1/top-k counts, ``loss_with_moe_aux``
(the fused LM head or the full logits, plus the MoE router's aux losses,
which each MoE block records on its forward: models/moe.py), the
single-apply ``loss_and_grads``, ``eval_metrics`` (fused and logits),
``make_optimizer`` as ``torch.optim.SGD`` / ``torch.optim.Adam``, whose
update rules the reference reimplements (``tests/test_optimizers.py`` pins
them equal), the step-decay learning rate (``step_decay_lr``) and ``cast_input``.

The model is applied on compute-dtype casts of its float32 parameters
(models/layers.apply_slice) and of a floating-point input (images); the
logits loss upcasts the logits to float32, the fused head
(ops/fused_xent.py) computes in float32 without them. The loss applies the
model in train mode (BatchNorm normalises with the batch statistics and
updates its running ones), the eval metrics in eval mode. Metrics stay
tensors: nothing here waits for the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import (LayerModel, apply_model,
                                             apply_slice)
from ddlbench_tpu_torch.models.moe import aux_losses


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
    h = apply_slice(model.layers[:-1], x, compute_dtype)
    return model.layers[-1].fused_eval(h, y)


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


def make_optimizer(cfg: RunConfig,
                   params: List[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """cfg.resolved_optimizer() over ``params``, torch semantics:

    * "sgd": buf = mu*buf + (grad + wd*p); p -= lr*buf;
    * "adam": L2 weight decay (added to the gradient), betas and eps from
      cfg.

    The learning rate is set per step (SingleStrategy.train_step)."""
    name = cfg.resolved_optimizer()
    lr, wd = cfg.resolved_lr(), cfg.resolved_weight_decay()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.resolved_momentum(),
                               weight_decay=wd)
    return torch.optim.Adam(params, lr=lr,
                            betas=(cfg.adam_beta1, cfg.adam_beta2),
                            eps=cfg.adam_eps, weight_decay=wd)
