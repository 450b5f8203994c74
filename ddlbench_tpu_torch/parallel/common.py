"""Shared train-step machinery of the port: loss, metrics, optimizers.

The port of the one-apply pieces of ``ddlbench_tpu/parallel/common.py``:
the cross-entropy loss and the top-1/top-k counts, the dense non-fused
branch of ``loss_with_moe_aux``, the single-apply ``loss_and_grads``,
``eval_metrics``' logits branch, and ``make_optimizer`` as
``torch.optim.SGD`` / ``torch.optim.Adam``, whose update rules the
reference reimplements (``tests/test_optimizers.py`` pins them equal).

The model is applied on compute-dtype casts of its float32 parameters
(models/layers.apply_model); the loss upcasts the logits to float32.
Metrics stay tensors: nothing here waits for the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import LayerModel, apply_model


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over valid label positions (``labels >= 0``), in float32;
    logits [..., V], labels [...]. ``smoothing`` is GNMT-style label
    smoothing: loss_tok = (1-s)*NLL(gold) - s*mean_v(logp_v)."""
    logp = F.log_softmax(logits.float(), dim=-1)
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


def loss_with_moe_aux(model: LayerModel, x: torch.Tensor, y: torch.Tensor,
                      compute_dtype: torch.dtype, smoothing: float = 0.0,
                      remat: bool = False):
    """Apply the model and return (objective, ce, (correct, valid)): the
    reference's dense, non-fused branch. The objective is the (optionally
    label-smoothed) CE; ``ce`` is the unsmoothed CE, the headline metric.
    MoE archs (whose router aux losses this would add) and the fused head
    are refused by RunConfig.validate."""
    logits = apply_model(model, x, compute_dtype, remat)
    ce = cross_entropy_loss(logits, y)
    obj = cross_entropy_loss(logits, y, smoothing) if smoothing else ce
    return obj, ce, correct_and_count(logits, y)


def loss_and_grads(model: LayerModel, cfg: RunConfig, x: torch.Tensor,
                   y: torch.Tensor, compute_dtype: torch.dtype,
                   smoothing: float):
    """One-apply training loss and gradients: returns (ce, (correct,
    valid), grads), ``grads`` one tensor per ``model.parameters()`` (also
    left in each parameter's ``.grad``)."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    obj, ce, stats = loss_with_moe_aux(model, x, y, compute_dtype, smoothing,
                                       cfg.remat_layers)
    obj.backward()
    return ce.detach(), stats, [p.grad for p in params]


def eval_metrics(model: LayerModel, x: torch.Tensor, y: torch.Tensor,
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The eval step's {loss, correct, correct5, count} through the full
    logits (the reference's non-fused branch)."""
    with torch.no_grad():
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
