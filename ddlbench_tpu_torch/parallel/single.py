"""Single-device strategy of the port: one card, no collectives.

The port of ``ddlbench_tpu/parallel/single.py``. The reference jits the
whole step over an immutable TrainState; here the model's float32 master
parameters, its BatchNorm running statistics (the reference's
``model_state``) and the torch.optim state live in the strategy and are
updated in place, so ``train_step`` takes only the batch and the learning
rate. ``train_step`` applies the model in train mode, ``eval_step`` in
eval mode. The step holds no host sync: its metrics are device tensors.
With ``cfg.grad_accum_steps`` K > 1 one update averages K micro-steps
(parallel/common.py ``accum_loss_and_grads``) at the learning rate it is
given: the reference scales the rate by K only under ``dp`` with SGD.
"""

from __future__ import annotations

from typing import Dict

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.parallel.common import (eval_metrics,
                                                loss_and_grads,
                                                make_optimizer)


class SingleStrategy:
    """strategy='single'. ``model`` must already be on its device."""

    def __init__(self, model: LayerModel, cfg: RunConfig):
        self.model = model
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.smoothing = cfg.resolved_label_smoothing()
        self.opt = None

    def init(self) -> None:
        """Fresh optimizer state for the model's current parameters (the
        weights come from the model's seed, or convert.from_jax_params)."""
        self.opt = make_optimizer(self.cfg, list(self.model.parameters()))

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on batch (x, y) at learning rate ``lr``; returns
        {"loss": the unsmoothed CE, "accuracy": top-1 over valid labels}."""
        ce, (correct, valid), _ = loss_and_grads(
            self.model, self.cfg, x, y, self.compute_dtype, self.smoothing)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return {"loss": ce,
                "accuracy": correct.float() / valid.clamp(min=1).float()}

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        return eval_metrics(self.model, self.cfg, x, y, self.compute_dtype)
