"""Single-device strategy of the port: one card, no collectives.

The port of ``ddlbench_tpu/parallel/single.py``. The reference jits the
whole step over an immutable TrainState; here the model's float32 master
parameters, its BatchNorm running statistics (the reference's
``model_state``) and the optimizer state live in the strategy and are
updated in place, so ``train_step`` takes only the batch and the learning
rate. The update is the reference's formulas as separate ops, in
place (parallel/common.py ``flat_optimizer``), the one every strategy of
the port runs: on equal gradients it equals the reference's SGD bitwise and
its Adam within 2.3e-7 relative L2, where ``torch.optim``'s fused
multiply-adds land 1.3e-7 and 7.0e-6 away
(``tests/test_torch_optim_formula.py``). ``train_step`` applies the
model in train mode, ``eval_step`` in eval mode. The step holds no host
sync: its metrics are device tensors.
With ``cfg.grad_accum_steps`` K > 1 one update averages K micro-steps
(parallel/common.py ``accum_loss_and_grads``) at the learning rate it is
given: the reference scales the rate by K only under ``dp`` with SGD.
"""

from __future__ import annotations

from typing import Dict

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.common import (eval_metrics,
                                                flat_optimizer,
                                                loss_and_grads)


class SingleStrategy:
    """strategy='single'. ``model`` must already be on its device."""

    def __init__(self, model: LayerModel, cfg: RunConfig):
        self.model = model
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.smoothing = cfg.resolved_label_smoothing()
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        self.opt = None

    def init(self) -> None:
        """Fresh optimizer state for the model's current parameters (the
        weights come from the model's seed, or convert.from_jax_params)."""
        self.opt = self._opt_init([p.detach()
                                   for p in self.model.parameters()])

    def checkpoint_state(self) -> dict:
        """The train state in the reference's leaves (parallel/state.py):
        the parameters and the optimizer's ``m``/``v`` in the reference's
        leaf order and layout, the BatchNorm statistics, ``step``."""
        params = state.ref_params(self.model.layers)
        order = state.order_of(params, list(self.model.parameters()))
        return {"params": state.leaves_ref(params),
                "model_state": state.leaves_ref(
                    state.ref_buffers(self.model.layers)),
                "opt": state.opt_ref(self.opt, order)}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`, in place."""
        params = state.ref_params(self.model.layers)
        state.load_leaves_ref(params, saved["params"])
        state.load_leaves_ref(state.ref_buffers(self.model.layers),
                              saved["model_state"])
        state.load_opt_ref(self.opt, saved["opt"], state.order_of(
            params, list(self.model.parameters())))

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on batch (x, y) at learning rate ``lr``; returns
        {"loss": the unsmoothed CE, "accuracy": top-1 over valid labels}."""
        ce, (correct, valid), grads = loss_and_grads(
            self.model, self.cfg, x, y, self.compute_dtype, self.smoothing)
        self.apply_update(grads, lr)
        return {"loss": ce,
                "accuracy": correct.float() / valid.clamp(min=1).float()}

    def apply_update(self, grads, lr: float) -> None:
        """The optimizer update of the model's parameters with ``grads``
        (one per ``model.parameters()``; None for a parameter the loss
        does not reach) at learning rate ``lr``."""
        params = [p.detach() for p in self.model.parameters()]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        with torch.no_grad():
            self._opt_update(params, grads, self.opt, lr)

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        return eval_metrics(self.model, self.cfg, x, y, self.compute_dtype)
