"""Activation/gradient logger of the port (the reference's
``profiler/actlog.py``, its torchlogger analog).

Every ``freq_epochs`` epochs, for the first ``steps_per_epoch`` steps,
one extra forward and backward of the model on the step's batch records
each layer's output activation and the loss gradient with respect to it,
written as one ``.npz`` per (epoch, step) under ``log_dir`` with the
reference's keys: ``loss``, ``act_{i:02d}_{name}`` and
``grad_{i:02d}_{name}`` (the layer names of profiler/profile.layer_names),
float32 arrays in the reference's layout (an image map NHWC).

The reference takes the gradients through zero taps added to each layer
output; here ``torch.autograd.grad`` of the loss with respect to the
layer outputs themselves gives the same values without changing any.
The loss is the one training optimizes (label-smoothed CE over the full
logits plus the weighted MoE router aux loss). The capture changes
nothing of the run: BatchNorm normalises with the batch statistics and
leaves its running statistics alone (``frozen_batch_stats``, as the
reference's functional capture discards its new state), and no ``.grad``
is written.

The capture needs the whole model in this process: ``single``, ``dp``
and ``sp`` (their parameters are replicated); the loop skips the
others, saying so.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ddlbench_tpu_torch.models.layers import (LayerModel, apply_chunk,
                                              frozen_batch_stats)
from ddlbench_tpu_torch.models.moe import aux_losses
from ddlbench_tpu_torch.parallel.common import cast_input, cross_entropy_loss
from ddlbench_tpu_torch.profiler.profile import layer_names


def capture(model: LayerModel, compute_dtype, aux_weight: float,
            smoothing: float, x: torch.Tensor, y: torch.Tensor):
    """(loss, [activation per layer], [dLoss/d(activation) per layer])."""
    h = cast_input(x, compute_dtype)
    acts = []
    was = model.training
    model.train()
    try:
        with torch.enable_grad(), frozen_batch_stats():
            for layer in model.layers:
                h = apply_chunk([layer], h, compute_dtype)
                acts.append(h)
            loss = cross_entropy_loss(h, y, smoothing)
            aux = aux_losses(model)
            if aux:
                loss = loss + aux_weight * sum(aux)
            grads = torch.autograd.grad(loss, acts)
    finally:
        model.train(was)
    return loss.detach(), [a.detach() for a in acts], list(grads)


def _ref_layout(t: torch.Tensor) -> np.ndarray:
    """float32 on the host, an image map in the reference's NHWC order."""
    t = t.float().cpu()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


class ActivationLogger:
    """Writes per-layer activations/gradients to ``dir/epoch{E}/step{S}.npz``."""

    def __init__(self, log_dir: str, model: LayerModel, compute_dtype,
                 freq_epochs: int = 1, steps_per_epoch: int = 1,
                 moe_aux_weight: float = 0.0, label_smoothing: float = 0.0,
                 write: bool = True):
        self.log_dir = log_dir
        self.write = write  # False on ranks other than 0: nothing logged
        self.model = model
        self.compute_dtype = compute_dtype
        self.freq = max(1, freq_epochs)
        self.steps = max(1, steps_per_epoch)
        self.aux_weight = moe_aux_weight
        self.smoothing = label_smoothing
        self._names = [f"{i:02d}_{re.sub(r'[^A-Za-z0-9_]+', '_', name)}"
                       for i, name in enumerate(layer_names(model))]

    def should_log(self, epoch: int, step: int) -> bool:
        # epochs are 1-based; "every freq epochs" starts at the first epoch
        return (epoch - 1) % self.freq == 0 and step < self.steps

    def log(self, epoch: int, step: int, x: torch.Tensor,
            y: torch.Tensor) -> Optional[str]:
        """Capture and write one minibatch; returns the npz path (None when
        this step is not logged or this rank does not write)."""
        if not (self.write and self.should_log(epoch, step)):
            return None
        loss, acts, grads = capture(self.model, self.compute_dtype,
                                    self.aux_weight, self.smoothing, x, y)
        out: Dict[str, Any] = {"loss": np.asarray(loss.float().cpu(),
                                                  np.float32)}
        for name, a, g in zip(self._names, acts, grads):
            out[f"act_{name}"] = _ref_layout(a)
            out[f"grad_{name}"] = _ref_layout(g)
        d = os.path.join(self.log_dir, f"epoch{epoch}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"step{step}.npz")
        np.savez_compressed(path, **out)
        return path
