"""The shared train and eval step of the port's sequence- and
expert-parallel strategies (``ddlbench_tpu/parallel/axis_sharded.py``).

Both are one program on one rank axis: every rank applies the model once
a step inside a context that switches it into the sharded mode
(models/transformer.sequence_parallel, models/moe.expert_parallel),
computes the local sums of the loss (parallel/common.local_loss_sums:
through the fused head B4-B6 where enabled), and reduces them as the
reference's ``fwd_local`` does (common.reduce_loss_sums): the valid count
all-reduced before the backward, the rank's objective sum over it plus
the MoE aux term over the world. The backward runs the model's own
collectives in reverse (the K/V gather's reduce-scatter, the expert
exchange), then one all-reduce sums the gradients of the replicated
parameters; a sharded
parameter's gradient (ep's experts) is the rank's own. The update is the
reference's elementwise formulas (common.flat_optimizer) on the rank's
parameters, so the optimizer state of a sharded parameter is sharded
with it.

Every rank builds the model from ``cfg.seed`` and rank 0 broadcasts the
replicated parameters and buffers (the reference's broadcast-init); the
subclass then keeps its shard of the sharded ones (:meth:`_localize`).
A subclass gives its rank's part of the batch (:meth:`_local_batch`),
its context (:meth:`_context`) and which parameters are sharded.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.moe import aux_losses
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.common import (flat_optimizer,
                                                local_eval_sums,
                                                local_loss_sums,
                                                reduce_eval_sums,
                                                reduce_loss_sums)


class AxisShardedStrategy:
    """A one-axis sharded strategy on rank ``comm.rank`` of ``comm.world``
    (module docstring). ``model`` must already be on ``comm.device``;
    call :meth:`init` before the first step."""

    def __init__(self, model: LayerModel, cfg: RunConfig, comm: Comm):
        if comm.world != cfg.num_devices:
            raise ValueError(f"a world of {comm.world} ranks for "
                             f"num_devices={cfg.num_devices}")
        self.model = model
        self.cfg = cfg
        self.comm = comm
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.smoothing = cfg.resolved_label_smoothing()
        self._check_divisibility(comm.world)
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        self.opt = None
        self.params: List[torch.nn.Parameter] = []

    # -- subclass hooks ------------------------------------------------------

    def _check_divisibility(self, n: int) -> None:
        """Raise if the model or config cannot be split n ways."""

    def _context(self):
        """The context the model runs in."""
        return contextlib.nullcontext()

    def _local_batch(self, x: torch.Tensor, y: torch.Tensor):
        raise NotImplementedError

    def _is_sharded(self, name: str) -> bool:
        """Whether the parameter of dotted ``name`` ("<layer>.<name>")
        holds this rank's shard (its gradient stays the rank's own)."""
        return False

    def _localize(self) -> None:
        """Keep this rank's shard of every sharded parameter."""

    def _gather_sharded(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of sharded parameter ``name`` from the ranks'
        shards."""
        raise NotImplementedError

    # -- state ---------------------------------------------------------------

    def _named(self):
        return [(f"{i}.{n}", p) for i, layer in enumerate(self.model.layers)
                for n, p in layer.named_parameters()]

    def init(self) -> None:
        """Rank 0's replicated parameters and floating-point buffers on
        every rank (one broadcast each), this rank's shard of the sharded
        ones, and fresh optimizer state for the rank's parameters."""
        self._localize()
        with torch.no_grad():
            rep = [p for n, p in self._named() if not self._is_sharded(n)]
            rep += [b for b in self.model.buffers() if b.is_floating_point()]
            if rep:
                cat = self.comm.broadcast(
                    torch.cat([t.reshape(-1).double() for t in rep]))
                off = 0
                for t in rep:
                    t.copy_(cat[off:off + t.numel()].view_as(t))
                    off += t.numel()
        self.params = [p for _, p in self._named()]
        self.opt = self._opt_init(self.params)

    @property
    def world_size(self) -> int:
        return self.comm.world

    def param_bytes(self) -> int:
        """The bytes of parameters this rank holds."""
        return sum(p.numel() * p.element_size() for p in self.params)

    def opt_state_bytes(self) -> int:
        """The bytes of optimizer-state tensors this rank holds."""
        return sum(t.numel() * t.element_size()
                   for key in ("m", "v") for t in self.opt.get(key, ()))

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by "<layer>.<name>" (the sharded ones
        gathered from the ranks: a collective every rank calls)."""
        return {n: (self._gather_sharded(n, p.detach())
                    if self._is_sharded(n) else p.detach())
                for n, p in self._named()}

    def checkpoint_state(self) -> dict:
        """The train state (parallel/state.py): the parameters in the
        port's layout and order, each sharded one's rank parts stacked,
        its optimizer state alike, the BatchNorm statistics (collectives
        every rank calls)."""
        sharded = [self._is_sharded(n) for n, _ in self._named()]
        return {"params": state.rank_parts(self.comm, self.params, sharded),
                "model_state": state.leaves_ref(
                    state.ref_buffers(self.model.layers)),
                "opt": state.opt_rank_parts(self.comm, self.opt, sharded)}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`, in place."""
        sharded = [self._is_sharded(n) for n, _ in self._named()]
        state.load_rank_parts(self.comm, self.params, saved["params"],
                              sharded)
        state.load_leaves_ref(state.ref_buffers(self.model.layers),
                              saved["model_state"])
        state.load_opt_rank_parts(self.comm, self.opt, saved["opt"], sharded)

    # -- the step ------------------------------------------------------------

    def reduced_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The step's forward, backward and gradient all-reduce on the
        global batch (x, y), without the update: (metrics, one gradient
        per :attr:`params`, the replicated ones summed over the ranks)."""
        xl, yl = self._local_batch(x, y)
        with self._context():
            sums = local_loss_sums(self.model, self.cfg, xl, yl,
                                   self.compute_dtype, self.smoothing)
            aux = aux_losses(self.model)
        obj, ce, correct, count = reduce_loss_sums(
            self.comm, *sums, aux=aux, aux_weight=self.cfg.moe_aux_weight)
        grads = list(torch.autograd.grad(obj, self.params))
        rep = [i for i, (n, _) in enumerate(self._named())
               if not self._is_sharded(n)]
        if rep:
            flat = self.comm.all_reduce(
                torch.cat([grads[i].reshape(-1) for i in rep]))
            off = 0
            for i in rep:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view_as(grads[i])
                off += n
        return {"loss": ce, "accuracy": correct.float()
                / count.clamp(min=1).float()}, grads

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on the global batch (x, y) at learning rate ``lr``;
        returns {"loss": the unsmoothed global CE, "accuracy": global
        top-1 over valid labels}, equal on every rank."""
        metrics, grads = self.reduced_grads(x, y)
        with torch.no_grad():
            self._opt_update(self.params, grads, self.opt, lr)
        return metrics

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eval step's {loss, correct, correct5, count} over the global
        batch: each rank's sums, all-reduced."""
        xl, yl = self._local_batch(x, y)
        with self._context():
            sums = local_eval_sums(self.model, self.cfg, xl, yl,
                                   self.compute_dtype)
        return reduce_eval_sums(self.comm, *sums)
