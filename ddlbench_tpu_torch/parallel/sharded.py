"""Fully sharded data parallelism, ZeRO-3 (``ddlbench_tpu/parallel/
sharded.py``'s ``FSDPStrategy``): strategy ``fsdp``.

The reference's fsdp is single's step under GSPMD with the batch and
every parameter sharded over the ranks; here it is one process per rank
on ``torch.distributed``, with the collectives written out:

* each layer's parameters are packed into one flat float32 vector
  (float64 for a float64 model; the port's layout, padded to a multiple
  of the world), and rank r keeps
  the contiguous 1/n slice r of it and the optimizer state of that slice
  only; the model's own parameter tensors are emptied;
* the forward all-gathers a layer's vector just before the layer runs,
  casts it to the compute dtype once and runs the layer on views of it
  (layers.call_layer); the gathered tensors are not kept: every tensor
  autograd saves that lies in them is saved as a note of where it lay
  (``saved_tensors_hooks``), and the backward all-gathers the layer again
  when its first node needs one, and drops it when the layer's gradient
  is done;
* the gradient of the gathered vector is reduce-scattered onto the
  shards (the backward of the all-gather), so each rank gets the sum over
  the ranks of its slice;
* the update is the reference's elementwise formulas
  (common.flat_optimizer) on the shards;
* the batch is split over the ranks (rank r's contiguous rows), each
  rank's objective is its rows' sum over the global valid count
  (common.reduce_loss_sums), and BatchNorm normalises with the global
  batch's statistics (models/layers.batch_parallel), as the reference's
  GSPMD program does; ``grad_accum_steps`` K takes every K-th local row
  a micro-step, weighted by their global valid counts, as dp does.

Every collective of the backward (the re-gathers, the reduce-scatters,
sync-BN's) comes in the order the autograd engine reaches the nodes,
which is the same on every rank: the graphs are alike. The model's
weights are broadcast from rank 0 when the strategy first takes them
(:meth:`FSDPStrategy.init`), which keeps a copy of the initial shards so
that a later ``init`` (the loop's warm-up restores the start) restarts
from them. An MoE arch is refused by RunConfig (ROADMAP A.6b), and so is
``remat_layers``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import (Comm, all_gather_grad,
                                            local_batch_slice)
from ddlbench_tpu_torch.models.layers import (LayerModel, batch_parallel,
                                             call_layer)
from ddlbench_tpu_torch.ops.fused_xent import (fused_linear_xent,
                                              fused_linear_xent_eval)
from ddlbench_tpu_torch.parallel.common import (_micro_batch, cast_input,
                                                flat_optimizer, head_fusable,
                                                logits_eval_sums,
                                                logits_loss_sums,
                                                reduce_eval_sums,
                                                reduce_loss_sums)


class FSDPStrategy:
    """strategy='fsdp' on rank ``comm.rank`` of ``comm.world`` (module
    docstring). ``model`` must already be on ``comm.device``; call
    :meth:`init` before the first step."""

    def __init__(self, model: LayerModel, cfg: RunConfig, comm: Comm):
        if comm.world != cfg.num_devices:
            raise ValueError(f"a world of {comm.world} ranks for "
                             f"num_devices={cfg.num_devices}")
        self.model = model
        self.cfg = cfg
        self.comm = comm
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.smoothing = cfg.resolved_label_smoothing()
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        n = comm.world
        self.names = [[name for name, _ in layer.named_parameters()]
                      for layer in model.layers]
        self.shapes = [[tuple(p.shape) for _, p in layer.named_parameters()]
                       for layer in model.layers]
        self.lengths = [sum(math.prod(s) for s in shapes)
                        for shapes in self.shapes]
        self.padded = [-(-length // n) * n for length in self.lengths]
        self.shards: List[torch.Tensor] = []
        self.opt = None
        self._initial: Optional[List[torch.Tensor]] = None
        self._regathered: Dict[int, torch.Tensor] = {}
        self.regathers = 0  # layers all-gathered again for a backward

    @property
    def world_size(self) -> int:
        return self.comm.world

    # -- state ---------------------------------------------------------------

    def _take_model(self) -> List[torch.Tensor]:
        """Rank 0's weights and buffers on every rank, this rank's shard
        of each layer's packed vector, the model's parameters emptied."""
        n, r = self.comm.world, self.comm.rank
        shards = []
        with torch.no_grad():
            for layer, length, padded in zip(self.model.layers,
                                             self.lengths, self.padded):
                ps = [p for _, p in layer.named_parameters()]
                dtype = (torch.promote_types(ps[0].dtype, torch.float32)
                         if ps else torch.float32)
                flat = torch.zeros(padded, dtype=dtype,
                                   device=self.comm.device)
                if ps:
                    flat[:length] = torch.cat(
                        [p.detach().reshape(-1) for p in ps])
                if padded:
                    flat = self.comm.broadcast(flat)
                per = padded // n
                shards.append(flat[r * per:(r + 1) * per].clone())
                for p in ps:
                    p.data = p.data.new_empty(0)
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            if bufs:
                cat = self.comm.broadcast(
                    torch.cat([b.reshape(-1).double() for b in bufs]))
                off = 0
                for b in bufs:
                    b.copy_(cat[off:off + b.numel()].view_as(b))
                    off += b.numel()
        return shards

    def init(self) -> None:
        """The shards (from the model's weights on the first call, from
        the copy kept of those since) and fresh optimizer state for them."""
        if self._initial is None:
            self._initial = self._take_model()
        self.shards = [s.clone().requires_grad_() for s in self._initial]
        self.opt = self._opt_init([s.detach() for s in self.shards])

    def param_bytes(self) -> int:
        """The bytes of parameters this rank holds (its shards)."""
        return sum(s.numel() * s.element_size() for s in self.shards)

    def opt_state_bytes(self) -> int:
        """The bytes of optimizer-state tensors this rank holds."""
        return sum(t.numel() * t.element_size()
                   for key in ("m", "v") for t in self.opt.get(key, ()))

    def _views(self, i: int, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, shape in zip(self.names[i], self.shapes[i]):
            size = math.prod(shape)
            out[name] = flat[off:off + size].view(shape)
            off += size
        return out

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by "<layer>.<name>": each layer
        all-gathered (a collective every rank calls)."""
        out = {}
        with torch.no_grad():
            for i, shard in enumerate(self.shards):
                if not self.lengths[i]:
                    continue
                full = self.comm.all_gather(shard.detach())
                out.update({f"{i}.{n}": t for n, t in
                            self._views(i, full).items()})
        return out

    # -- the layer-by-layer apply --------------------------------------------

    def _cast(self, full: torch.Tensor) -> torch.Tensor:
        return full.to(self.compute_dtype)

    def _regather(self, i: int) -> torch.Tensor:
        """Layer i's cast vector for its backward, gathered on the first
        call of the layer's backward and kept until the layer's gradient
        is reduce-scattered."""
        if i not in self._regathered:
            self.regathers += 1
            with torch.no_grad():
                self._regathered[i] = self._cast(
                    self.comm.all_gather(self.shards[i].detach()))
        return self._regathered[i]

    def _hooks(self, i: int, cast: torch.Tensor):
        """Saved-tensor hooks that save any tensor lying in ``cast`` (layer
        i's gathered weights) as its place in it, and rebuild it from the
        re-gathered vector in the backward."""
        ptr = cast.untyped_storage().data_ptr()

        def pack(t):
            if t.numel() and t.untyped_storage().data_ptr() == ptr:
                return (i, t.size(), t.stride(), t.storage_offset())
            return t

        def unpack(obj):
            if not isinstance(obj, tuple):
                return obj
            i_, size, stride, offset = obj
            return self._regather(i_).as_strided(size, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def _layer_params(self, i: int):
        # the backward reduce-scatters the gradient onto the shard, then
        # drops the layer's re-gathered copy
        full = all_gather_grad(self.shards[i], self.comm,
                               functools.partial(self._regathered.pop, i,
                                                 None))
        cast = self._cast(full)
        return cast, self._views(i, cast)

    def _run(self, i: int, x: torch.Tensor, method: str = "forward"):
        if not self.lengths[i]:  # no parameters: nothing to gather
            return call_layer(self.model.layers[i], None, x, method)
        cast, params = self._layer_params(i)
        with self._hooks(i, cast):
            return call_layer(self.model.layers[i], params, x, method)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.model.layers) - 1):
            x = self._run(i, x)
        return x

    def _loss_sums(self, x: torch.Tensor, y: torch.Tensor):
        """(obj_sum, ce_sum, correct, valid) over this rank's rows, train
        mode: the fused head where enabled, else the logits."""
        self.model.train()
        h = self._body(cast_input(x, self.compute_dtype))
        last = len(self.model.layers) - 1
        if self.cfg.fused_head_loss and head_fusable(self.model):
            cast, params = self._layer_params(last)
            with self._hooks(last, cast):
                rows, w = call_layer(self.model.layers[last], params, h,
                                     "fused_parts")
                obj_sum, ce_sum, correct = fused_linear_xent(
                    rows, w, y.reshape(-1), self.smoothing)
            return obj_sum, ce_sum, correct, (y >= 0).sum()
        return logits_loss_sums(self._run(last, h), y, self.smoothing)

    # -- the step ------------------------------------------------------------

    def _micro_step(self, x, y):
        obj, ce, correct, valid = reduce_loss_sums(
            self.comm, *self._loss_sums(x, y))
        grads = torch.autograd.grad(obj, self.shards, allow_unused=True,
                                    materialize_grads=True)
        return ce, correct, valid, grads

    def reduced_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The step's forward and backward on the global batch (x, y),
        without the update: (metrics, this rank's shard of each layer's
        gradient, summed over the ranks)."""
        rows = local_batch_slice(x.shape[0], self.comm.rank, self.comm.world)
        x, y = x[rows], y[rows]
        K = self.cfg.grad_accum_steps
        with batch_parallel(self.comm):
            if K == 1:
                ce, correct, valid, grads = self._micro_step(x, y)
            else:
                if x.shape[0] % K:
                    raise ValueError(f"local batch {x.shape[0]} not "
                                     f"divisible by grad_accum_steps {K}")
                gsum, ces, wks, correct, valid = None, [], [], 0, 0
                for k in range(K):
                    ce_k, c, v, g = self._micro_step(_micro_batch(x, K, k),
                                                     _micro_batch(y, K, k))
                    wk = v.float()
                    gsum = ([wk * t for t in g] if gsum is None
                            else [a + wk * t for a, t in zip(gsum, g)])
                    ces.append(ce_k)
                    wks.append(wk)
                    correct, valid = correct + c, valid + v
                wks = torch.stack(wks)
                total = wks.sum().clamp(min=1.0)
                ce = (torch.stack(ces) * wks).sum() / total
                grads = [t / total for t in gsum]
        self._regathered.clear()
        return {"loss": ce, "accuracy": correct.float()
                / valid.clamp(min=1).float()}, list(grads)

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on the global batch (x, y) at learning rate ``lr``;
        returns {"loss": the unsmoothed global CE, "accuracy": global
        top-1 over valid labels}, equal on every rank."""
        metrics, grads = self.reduced_grads(x, y)
        with torch.no_grad():
            shards = [s.detach() for s in self.shards]
            new, self.opt = self._opt_update(shards, grads, self.opt, lr)
            torch._foreach_copy_(shards, new)
        return metrics

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eval step's {loss, correct, correct5, count} over the global
        batch: each rank's rows' sums, all-reduced."""
        rows = local_batch_slice(x.shape[0], self.comm.rank, self.comm.world)
        x, y = x[rows], y[rows]
        self.model.eval()
        last = len(self.model.layers) - 1
        with torch.no_grad():
            h = self._body(cast_input(x, self.compute_dtype))
            if self.cfg.fused_head_loss and head_fusable(self.model):
                _, params = self._layer_params(last)
                rows_, w = call_layer(self.model.layers[last], params, h,
                                      "fused_parts")
                sums = fused_linear_xent_eval(rows_, w, y.reshape(-1))
            else:
                sums = logits_eval_sums(self._run(last, h), y)
        return reduce_eval_sums(self.comm, *sums)
