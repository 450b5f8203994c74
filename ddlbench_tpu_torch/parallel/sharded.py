"""Fully sharded data parallelism, ZeRO-3, and tensor parallelism
(``ddlbench_tpu/parallel/sharded.py``'s ``FSDPStrategy`` and
``TPStrategy``): strategies ``fsdp`` and ``tp``.

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
from them.

``remat_layers`` (the reference's ``jax.checkpoint`` a layer) runs each
layer through models/layers.remat_call: the forward gathers the layer
and keeps neither the gathered vector nor the layer's interior, only
its input; the backward's one re-gather of the layer (above) serves the
recompute, whose gradient of the gathered vector goes back through the
forward's gather node (the reduce-scatter). A step gathers each layer
as often as without remat (:attr:`FSDPStrategy.regathers` counts the
backward's), and BatchNorm's running statistics take the first
forward's update only.

An MoE arch routes over the global batch (models/moe.global_routing:
the capacity, each token's place in its expert's queue and the aux
loss are the global batch's, as the reference's GSPMD program routes);
each rank's aux term is the global aux whose gradient reaches its own
tokens' probabilities, so the ranks' gradients sum to the global
objective's (common.reduce_loss_sums, ``aux_global``).

The reference's tp is single's step under GSPMD with the batch
replicated and every parameter sharded on its last divisible dimension
(``_leaf_spec(prefer_last=True)``), GSPMD deriving the collectives.
:class:`TPStrategy` runs single's step on the whole batch on every rank,
with the layout written out so that each rank holds as many elements of
each leaf as the reference's shard does:

* every dense transformer block holds the rank's Megatron slice
  (models/transformer.slice_block: its heads' columns of ``wqkv`` and
  rows of ``wo``, its columns of ``w1``/``b1`` and rows of ``w2``) and
  runs it under models/transformer.tensor_parallel, which sums the two
  row-parallel products over the ranks;
* every other leaf (LayerNorms, ``b2``, embeddings, the head, MoE blocks,
  every leaf of an image arch) is split on the dimension
  ``_leaf_spec(prefer_last=True)`` picks in the reference's layout, the
  rank keeping its contiguous 1/n of that dimension, and gathered on use
  through fsdp's machinery above (the gather, the saved-tensor notes, the
  re-gather in the backward). Every rank computes the same gradient for
  such a leaf (the batch and the activations are replicated), so the
  gather's backward keeps the rank's own part and sends nothing;
* a leaf with no divisible dimension stays whole on every rank;
* the loss is single's on the whole batch (an MoE arch routes it as
  single does), the update the reference's formulas on the rank's
  leaves; BatchNorm normalises with the whole batch's statistics on
  every rank, as single's does;
* ``remat_layers`` as fsdp's (above), the rank's own leaves saved as
  they are; the recompute runs the layer's row-parallel sums again, and
  only the recompute's graph is backpropagated (the first forward keeps
  none), so no gradient is summed twice.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch

import contextlib

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import (Comm, all_gather_grad,
                                            local_batch_slice)
from ddlbench_tpu_torch.models.layers import (LayerModel, batch_parallel,
                                             call_layer, remat_call)
from ddlbench_tpu_torch.models.moe import aux_losses, global_routing
from ddlbench_tpu_torch.models.transformer import (TP_SLICED_KEYS,
                                                   slice_block,
                                                   tensor_parallel,
                                                   tp_merge_layer_params,
                                                   tp_split_layer_params)
from ddlbench_tpu_torch.ops.fused_xent import (fused_linear_xent,
                                              fused_linear_xent_eval)
from ddlbench_tpu_torch.parallel import state
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

    def checkpoint_state(self) -> dict:
        """The train state (parallel/state.py): every tensor a rank
        trains (fsdp: each layer's shard of its packed vector, so the
        concatenation is the whole padded vector; tp: its parts of the
        gathered leaves and its own leaves) and its optimizer state, the
        ranks' parts stacked; the BatchNorm statistics (collectives every
        rank calls)."""
        return {"params": state.rank_parts(self.comm, self._trainable()),
                "model_state": state.leaves_ref(
                    state.ref_buffers(self.model.layers)),
                "opt": state.opt_rank_parts(self.comm, self.opt)}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`, in place."""
        state.load_rank_parts(self.comm, self._trainable(), saved["params"])
        state.load_leaves_ref(state.ref_buffers(self.model.layers),
                              saved["model_state"])
        state.load_opt_rank_parts(self.comm, self.opt, saved["opt"])

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

    def _cast(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """Layer i's gathered vector as the one tensor its weights are
        views of, in the compute dtype."""
        return full.to(self.compute_dtype)

    def _regather(self, i: int) -> torch.Tensor:
        """Layer i's cast vector for its backward, gathered on the first
        call of the layer's backward and kept until the layer's gradient
        is reduce-scattered."""
        if i not in self._regathered:
            self.regathers += 1
            with torch.no_grad():
                self._regathered[i] = self._cast(
                    i, self.comm.all_gather(self.shards[i].detach()))
        return self._regathered[i]

    def _hooks(self, i: int, cast: torch.Tensor):
        """Saved-tensor hooks that save any tensor lying in ``cast`` (layer
        i's gathered weights) as its place in it, and rebuild it from the
        re-gathered vector in the backward."""
        if cast is None:  # nothing gathered
            return contextlib.nullcontext()
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

    _replicated = False  # the gather's backward: reduce-scatter

    def _layer_params(self, i: int):
        # the backward reduce-scatters the gradient onto the shard, then
        # drops the layer's re-gathered copy
        full = all_gather_grad(self.shards[i], self.comm,
                               functools.partial(self._regathered.pop, i,
                                                 None), self._replicated)
        cast = self._cast(i, full)
        return cast, self._views(i, cast)

    def _run(self, i: int, x: torch.Tensor, method: str = "forward"):
        if self.cfg.remat_layers and method == "forward":
            return self._remat_run(i, x)
        if not self.lengths[i]:  # no parameters: nothing to gather
            return call_layer(self.model.layers[i], None, x, method)
        cast, params = self._layer_params(i)
        with self._hooks(i, cast):
            return call_layer(self.model.layers[i], params, x, method)

    def _remat_tensors(self, i: int):
        """Layer i's differentiable inputs for remat_call and the map from
        them to its parameters: the gathered vector (none for a layer
        without parameters)."""
        if not self.lengths[i]:
            return [], lambda ts: None
        cast, _ = FSDPStrategy._layer_params(self, i)
        return [cast], lambda ts: self._views(i, ts[0])

    def _remat_run(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i under ``remat_layers`` (models/layers.remat_call): the
        forward gathers the layer and keeps nothing of it or of its
        interior; the backward recomputes the layer on its one re-gather
        (:meth:`_regather`, the gather a backward without remat makes),
        so a step gathers no layer more often than without. The
        recompute's
        gradient of the gathered vector goes back through the forward's
        gather node, which reduce-scatters it and drops the re-gather."""
        tensors, params_of = self._remat_tensors(i)
        layer = self.model.layers[i]
        first = ((lambda: self._regather(i)) if self.lengths[i] else None)
        return remat_call(
            lambda x, ts: call_layer(layer, params_of(ts), x), x, tensors,
            first)

    # -- how the rank's part of the batch is taken and its sums reduced -----

    def _context(self):
        """The context the step runs in: sync-BN and the MoE blocks'
        global routing over the ranks."""
        stack = contextlib.ExitStack()
        stack.enter_context(batch_parallel(self.comm))
        stack.enter_context(global_routing(self.comm))
        return stack

    def _local(self, x: torch.Tensor, y: torch.Tensor):
        rows = local_batch_slice(x.shape[0], self.comm.rank, self.comm.world)
        return x[rows], y[rows]

    def _reduce(self, sums):
        return reduce_loss_sums(self.comm, *sums,
                                aux=aux_losses(self.model),
                                aux_weight=self.cfg.moe_aux_weight,
                                aux_global=True)

    def _reduce_eval(self, sums):
        return reduce_eval_sums(self.comm, *sums)

    def _trainable(self) -> List[torch.Tensor]:
        """The tensors the gradient is taken of and the update moves."""
        return self.shards

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
        obj, ce, correct, valid = self._reduce(self._loss_sums(x, y))
        grads = torch.autograd.grad(obj, self._trainable(),
                                    allow_unused=True,
                                    materialize_grads=True)
        return ce, correct, valid, grads

    def reduced_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The step's forward and backward on the global batch (x, y),
        without the update: (metrics, this rank's shard of each layer's
        gradient, summed over the ranks)."""
        x, y = self._local(x, y)
        K = self.cfg.grad_accum_steps
        with self._context():
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
            self._opt_update([s.detach() for s in self._trainable()], grads,
                             self.opt, lr)
        return metrics

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eval step's {loss, correct, correct5, count} over the global
        batch: each rank's rows' sums, all-reduced."""
        x, y = self._local(x, y)
        self.model.eval()
        last = len(self.model.layers) - 1
        with torch.no_grad(), self._context():
            h = self._body(cast_input(x, self.compute_dtype))
            if self.cfg.fused_head_loss and head_fusable(self.model):
                _, params = self._layer_params(last)
                rows_, w = call_layer(self.model.layers[last], params, h,
                                      "fused_parts")
                sums = fused_linear_xent_eval(rows_, w, y.reshape(-1))
            else:
                sums = logits_eval_sums(self._run(last, h), y)
        return self._reduce_eval(sums)


def _leaf_dim(shape, n: int):
    """The dimension ``_leaf_spec(prefer_last=True)`` shards over n
    devices (the last one divisible by n and at least n), or None."""
    for d in range(len(shape) - 1, -1, -1):
        if shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


# the port's dimension of each dimension of a 4-D convolution kernel in the
# reference's HWIO layout (the port keeps OIHW: common.to_ref_layout)
_CONV_DIM = (2, 3, 1, 0)


class TPStrategy(FSDPStrategy):
    """strategy='tp' on rank ``comm.rank`` of ``comm.world`` (module
    docstring). ``model`` must already be on ``comm.device``; call
    :meth:`init` before the first step."""

    _replicated = True  # every rank computes the whole gradient

    def __init__(self, model: LayerModel, cfg: RunConfig, comm: Comm):
        super().__init__(model, cfg, comm)
        n = comm.world
        # per layer: the leaves gathered on use as (name, whole shape,
        # the port's dimension split, the rank's part's numel), and the
        # leaves the rank holds as they are (its Megatron slices and the
        # leaves with no divisible dimension)
        self.gathered: List[List[tuple]] = []
        self.local: List[List[str]] = []
        self.sliced: List[bool] = []  # a dense block (Megatron-sliced)
        for layer in model.layers:
            named = dict(layer.named_parameters())
            shards, _ = tp_split_layer_params(named, n)
            self.sliced.append(bool(shards[0]))
            g, loc = [], []
            for name, p in named.items():
                if shards[0] and name in TP_SLICED_KEYS:
                    loc.append(name)
                    continue
                ref = tuple(p.shape[k] for k in _CONV_DIM) if p.dim() == 4 \
                    else tuple(p.shape)
                d = _leaf_dim(ref, n)
                if d is None:
                    loc.append(name)
                else:
                    dim = _CONV_DIM[d] if p.dim() == 4 else d
                    g.append((name, tuple(p.shape), dim, p.numel() // n))
            self.gathered.append(g)
            self.local.append(loc)
        self.lengths = [sum(e[3] for e in g) for g in self.gathered]
        self.local_params: List[torch.nn.Parameter] = []

    # -- state ---------------------------------------------------------------

    def _take_model(self) -> List[torch.Tensor]:
        """Rank 0's weights and buffers on every rank, then this rank's
        Megatron slice of every dense block and its part of every gathered
        leaf (the model's own tensors of those emptied)."""
        n, r = self.comm.world, self.comm.rank
        with torch.no_grad():
            tensors = list(self.model.parameters()) + [
                b for b in self.model.buffers() if b.is_floating_point()]
            cat = self.comm.broadcast(
                torch.cat([t.reshape(-1).double() for t in tensors]))
            off = 0
            for t in tensors:
                t.copy_(cat[off:off + t.numel()].view_as(t))
                off += t.numel()
            for layer in self.model.layers:
                slice_block(layer, r, n)
            shards = []
            for layer, g in zip(self.model.layers, self.gathered):
                named = dict(layer.named_parameters())
                parts = [named[name].movedim(dim, 0).chunk(n)[r].reshape(-1)
                         for name, _, dim, _ in g]
                dtype = (torch.promote_types(named[g[0][0]].dtype,
                                             torch.float32)
                         if g else torch.float32)
                shards.append(torch.cat(parts).to(dtype) if parts else
                              torch.zeros(0, device=self.comm.device))
                for name, _, _, _ in g:
                    named[name].data = named[name].data.new_empty(0)
        return shards

    def init(self) -> None:
        """The gathered leaves' parts and the rank's own leaves (from the
        model's weights on the first call, from the copy kept of those
        since) and fresh optimizer state for them."""
        if self._initial is None:
            self._initial = self._take_model()
            self._initial_local = [
                self.model.layers[i].get_parameter(name).detach().clone()
                for i, names in enumerate(self.local) for name in names]
        self.shards = [s.clone().requires_grad_() for s in self._initial]
        self.local_params = [
            self.model.layers[i].get_parameter(name)
            for i, names in enumerate(self.local) for name in names]
        with torch.no_grad():
            for p, t in zip(self.local_params, self._initial_local):
                p.copy_(t)
        self.opt = self._opt_init([t.detach() for t in self._trainable()])

    def _trainable(self) -> List[torch.Tensor]:
        return list(self.shards) + list(self.local_params)

    def param_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._trainable())

    def param_counts(self) -> Dict[str, int]:
        """The elements this rank holds of each leaf, by
        "<layer>.<name>"."""
        out = {}
        for i, layer in enumerate(self.model.layers):
            named = dict(layer.named_parameters())
            for name in self.local[i]:
                out[f"{i}.{name}"] = named[name].numel()
            for name, _, _, numel in self.gathered[i]:
                out[f"{i}.{name}"] = numel
        return out

    def _assemble(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """The rank-major gathered vector [n x the rank's parts] of layer
        i as one vector, leaf after leaf, each leaf's parts in rank
        order."""
        n = self.comm.world
        rows = full.view(n, -1)
        out, off = [], 0
        for _, _, _, numel in self.gathered[i]:
            out.append(rows[:, off:off + numel].reshape(-1))
            off += numel
        return torch.cat(out)

    def _cast(self, i: int, full: torch.Tensor) -> torch.Tensor:
        return self._assemble(i, full).to(self.compute_dtype)

    def _views(self, i: int, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, shape, dim, numel in self.gathered[i]:
            n = self.comm.world
            moved = (shape[dim],) + tuple(s for k, s in enumerate(shape)
                                          if k != dim)
            out[name] = flat[off:off + n * numel].view(moved).movedim(0, dim)
            off += n * numel
        return out

    def _whole(self, shards, local) -> Dict[str, torch.Tensor]:
        """Every leaf whole, by "<layer>.<name>", from the rank's parts
        ``shards`` (one vector a layer, like :attr:`shards`) and ``local``
        (like :attr:`local_params`): the parts and the Megatron slices
        all-gathered (collectives every rank calls)."""
        out, n = {}, self.comm.world
        mine = iter(local)
        with torch.no_grad():
            for i in range(len(self.model.layers)):
                named = {k: next(mine).detach() for k in self.local[i]}
                if self.lengths[i]:
                    full = self.comm.all_gather(shards[i].detach())
                    named.update(self._views(i, self._assemble(i, full)))
                if self.sliced[i] and n > 1:
                    parts = {k: self.comm.all_gather(named[k].contiguous())
                             .view(n, *named[k].shape)
                             for k in TP_SLICED_KEYS}
                    named = tp_merge_layer_params(
                        [{k: t[s] for k, t in parts.items()}
                         for s in range(n)],
                        {k: v for k, v in named.items()
                         if k not in TP_SLICED_KEYS})
                out.update({f"{i}.{k}": v for k, v in named.items()})
        return out

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by "<layer>.<name>" (collectives every
        rank calls)."""
        return self._whole(self.shards, self.local_params)

    def whole_grads(self, grads) -> Dict[str, torch.Tensor]:
        """:meth:`reduced_grads`' gradients whole, by "<layer>.<name>"
        (collectives every rank calls)."""
        L = len(self.shards)
        return self._whole(grads[:L], grads[L:])

    # -- the step ------------------------------------------------------------

    def _layer_params(self, i: int):
        params = {name: self.model.layers[i].get_parameter(name)
                  .to(self.compute_dtype) for name in self.local[i]}
        if not self.lengths[i]:
            return None, params
        cast, views = super()._layer_params(i)
        params.update(views)
        return cast, params

    def _run(self, i: int, x: torch.Tensor, method: str = "forward"):
        if self.cfg.remat_layers and method == "forward":
            return self._remat_run(i, x)
        cast, params = self._layer_params(i)
        with self._hooks(i, cast):
            return call_layer(self.model.layers[i], params, x, method)

    def _remat_tensors(self, i: int):
        """The gathered vector (where the layer has one) and the rank's own
        leaves (float32 masters, cast inside the recompute)."""
        names = self.local[i]
        layer = self.model.layers[i]
        gathered, _ = super()._remat_tensors(i)
        local = [layer.get_parameter(n) for n in names]

        def params_of(ts):
            out = {n: t.to(self.compute_dtype)
                   for n, t in zip(names, ts[len(gathered):])}
            if gathered:
                out.update(self._views(i, ts[0]))
            return out

        return gathered + local, params_of

    def _context(self):
        return tensor_parallel(self.comm)

    def _local(self, x: torch.Tensor, y: torch.Tensor):
        return x, y  # the batch is replicated

    def _reduce(self, sums):
        obj_sum, ce_sum, correct, valid = sums
        denom = valid.clamp(min=1).float()
        obj = obj_sum / denom
        aux = aux_losses(self.model)
        if aux:  # summed in layer order, as single's loss adds them
            obj = obj + self.cfg.moe_aux_weight * sum(aux)
        return obj, ce_sum.detach() / denom, correct, valid

    def _reduce_eval(self, sums):
        ce_sum, correct, correct5, count = sums
        return {"loss": ce_sum / count.clamp(min=1).float(),
                "correct": correct, "correct5": correct5, "count": count}
