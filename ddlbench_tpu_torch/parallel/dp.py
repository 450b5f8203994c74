"""Data-parallel strategy of the port (``ddlbench_tpu/parallel/dp.py``) on
``torch.distributed``.

One process per rank (distributed.py), each holding the whole model. A
step takes the global batch, keeps the rank's contiguous rows
(``local_batch_slice``), and with ``grad_accum_steps`` K > 1 micro-step k
takes every K-th of those rows, as the reference's sharded batch does.
Every rank builds the model from ``cfg.seed`` and rank 0 broadcasts it
(the reference's broadcast-init). BatchNorm's statistics are the global
batch's in every engine (models/layers.batch_parallel): the reference gets
sync-BN from GSPMD in every dp mode.

The loss a rank differentiates is its rows' sum over the global count of
valid labels (one all-reduce before the backward), so the ranks'
gradients sum to the global mean's; the metrics are all-reduced sums. The
gradients are packed into the reference's flat layout (parallel/common.py
``FlatMeta``: leaf order, convolution kernels as HWIO, layer-aligned
buckets padded to the world) and reduced once per micro-step, after the
backward (no hook overlaps a collective with the backward):

* the replicated engine (the default; the reference's GSPMD path): one
  all-reduce per bucket, then the reference's update formulas
  (``flat_optimizer``) on the packed float32 parameters, which every
  rank keeps and copies into the model. With ``shard_opt_state`` each rank
  keeps the optimizer state of a 1/world slice of each leaf along the
  reference's ``_leaf_spec`` dimension, updates that slice and all-gathers
  the leaf back: the same arithmetic, element for element;
* ``dp_shard_update`` (ZeRO-1): one reduce-scatter per bucket, so each
  rank holds its 1/world slice of every bucket (the device-major shard),
  updates its shard of the packed params with a shard of flat optimizer
  state, and all-gathers the buckets back;
* the overlapped engine (``dp_shard_update`` with ``comm_buckets`` > 1):
  the params stay sharded between steps, and each bucket is all-gathered
  into the model before the forward;
* ``allreduce_dtype`` bf16: the gradient is cast before its collective and
  summed in bf16; int8: per bucket a global absmax (an all-reduce MAX),
  the shared scale ``absmax / (127 // world)``, stochastic rounding keyed
  ``fold_in(fold_in(fold_in(key(seed), 0x1A8), qstep), rank)``, then
  ``fold_in(k)`` per micro-step and ``fold_in(b)`` per bucket (the
  reference's threefry bits, ops/threefry.py), the collective in int8,
  and dequantisation; ``qstep`` counts steps in the optimizer state.

An MoE arch (the replicated engine only: the explicit ones refuse it,
as the reference does) routes over the global batch
(models/moe.global_routing): the capacity, each token's place in its
expert's queue and the aux loss are the global batch's (or the global
micro-batch's under accumulation), and each rank adds ``moe_aux_weight``
x that aux to its objective whole (common.reduce_loss_sums,
``aux_global``): its gradient reaches the rank's own tokens only, so the
summed gradients are the global objective's, single's on the global
batch.

Every engine's update is the same elementwise arithmetic and only the
collectives differ, so the f32 sharded and overlapped engines equal the
replicated one bit for bit wherever their collectives sum in the same
order (any two ranks do).

``elastic_slices`` E (the reference's world-invariant numerics, on the
ZeRO-1 engines, f32 wire, no BatchNorm): the gradients are taken in E
fixed contiguous slices of the global batch, E/world a rank, each
slice's objective its sum over the global valid count (an integer
all-reduce, exact in any order); a rank stacks its slices' packed
gradients and CE sums and folds them pairwise, then a recursive-doubling
butterfly (distributed.butterfly_sum) sums across the ranks. The two
halves make one balanced binary tree over the E slices whose shape
depends on E alone, so the losses, the gradient and the update are the
same bits at any world that divides E: a run saved at world N and resumed
at world M (train/reshard.py) replays the uninterrupted one. Each rank
then takes its device-major shard of the full reduced vector. Eval sums
its slices on the same tree. It is an exact-replay mode, not a fast
path: the butterfly ships log2(world) whole vectors.

The train state for checkpoints (:meth:`DPStrategy.checkpoint_state`,
parallel/state.py) is the reference's: the parameters per leaf (the
overlapped engine's as the device-major flat vector), and the optimizer
state per leaf, or under ZeRO-1 as the flat vector, the ranks' shards
concatenated.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import (Comm, butterfly_sum,
                                            local_batch_slice)
from ddlbench_tpu_torch.models.layers import LayerModel, batch_parallel
from ddlbench_tpu_torch.models.moe import aux_losses, global_routing
from ddlbench_tpu_torch.ops import threefry
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.common import (
    _micro_batch, bucket_slice, flat_meta, flat_optimizer, from_ref_layout,
    local_eval_sums, local_loss_sums, model_flat_meta, pack_flat,
    quantize_int8, ref_param_order, reduce_eval_sums, reduce_loss_sums,
    shard_bucket_slice, sum_safe_qmax, to_ref_layout, unpack_buckets,
    unpack_flat)

WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}
INT8_TAG = 0x1A8  # the reference's int8 rounding-stream tag


def leaf_spec_dim(shape, world: int) -> Optional[int]:
    """The dimension ``shard_opt_state`` slices a leaf of ``shape`` (the
    reference's layout) along: the reference's ``_leaf_spec`` with
    ``prefer_last=False``, the largest dimension the world divides (the
    first of equal ones); None where none does (the state stays whole)."""
    best = None
    for d, n in enumerate(shape):
        if n % world == 0 and n >= world and (best is None
                                              or n > shape[best]):
            best = d
    return best


class DPStrategy:
    """strategy='dp' on rank ``comm.rank`` of ``comm.world``. ``model`` must
    already be on ``comm.device``; call :meth:`init` before the first
    step."""

    def __init__(self, model: LayerModel, cfg: RunConfig, comm: Comm):
        if comm.world != cfg.num_devices:
            raise ValueError(f"a world of {comm.world} ranks for "
                             f"num_devices={cfg.num_devices}")
        self.model = model
        self.cfg = cfg
        self.comm = comm
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.smoothing = cfg.resolved_label_smoothing()
        self.shard_update = cfg.dp_shard_update
        self.wire = cfg.resolved_allreduce_dtype()
        self.int8 = self.wire == "int8"
        self.explicit = cfg.dp_explicit_collectives()
        self.overlap = cfg.dp_overlap_engine()
        self.meta, self.params = model_flat_meta(model, comm.world,
                                                 cfg.comm_buckets)
        self.elastic = cfg.elastic_slices
        if self.elastic and any(True for _ in model.buffers()):
            raise NotImplementedError(
                "elastic_slices (world-invariant reduction order) supports "
                "stateless (non-BN) models: batch statistics computed over "
                "per-slice sub-batches cannot be made world-invariant "
                f"({model.name} carries model state)")
        self.qmax = sum_safe_qmax(comm.world) if self.int8 else None
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        self.opt: Optional[Dict] = None
        # the packed parameters the update runs on (float32, or float64 for
        # a float64 model): the whole vector (replicated), this rank's
        # device-major shard (sharded update), or None (shard_opt_state:
        # per leaf)
        self.flat: Optional[torch.Tensor] = None

    # -- the reference's introspection --------------------------------------

    @property
    def world_size(self) -> int:
        return self.comm.world

    @property
    def wire_dtype(self) -> str:
        return self.wire

    @property
    def _flat_meta(self):
        """The packed layout of the explicit engine (None for the
        replicated one, as the reference's GSPMD path has none)."""
        return self.meta if self.explicit else None

    def flat_meta_for_world(self, world: int, buckets: int):
        """The packed layout this model would have at another world size
        (train/reshard.py permutes an elastic checkpoint through it)."""
        _, groups = ref_param_order(self.model)
        return flat_meta(self.meta.shapes, world, max(1, buckets), groups)

    # -- state ---------------------------------------------------------------

    def _broadcast_model(self) -> None:
        """Rank 0's parameters and buffers on every rank, one collective
        each for the packed parameters and the buffers."""
        with torch.no_grad():
            self._load(unpack_flat(self.comm.broadcast(
                pack_flat(self.params, self.meta)), self.meta))
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            if bufs:
                cat = self.comm.broadcast(
                    torch.cat([b.reshape(-1).double() for b in bufs]))
                off = 0
                for b in bufs:
                    b.copy_(cat[off:off + b.numel()].view_as(b))
                    off += b.numel()

    def _shard_of(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's device-major shard of a bucket-layout vector."""
        n, r = self.comm.world, self.comm.rank
        return torch.cat([
            bucket_slice(flat, self.meta, b)[
                r * self.meta.bucket_padded[b] // n:
                (r + 1) * self.meta.bucket_padded[b] // n]
            for b in range(self.meta.num_buckets)])

    def init(self) -> None:
        """Broadcast the model from rank 0, pack its parameters and start
        fresh optimizer state for them: on the packed vector, 1/world of
        it per rank under the sharded update, per leaf slice with
        shard_opt_state."""
        self._broadcast_model()
        with torch.no_grad():
            flat = pack_flat(self.params, self.meta)
            if self.shard_update:
                self.flat = self._shard_of(flat)
            elif self.cfg.shard_opt_state:
                self.flat = None
            else:
                self.flat = flat
            self.opt = self._opt_init(
                [self.flat] if self.flat is not None else
                [self._state_slice(p) for p in self.params])
        if self.int8:
            self.opt["qstep"] = 0

    def checkpoint_state(self) -> dict:
        """The train state gathered to the reference's global layout
        (module docstring; collectives every rank calls)."""
        comm, meta = self.comm, self.meta
        if self.overlap:
            params = state.gather_stack(comm, self.flat)
        else:
            params = state.leaves_ref(self.params)
        opt = state.opt_scalars(self.opt)
        for k in state.OPT_TENSOR_KEYS:
            if k not in self.opt:
                continue
            if self.shard_update:
                opt[k] = state.gather_stack(comm, self.opt[k][0])
            elif self.flat is not None:
                opt[k] = state.leaves_ref(unpack_flat(self.opt[k][0], meta))
            else:
                opt[k] = [self._whole_slice(p, s)
                          for p, s in zip(self.params, self.opt[k])]
        return {"params": params,
                "model_state": state.leaves_ref(
                    state.ref_buffers(self.model.layers)),
                "opt": opt}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`: each rank takes its
        part of the flat vectors and its slice of each leaf."""
        comm, meta = self.comm, self.meta
        with torch.no_grad():
            if self.overlap:
                state.put(self.flat, state.own_part(saved["params"], comm))
                self._gather_params()
            else:
                state.load_leaves_ref(self.params, saved["params"])
                flat = pack_flat(self.params, meta)
                if self.shard_update:
                    self.flat = self._shard_of(flat)
                elif self.flat is not None:
                    self.flat = flat
            state.load_leaves_ref(state.ref_buffers(self.model.layers),
                                  saved["model_state"])
            for k in state.OPT_TENSOR_KEYS:
                if k not in self.opt:
                    continue
                if self.shard_update:
                    state.put(self.opt[k][0],
                              state.own_part(saved["opt"][k], comm))
                elif self.flat is not None:
                    state.put(self.opt[k][0], pack_flat(
                        [from_ref_layout(t) for t in saved["opt"][k]],
                        meta))
                else:
                    for s, whole in zip(self.opt[k], saved["opt"][k]):
                        state.put(s, self._state_slice(
                            from_ref_layout(whole)))
        state.load_opt_scalars(self.opt, saved["opt"])

    def _whole_slice(self, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """shard_opt_state: the whole reference-layout leaf of parameter
        ``p`` from the ranks' slices ``s`` (its state), on the CPU."""
        d = leaf_spec_dim(tuple(to_ref_layout(p).shape), self.comm.world)
        if d is None:
            return state.host(s)
        parts = state.gather_stack(self.comm, s)
        if s.dim() == 1:
            return parts
        return torch.cat(parts.unbind(0), dim=d)

    def _state_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard_opt_state slice of leaf ``t`` (reference
        layout), or the whole leaf where no dimension divides."""
        v = to_ref_layout(t)
        d = leaf_spec_dim(tuple(v.shape), self.comm.world)
        if d is None:
            return v
        per = v.shape[d] // self.comm.world
        return v.narrow(d, self.comm.rank * per, per)

    def opt_state_bytes(self) -> int:
        """The bytes of optimizer-state tensors this rank holds."""
        return sum(t.numel() * t.element_size()
                   for key in ("m", "v") for t in self.opt.get(key, ()))

    def materialize_params(self) -> LayerModel:
        """The model with the current parameters in it: under the
        overlapped engine, the shards all-gathered into it."""
        if self.overlap:
            self._gather_params()
        return self.model

    def _load(self, leaves: List[torch.Tensor]) -> None:
        with torch.no_grad():
            torch._foreach_copy_(self.params, leaves)

    def _gather_params(self) -> None:
        """The ranks' device-major shards into the model: one all-gather
        per bucket, each leaf copied from its bucket's stretch (the
        overlapped engine does this before each forward)."""
        n = self.comm.world
        self._load(unpack_buckets([self.comm.all_gather(
            shard_bucket_slice(self.flat, self.meta, n, b))
            for b in range(self.meta.num_buckets)], self.meta))

    # -- the step ------------------------------------------------------------

    def _local_rows(self, x: torch.Tensor, y: torch.Tensor):
        rows = local_batch_slice(x.shape[0], self.comm.rank, self.comm.world)
        return x[rows], y[rows]

    def _reduce(self, gf: torch.Tensor, qkey) -> torch.Tensor:
        """A rank's packed gradient -> the summed one, float32: per bucket
        the wire-dtype cast (int8: global absmax, shared scale, stochastic
        rounding under ``fold_in(qkey, b)``) and one collective, a
        reduce-scatter (the device-major shard) or an all-reduce (the
        whole vector)."""
        comm, meta = self.comm, self.meta
        # float32 on the wire is the packed type (float64 for such a model)
        wire = gf.dtype if self.wire == "float32" else WIRE_DTYPES[self.wire]
        parts = []
        for b in range(meta.num_buckets):
            gb = bucket_slice(gf, meta, b)
            scale = None
            if self.int8:
                absmax = comm.all_reduce(gb.abs().max(), op="max")
                gw, scale = quantize_int8(
                    gb, threefry.fold_in(qkey, b), self.qmax, absmax)
            else:
                gw = gb.to(wire)
            red = (comm.reduce_scatter(gw) if self.shard_update
                   else comm.all_reduce(gw))
            red = red.to(gf.dtype)
            parts.append(red * scale if scale is not None else red)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _micro_step(self, x, y, qkey):
        """One micro-step: (global ce, global correct, global valid, the
        reduced gradient of the rows' sum over the global valid count)."""
        sums = local_loss_sums(self.model, self.cfg, x, y,
                               self.compute_dtype, self.smoothing)
        obj, ce, correct, valid = reduce_loss_sums(
            self.comm, *sums, aux=aux_losses(self.model),
            aux_weight=self.cfg.moe_aux_weight, aux_global=True)
        grads = torch.autograd.grad(obj, self.params)
        gred = self._reduce(pack_flat(grads, self.meta), qkey)
        return ce, correct, valid, gred

    def _grads(self, x, y, qkey):
        """(ce, correct, valid, reduced gradient) of the step: one
        micro-step, or K of every K-th local row weighted by their global
        valid counts (the reference's accumulation, each micro-step's
        gradient reduced)."""
        K = self.cfg.grad_accum_steps
        if K == 1:
            return self._micro_step(x, y, qkey)
        if x.shape[0] % K:
            raise ValueError(f"local batch {x.shape[0]} not divisible by "
                             f"grad_accum_steps {K}")
        gsum, ces, wks, corr, valid = None, [], [], 0, 0
        for k in range(K):
            qk = threefry.fold_in(qkey, k) if qkey is not None else None
            ce_k, c, v, g = self._micro_step(_micro_batch(x, K, k),
                                             _micro_batch(y, K, k), qk)
            wk = v.float()
            gsum = wk * g if gsum is None else gsum + wk * g
            ces.append(ce_k)
            wks.append(wk)
            corr, valid = corr + c, valid + v
        wks = torch.stack(wks)
        total = wks.sum().clamp(min=1.0)
        return (torch.stack(ces) * wks).sum() / total, corr, valid, \
            gsum / total

    def _slices(self, x: torch.Tensor, y: torch.Tensor):
        """The rank's rows as its E/world contiguous elastic slices."""
        k_local = self.elastic // self.comm.world
        return zip(x.chunk(k_local), y.chunk(k_local))

    def _tree_sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The canonical tree over the E slices: the rank's slices folded
        pairwise, then the butterfly across the ranks."""
        v = torch.stack(parts)
        while v.shape[0] > 1:
            v = v[0::2] + v[1::2]
        return butterfly_sum(v[0], self.comm)

    def _elastic_grads(self, x, y):
        """(ce, correct, valid, this rank's shard of the reduced
        gradient) with every float reduction on the canonical tree."""
        comm = self.comm
        denom = comm.all_reduce((y >= 0).sum().to(torch.int64).reshape(1))
        denom = denom[0].float().clamp(min=1.0)
        gs, ces, corr, valid = [], [], 0, 0
        for xk, yk in self._slices(x, y):
            obj_sum, ce_sum, c, v = local_loss_sums(
                self.model, self.cfg, xk, yk, self.compute_dtype,
                self.smoothing)
            grads = torch.autograd.grad(obj_sum / denom, self.params)
            gs.append(pack_flat(grads, self.meta))
            ces.append(ce_sum.detach().float())
            corr, valid = corr + c, valid + v
        g_full = self._tree_sum(gs)
        ce = self._tree_sum(ces) / denom
        ints = comm.all_reduce(torch.stack([torch.as_tensor(
            t, device=comm.device).to(torch.int64) for t in (corr, valid)]))
        return ce, ints[0], ints[1], self._shard_of(g_full)

    def _elastic_eval(self, x, y) -> Dict[str, torch.Tensor]:
        """The eval sums of the rank's slices on the canonical tree."""
        ces, ints = [], 0
        for xk, yk in self._slices(x, y):
            ce_sum, c, c5, n = local_eval_sums(self.model, self.cfg, xk, yk,
                                               self.compute_dtype)
            ces.append(ce_sum.float())
            ints = ints + torch.stack([t.to(torch.int64)
                                       for t in (c, c5, n)])
        ce = self._tree_sum(ces)
        ints = self.comm.all_reduce(ints)
        return {"loss": ce / ints[2].clamp(min=1).float(),
                "correct": ints[0], "correct5": ints[1], "count": ints[2]}

    def _update_slices(self, grads: List[torch.Tensor], lr: float) -> None:
        """shard_opt_state's update: this rank's slice of each leaf,
        all-gathered back."""
        ps = [self._state_slice(p) for p in self.params]
        gs = [self._state_slice(g) for g in grads]
        self._opt_update(ps, gs, self.opt, lr)  # ps: views of the leaves
        n = self.comm.world
        with torch.no_grad():
            for p, s in zip(self.params, ps):
                v = to_ref_layout(p)
                d = leaf_spec_dim(tuple(v.shape), n)
                if d is None:  # the whole leaf, updated in place
                    continue
                parts = self.comm.all_gather(s.contiguous()).view(n, *s.shape)
                v.copy_(torch.cat(parts.unbind(0), dim=d))

    def reduced_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The step's forward, backward and gradient collectives on the
        global batch (x, y), without the update: (metrics, the reduced
        flat gradient: the whole vector, or this rank's device-major
        shard under the sharded update)."""
        x, y = self._local_rows(x, y)
        qkey = None
        if self.int8:
            qkey = threefry.fold_in(threefry.fold_in(threefry.fold_in(
                threefry.prng_key(self.cfg.seed), INT8_TAG),
                self.opt["qstep"]), self.comm.rank)
        if self.overlap:
            self._gather_params()
        if self.elastic:
            ce, correct, valid, gred = self._elastic_grads(x, y)
        else:
            with batch_parallel(self.comm), global_routing(self.comm):
                ce, correct, valid, gred = self._grads(x, y, qkey)
        return {"loss": ce.detach(),
                "accuracy": correct.float() / valid.clamp(min=1).float()}, \
            gred

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on the global batch (x, y) at learning rate ``lr``;
        returns {"loss": the unsmoothed global CE, "accuracy": global
        top-1 over valid labels}, equal on every rank."""
        metrics, gred = self.reduced_grads(x, y)
        qstep = self.opt.pop("qstep", None)
        with torch.no_grad():
            if self.flat is None:
                self._update_slices(unpack_flat(gred, self.meta), lr)
            else:
                self._opt_update([self.flat], [gred], self.opt, lr)
                if not self.shard_update:
                    self._load(unpack_flat(self.flat, self.meta))
                elif not self.overlap:
                    self._gather_params()
        if qstep is not None:  # advanced after the update, as the reference
            self.opt["qstep"] = qstep + 1
        return metrics

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eval step's {loss, correct, correct5, count} over the global
        batch: each rank's rows' sums, all-reduced."""
        self.materialize_params()
        x, y = self._local_rows(x, y)
        if self.elastic:
            return self._elastic_eval(x, y)
        with global_routing(self.comm):
            sums = local_eval_sums(self.model, self.cfg, x, y,
                                   self.compute_dtype)
        return reduce_eval_sums(self.comm, *sums)
