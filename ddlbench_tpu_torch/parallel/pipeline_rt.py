"""The event engine of the pipeline schedules
(``ddlbench_tpu/parallel/pipeline_rt.py`` ``ScheduledPipelineStrategy``):
``--pipe-schedule 1f1b | interleaved | zero-bubble | zero-bubble-h2 |
searched`` on -f gpipe.

The reference scans the timetable's half-ticks in one SPMD program; the
port walks the same table's events (partition/schedule.py
``Timetable.event_times``) in order of their start half-tick, on the
chunks' devices (parallel/gpipe.py). Three events:

* F(c, m): chunk c's forward of microbatch m, its input stashed, its
  output shipped to chunk c+1 (the last chunk adds its CE and count to
  the step's metrics);
* B(c, m): the gradient with respect to the stashed input, shipped to
  chunk c-1 — chunk c recomputed from its stash with BatchNorm's running
  statistics frozen (the reference's documented rule: B and W read the
  step-current model state);
* W(c, m): the parameter gradient, accumulated per chunk in the table's
  order.

When the table glues W to B (1f1b, interleaved: each W starts as its B
ends) one backward at the B event yields both gradients and W only
accumulates the stashed parameter gradient. Otherwise (zero-bubble,
zero-bubble-h2, searched tables that defer W) B differentiates in the
input alone, on detached parameters, and W recomputes the chunk and
differentiates in the parameters alone, at the cotangent B stashed. On
the last chunk with the fused head that split is the split of its two
backward kernels: B differentiates the head in its rows only (the dh
kernel, B5), stashing the rows' cotangent; W recomputes the chunk,
differentiates the head in its projection only (the dW kernel, B6) and
carries the stashed row cotangent through the rest of the chunk.

Every microbatch runs at the step's weights; at the end each chunk's
summed gradient is divided by M and one optimizer update runs
(parallel/common.py ``flat_optimizer``). Eval is gpipe's fill-drain.
With ``dp_replicas`` R > 1 the summed gradient is reduced over the
replicas first, then divided by R and by M in that order (the sum / R
replicated, or ZeRO-1's reduce-scatter / R under ``dp_shard_update``,
whose buckets are all-gathered before each chunk's first F event), as
gpipe's hybrid does (parallel/gpipe.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ddlbench_tpu_torch.models.layers import apply_chunk
from ddlbench_tpu_torch.ops.fused_xent import fused_linear_xent
from ddlbench_tpu_torch.parallel.common import (cast_input,
                                                fused_chunk_head_inputs)
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy, chunk_aux
from ddlbench_tpu_torch.partition.schedule import (EVENT_BWD_IN,
                                                   EVENT_BWD_W, EVENT_FWD,
                                                   Timetable, make_timetable)

_Key = Tuple[int, int]


def _grad(outputs, inputs, grad_outputs) -> List[torch.Tensor]:
    """torch.autograd.grad with zeros for the inputs the outputs do not
    reach (none at all for a chunk without parameters)."""
    if not inputs:
        return []
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(got, inputs)]


class ScheduledPipelineStrategy(GPipeStrategy):
    """The event-mode pipeline runtime (module docstring): gpipe's layout,
    devices, stage split and fill-drain eval; the train step executes
    ``cfg.pipe_schedule``'s timetable."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.schedule = self.cfg.pipe_schedule
        self.timetable = self._timetable()
        tt = self.timetable
        B_t = tt.event_times(EVENT_BWD_IN)
        W_t = tt.event_times(EVENT_BWD_W)
        self._fused_bw = all(
            W_t[k] == B_t[k] + tt.cost_of(EVENT_BWD_IN, k[0]) for k in B_t)
        events = []
        for kind in (EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W):
            events += [(h, c % self.num_stages, kind, c, m)
                       for (c, m), h in tt.event_times(kind).items()]
        # start half-tick, then device: a consumer always starts after its
        # producer, so this order is dependency-correct
        self._events = sorted(events)

    def _timetable(self) -> Timetable:
        return make_timetable(self.schedule, self.num_stages,
                              self.num_microbatches, self.vstages,
                              stash=self.cfg.zb_h2_stash,
                              search_budget=self.cfg.sched_search_budget,
                              search_seed=self.cfg.sched_search_seed)

    # -- the events ----------------------------------------------------------

    def _detached(self, c: int) -> List[dict]:
        return [{n: p.detach() for n, p in layer.named_parameters()}
                for layer in self.chunk_layers(c)]

    def _last_obj(self, c: int, x: torch.Tensor, labels: torch.Tensor,
                  params: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """The last chunk's training objective on microbatch (x, labels),
        recomputed with the running statistics frozen."""
        return self._chunk_obj(c, x, labels, params,
                               update_stats=False)["obj"]

    def _body_out(self, c: int, x: torch.Tensor,
                  params: Optional[Sequence[dict]] = None):
        """A non-last chunk recomputed (statistics frozen): its outputs
        and their seeds' aux part (the output y, then aux when the chunk
        has MoE blocks)."""
        y = apply_chunk(self.chunk_layers(c),
                        cast_input(x, self.compute_dtype),
                        self.compute_dtype, params, update_stats=False)
        aux = chunk_aux(self.chunk_layers(c))
        return y, aux

    def _seeded(self, y, aux, g_cot):
        outs, seeds = [y], [g_cot.to(y.dtype)]
        if aux is not None:
            outs.append(aux)
            seeds.append(torch.full_like(aux, self.aux_weight))
        return outs, seeds

    def _split_head(self, c: int, x: torch.Tensor, labels: torch.Tensor,
                    params: Optional[Sequence[dict]]):
        """The fused last chunk's pieces, recomputed (statistics frozen):
        (rows, projection, the normalising count, aux)."""
        rows, w = fused_chunk_head_inputs(
            self.chunk_layers(c), cast_input(x, self.compute_dtype),
            self.compute_dtype, params, update_stats=False)
        denom = (labels >= 0).sum().clamp(min=1).float()
        return rows, w, denom, chunk_aux(self.chunk_layers(c))

    def _head_obj(self, obj_sum, denom, aux):
        obj = obj_sum / denom
        return obj if aux is None else obj + self.aux_weight * aux

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One step of the timetable on the global batch (x, y) at ``lr``;
        returns {"loss": the unsmoothed CE, "accuracy": top-1 over valid
        labels}."""
        xs, ys = self.shard_batch(x, y)
        self.model.train()
        M, C = self.num_microbatches, self.num_chunks
        fused_bw = self._fused_bw
        params = [self.chunk_params(c) for c in range(C)]
        # float32 accumulators (float64 for a float64 model)
        g_acc = [[torch.zeros_like(p, dtype=torch.promote_types(
            p.dtype, torch.float32)) for p in ps] for ps in params]
        xst: Dict[_Key, torch.Tensor] = {}  # chunk inputs (c > 0)
        cot: Dict[_Key, torch.Tensor] = {}  # arrived cotangents
        gst: Dict[_Key, object] = {}  # B -> W stash
        ce_acc = correct = None
        for _h, _s, kind, c, m in self._events:
            first, last = c == 0, c == C - 1
            labels = ys[m] if last else None
            if kind == EVENT_FWD:
                self._gather(c)
                xin = xs[m] if first else xst[(c, m)]
                with torch.no_grad():
                    out = self._chunk_obj(c, xin, labels)
                if last:
                    ce_acc = out["ce"] if ce_acc is None else \
                        ce_acc + out["ce"]
                    correct = (out["correct"] if correct is None
                               else correct + out["correct"])
                else:
                    xst[(c + 1, m)] = self._send(out["y"], c + 1)
                continue
            x_st = xs[m] if first else xst[(c, m)]
            if kind == EVENT_BWD_IN:
                gx = self._b_event(c, m, x_st, labels, cot, gst, params,
                                   fused_bw)
                if gx is not None:
                    cot[(c - 1, m)] = self._send(gx, c - 1)
                continue
            # W
            if fused_bw:
                gp = gst.pop((c, m))
            else:
                gp = self._w_event(c, m, x_st, labels, gst, params)
            if gp:
                torch._foreach_add_(g_acc[c], [g.to(a.dtype) for g, a in
                                               zip(gp, g_acc[c])])
            if not first:
                xst.pop((c, m))
        self._finish_step(g_acc, lr, div=M)
        valid = sum((t >= 0).sum() for t in ys)
        loss, correct, valid, _ = self._replica_metrics(ce_acc / M, correct,
                                                        valid)
        return {"loss": loss,
                "accuracy": correct.float() / valid.clamp(min=1).float()}

    def _b_event(self, c: int, m: int, x_st: torch.Tensor,
                 labels: Optional[torch.Tensor], cot, gst, params,
                 fused_bw: bool) -> Optional[torch.Tensor]:
        """B(c, m); returns the input's cotangent (None on chunk 0)."""
        first, last = c == 0, c == self.num_chunks - 1
        xin = x_st if first else x_st.detach().requires_grad_(True)
        with torch.enable_grad():
            if fused_bw:
                # one backward: the parameter gradient waits for W
                wrt = params[c] + ([] if first else [xin])
                if last:
                    g = _grad([self._last_obj(c, xin, labels)], wrt, None)
                else:
                    outs, seeds = self._seeded(
                        *self._body_out(c, xin), cot.pop((c, m)))
                    g = _grad(outs, wrt, seeds)
                gst[(c, m)] = g[:len(params[c])]
                return None if first else g[-1]
            if not last:
                gst[(c, m)] = cot.pop((c, m))
            if first:
                # no input gradient to send: W takes the whole backward
                return None
            frozen = self._detached(c)
            if last and self.fused:
                # dh only: the projection is detached, so the head's
                # backward runs its input-gradient kernel alone
                rows, w, denom, aux = self._split_head(c, xin, labels,
                                                       frozen)
                obj_sum = fused_linear_xent(rows, w, labels.reshape(-1),
                                            self.smoothing)[0]
                g = _grad([self._head_obj(obj_sum, denom, aux)],
                          [rows, xin], None)
                gst[(c, m)] = g[0]
                return g[1]
            if last:
                return _grad([self._last_obj(c, xin, labels, frozen)],
                             [xin], None)[0]
            outs, seeds = self._seeded(*self._body_out(c, xin, frozen),
                                       gst[(c, m)])
            return _grad(outs, [xin], seeds)[0]

    def _w_event(self, c: int, m: int, x_st: torch.Tensor,
                 labels: Optional[torch.Tensor], gst,
                 params) -> List[torch.Tensor]:
        """W(c, m) of a split table: the parameter gradient at the stashed
        input (detached) and the cotangent B stashed (a single chunk,
        first and last, differentiates its whole objective here: its B
        had no input gradient to take)."""
        first, last = c == 0, c == self.num_chunks - 1
        xin = x_st.detach()
        with torch.enable_grad():
            if last and self.fused and not first:
                # dW only: the rows enter the loss detached, and their
                # cotangent from B carries through the rest of the chunk
                d_rows = gst.pop((c, m))
                rows, w, denom, aux = self._split_head(c, xin, labels, None)
                obj_sum = fused_linear_xent(rows.detach(), w,
                                            labels.reshape(-1),
                                            self.smoothing)[0]
                outs = [self._head_obj(obj_sum, denom, aux), rows]
                return _grad(outs, params[c], [None, d_rows])
            if last:
                return _grad([self._last_obj(c, xin, labels)], params[c],
                             None)
            outs, seeds = self._seeded(*self._body_out(c, xin),
                                       gst.pop((c, m)))
            return _grad(outs, params[c], seeds)
