"""Asynchronous 1F1B with weight stashing: PipeDream
(``ddlbench_tpu/parallel/pipedream.py`` ``PipeDreamStrategy``).

The reference compiles the async schedule into one SPMD program; the port
replays its events in order, as its tests' sequential simulator does
(``tests/test_pipedream.py::simulate_pipedream``), on the chunks' devices
(parallel/gpipe.py). Over C = S*V chunks (chunk c = v*S + s on device s)
and H = 2M + 2C - 2 half-ticks, at half-tick h chunk c runs

* the forward of microbatch f when :func:`fwd_mb_at` says so: warmup
  ``C-1-c`` forwards, then one forward per backward, at its newest
  weights, which it stashes in slot ``f mod min(C, M)`` of a ring beside
  its input, and updating BatchNorm's running statistics;
* the backward of microbatch b when :func:`bwd_mb_at` says so: the chunk
  recomputed from the stashed input at exactly the weights of that
  microbatch's forward (its ring slot; BatchNorm's running statistics
  frozen, the step-current ones read), then an optimizer update of the
  newest weights with that gradient — or, with ``update_interval`` K > 1,
  the gradients of K backwards averaged into one update (PipeDream's
  macrobatch; gradients left over at the step's end are dropped, as the
  reference's are).

The ring of ``min(C, M)`` versions, where backward uses exactly its
forward's weights, is the reference's documented deviation from
PipeDream's cap of 2 versions; kept. A chunk's forward and backward never
fall on one half-tick, and no event consumes an output of its own
half-tick, so the order of chunks within a half-tick does not matter.
The last chunk's loss per microbatch is its mean over valid labels
(label-smoothed as configured, plus moe_aux_weight x its MoE router
losses); each other chunk's backward is seeded with the cotangent its
successor sent and moe_aux_weight for its own router losses. Eval is
gpipe's fill-drain.

With ``dp_replicas`` R > 1 each replica walks this timetable on its
rows of every microbatch (gpipe's hybrid layout, parallel/gpipe.py), and
the gradient of every backward event is SUMMED over the replicas (the
reference's psum over 'data', PipeDream's per-stage DDP) before that
chunk's update or its macrobatch accumulation. At the step's end the
parameters, BatchNorm's running statistics and the optimizer's float
state are averaged over the replicas and its integer state (Adam's step
count) takes their max, as the reference's end-of-step pmean and pmax
do; the reported loss is the replicas' mean, ``correct`` and the valid
count their sums.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ddlbench_tpu_torch.parallel.gpipe import (GPipeStrategy, mean_over,
                                               sum_over)
from ddlbench_tpu_torch.parallel.pipeline_rt import _grad


def fwd_mb_at(s: int, S: int, M: int, h: int) -> Tuple[int, bool]:
    """(microbatch, valid) of the forward stage ``s`` of ``S`` runs at
    half-tick ``h``: warmup F(s, f) = s + f for f <= S-1-s, then the
    steady F(s, f) = s + 2f."""
    W = S - 1 - s
    f_w = h - s
    in_warm = 0 <= f_w <= W and f_w < M
    f_s = f_w // 2
    in_steady = f_w % 2 == 0 and W < f_s < M
    f = f_w if in_warm else f_s
    return min(max(f, 0), M - 1), in_warm or in_steady


def bwd_mb_at(s: int, S: int, M: int, h: int) -> Tuple[int, bool]:
    """(microbatch, valid) of the backward at half-tick ``h``:
    B(s, b) = 2b + 2S - 1 - s."""
    two_b = h - (2 * S - 1 - s)
    b = two_b // 2
    valid = two_b >= 0 and two_b % 2 == 0 and b < M
    return min(max(b, 0), M - 1), valid


class PipeDreamStrategy(GPipeStrategy):
    """strategy='pipedream' (module docstring)."""

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One async-1F1B step (M microbatch updates per chunk, or M/K) on
        the global batch (x, y) at ``lr``; returns {"loss": the mean over
        microbatches of the unsmoothed CE each forward saw, "accuracy":
        top-1 over valid labels}."""
        xs, ys = self.shard_batch(x, y)
        self.model.train()
        M, C = self.num_microbatches, self.num_chunks
        H = 2 * M + 2 * C - 2
        nslot = min(C, M)
        K = max(1, self.cfg.update_interval)
        params = [self.chunk_params(c) for c in range(C)]
        stash_p: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        stash_x: Dict[Tuple[int, int], torch.Tensor] = {}
        fwd_q: Dict[Tuple[int, int], torch.Tensor] = {}
        bwd_q: Dict[Tuple[int, int], torch.Tensor] = {}
        g_acc: List[object] = [None] * C
        loss_acc = correct = None
        for h in range(H):
            for c in range(C):
                f, valid_f = fwd_mb_at(c, C, M, h)
                if valid_f:
                    xin = xs[f] if c == 0 else fwd_q.pop((c, f))
                    stash_p[(c, f % nslot)] = [p.detach().clone()
                                               for p in params[c]]
                    if c > 0:
                        stash_x[(c, f % nslot)] = xin
                    with torch.no_grad():
                        out = self._chunk_obj(
                            c, xin, ys[f] if c == C - 1 else None)
                    if c < C - 1:
                        fwd_q[(c + 1, f)] = self._send(out["y"], c + 1)
                    else:
                        loss_acc = (out["ce"] if loss_acc is None
                                    else loss_acc + out["ce"])
                        correct = (out["correct"] if correct is None
                                   else correct + out["correct"])
                b, valid_b = bwd_mb_at(c, C, M, h)
                if not valid_b:
                    continue
                gp, gx = self._backward(c, b, xs, ys, stash_p, stash_x,
                                        bwd_q, nslot)
                if gx is not None:
                    bwd_q[(c - 1, b)] = self._send(gx, c - 1)
                gp = [g.to(torch.promote_types(g.dtype, torch.float32))
                      for g in gp]
                sum_over(self.dp_comm, gp)
                if K == 1:
                    self._update(c, gp, lr)
                    continue
                g_acc[c] = (gp if g_acc[c] is None
                            else [a + g for a, g in zip(g_acc[c], gp)])
                if (b + 1) % K == 0:
                    self._update(c, [g / K for g in g_acc[c]], lr)
                    g_acc[c] = None
        if self.dp > 1:
            self._sync_replicas()
        valid = sum((t >= 0).sum() for t in ys)
        loss, correct, valid, _ = self._replica_metrics(loss_acc / M,
                                                        correct, valid)
        return {"loss": loss,
                "accuracy": correct.float() / valid.clamp(min=1).float()}

    def _sync_replicas(self) -> None:
        """The step's end at R > 1: each chunk's parameters, BatchNorm
        statistics and float optimizer state averaged over the replicas
        (their integer state, Adam's step, is one Python count every
        replica advanced alike: its max is itself)."""
        with torch.no_grad():
            for c in range(self.num_chunks):
                floats = [p.data for p in self.chunk_params(c)] + [
                    t for k, v in self.opt[c].items() if isinstance(v, list)
                    for t in v]
                by_type: Dict[torch.dtype, list] = {}
                for t in floats:
                    by_type.setdefault(t.dtype, []).append(t)
                for ts in by_type.values():
                    mean_over(self.dp_comm, ts)
        self._sync_stats()

    def _backward(self, c: int, b: int, xs, ys, stash_p, stash_x, bwd_q,
                  nslot: int):
        """Chunk c's backward of microbatch b at its forward's weights:
        (parameter gradients, the input's cotangent or None on chunk 0)."""
        slot = b % nslot
        p_st = [t.requires_grad_(True) for t in stash_p.pop((c, slot))]
        it = iter(p_st)
        pdicts = [{n: next(it) for n, _ in layer.named_parameters()}
                  for layer in self.chunk_layers(c)]
        first, last = c == 0, c == self.num_chunks - 1
        xin = (xs[b] if first
               else stash_x.pop((c, slot)).detach().requires_grad_(True))
        wrt = p_st + ([] if first else [xin])
        with torch.enable_grad():
            out = self._chunk_obj(c, xin, ys[b] if last else None, pdicts,
                                  update_stats=False)
            if last:
                g = _grad([out["obj"]], wrt, None)
            else:
                outs = [out["y"]]
                seeds = [bwd_q.pop((c, b)).to(out["y"].dtype)]
                if out["aux"] is not None:
                    outs.append(out["aux"])
                    seeds.append(torch.full_like(out["aux"],
                                                 self.aux_weight))
                g = _grad(outs, wrt, seeds)
        n = len(p_st)
        return g[:n], (None if first else g[n])
