"""Uneven per-stage replication: the reference's hybrid PP x DP plans
with a replica count a stage (``ddlbench_tpu/parallel/hetero.py``
``HeteroGPipeStrategy`` and ``HeteroPipeDreamStrategy``; PipeDream's
hierarchical optimizer emits such plans, run/run/run_template.sh
parses them into a ``stage:replication`` map).

Replication is an intra-stage row split, the reference's semantics:
every microbatch passes through every stage, and replica k of stage s
(r_s replicas) computes rows ``[k*mb/r_s, (k+1)*mb/r_s)`` of it. A
boundary is the concatenation of the producer replicas' rows, split
again for the consumers; its cotangent goes back the same way.

The reference puts unequal replica counts onto one SPMD mesh through a
flat axis and a ppermute conveyor. The port needs neither: one process
drives the N = sum(r_s) devices (device ``offsets[s] + k`` holds replica
k of stage s; on a shared card all of them sit on ``cuda:0``) and
replays the schedule's events, as parallel/gpipe.py does for one
replica a stage. Unequal replica counts give no per-replica pipeline a
process could own, so the replicas are not ranks. Replica 0 of each
stage holds the model's own layers; the others hold copies, kept equal
to it: every replica applies the same summed gradient, and ``init``
copies replica 0 into the others.

:class:`HeteroGPipeStrategy`, the fill-drain step:

* each replica updates BatchNorm's running statistics on its rows, and
  the statistics are averaged over the stage's replicas at the step's
  end;
* the objective is the global mean over the batch's valid labels (the
  replicas' label-smoothed CE sums over the whole batch's count) plus
  ``moe_aux_weight`` x the MoE router losses, each replica's averaged
  over its stage's replicas (it saw 1/r of the rows), summed over
  stages and averaged over microbatches; the reported loss is the CE
  the same way;
* with ``remat_stages`` the forward keeps each replica's input and the
  backward recomputes it (statistics frozen), as gpipe's; without, every
  replica's graph is kept;
* each stage's gradient is the sum of its replicas' (the reference's
  per-stage DDP all-reduce), applied by each replica; the last stage's
  replicas run the fused LM head where the model has one.

:class:`HeteroPipeDreamStrategy`: PipeDream's async 1F1B with weight
stashing (parallel/pipedream.py's timetable over the S stages, a ring of
min(S, M) weight versions), every replica of a stage running the
stage's events on its rows; each backward's gradient is summed over
the stage's replicas before the per-microbatch update. A replica's
loss for microbatch b is its CE sum over the valid labels of the whole
microbatch plus ``moe_aux_weight`` / r x its router losses. BatchNorm's
statistics are averaged over each stage's replicas at the step's end.

Eval is the fill-drain forward of both.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.layers import LayerModel, apply_chunk
from ddlbench_tpu_torch.parallel import state
from ddlbench_tpu_torch.parallel.common import (
    cast_input, flat_optimizer, fused_chunk_eval_sums, fused_chunk_loss_sums,
    head_fusable, logits_eval_sums, logits_loss_sums, ref_param_order,
    to_ref_layout)
from ddlbench_tpu_torch.parallel.gpipe import bn_layers, chunk_aux
from ddlbench_tpu_torch.parallel.packing import (balanced_stage_bounds,
                                                 layer_flop_costs,
                                                 model_shapes)
from ddlbench_tpu_torch.parallel.pipedream import bwd_mb_at, fwd_mb_at
from ddlbench_tpu_torch.parallel.pipeline_rt import _grad
from ddlbench_tpu_torch.partition.schedule import fill_drain_timetable


def plan_tables(repl: Sequence[int]):
    """(stage_of[N], rep_of[N], offsets[S + 1], R) of a replication plan:
    device d holds replica rep_of[d] of stage stage_of[d], a stage's
    replicas on offsets[s] .. offsets[s + 1] - 1; R is the reference's
    conveyor round count, max over boundaries of r_s + r_{s+1} - 1 (its
    wire accounting reads it: train/comm_stats.py)."""
    offsets = [0]
    for r in repl:
        offsets.append(offsets[-1] + r)
    stage_of, rep_of = [], []
    for s, r in enumerate(repl):
        stage_of += [s] * r
        rep_of += list(range(r))
    R = max([repl[s] + repl[s + 1] - 1 for s in range(len(repl) - 1)],
            default=0)
    return stage_of, rep_of, offsets, R


def take_rows(pieces: Sequence[torch.Tensor], per: int, lo: int, hi: int,
              device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of the concatenation of ``pieces`` (``per`` rows
    each, piece j holding rows [j*per, (j+1)*per)), moved to ``device``:
    only the pieces that overlap are read."""
    parts = []
    for j, p in enumerate(pieces):
        a = j * per
        s, e = max(lo, a), min(hi, a + per)
        if s < e:
            parts.append(p[s - a:e - a].to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class HeteroGPipeStrategy:
    """strategy='gpipe' with uneven ``stage_replication`` (module
    docstring), on ``devices``: N = sum(stage_replication) of them."""

    def __init__(self, model: LayerModel, cfg: RunConfig,
                 devices: Sequence[torch.device],
                 stage_bounds: Optional[Sequence[int]] = None):
        repl = tuple(int(r) for r in (cfg.stage_replication or ()))
        if not repl:
            raise ValueError(f"{type(self).__name__} needs "
                             "stage_replication")
        self.model, self.cfg, self.repl = model, cfg, repl
        self.num_stages = self.num_chunks = S = len(repl)
        self.N = sum(repl)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.N:
            raise ValueError(f"stage_replication {repl} needs {self.N} "
                             f"devices, got {len(self.devices)}")
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.mb, self.num_microbatches = cfg.resolved_batches()
        for s, r in enumerate(repl):
            if self.mb % r:
                raise ValueError(
                    f"micro-batch {self.mb} not divisible by stage {s}'s "
                    f"replication {r}")
        self.rows = [self.mb // r for r in repl]
        self.smoothing = cfg.resolved_label_smoothing()
        self.aux_weight = cfg.moe_aux_weight
        (self._stage_of, self._rep_of, self._offsets,
         self._R) = plan_tables(repl)
        self.shapes = model_shapes(model)
        if stage_bounds is None:
            bounds = balanced_stage_bounds(
                layer_flop_costs(model, self.shapes), S)
        else:
            bounds = [int(b) for b in stage_bounds]
        assert (len(bounds) == S + 1 and bounds[0] == 0
                and bounds[-1] == len(model.layers)), bounds
        self.bounds = bounds
        interior = [self.mb * math.prod(self.shapes[bounds[s]])
                    for s in range(1, S)]
        self._act_size = max(interior) if interior else 1
        self.fused = cfg.fused_head_loss and head_fusable(model)
        # replica (s, k): the model's own layers for k 0, copies beside
        self.replicas: List[List[List[torch.nn.Module]]] = []
        for s in range(S):
            own = list(model.layers[bounds[s]:bounds[s + 1]])
            for layer in own:
                layer.to(self.device_of(s, 0))
            reps = [own]
            for k in range(1, repl[s]):
                reps.append([copy.deepcopy(layer).to(self.device_of(s, k))
                             for layer in own])
            self.replicas.append(reps)
        self._p_lens = [sum(p.numel() for layer in self.replicas[s][0]
                            for p in layer.parameters()) for s in range(S)]
        self._fill_drain = fill_drain_timetable(S, self.num_microbatches, 1)
        self._opt_init, self._opt_update = flat_optimizer(cfg)
        self.opt: Optional[List[List[dict]]] = None

    # -- layout --------------------------------------------------------------

    def device_of(self, s: int, k: int) -> torch.device:
        return self.devices[self._offsets[s] + k]

    def chunk_layers(self, s: int) -> Sequence[torch.nn.Module]:
        """Stage s's layers (its replica 0: the model's own)."""
        return self.replicas[s][0]

    def chunk_device(self, s: int) -> torch.device:
        return self.device_of(s, 0)

    def replica_params(self, s: int, k: int) -> List[torch.nn.Parameter]:
        return [p for layer in self.replicas[s][k]
                for p in layer.parameters()]

    @property
    def world_size(self) -> int:
        return self.N

    def init(self) -> None:
        """Every replica set to its stage's replica 0 (parameters and
        running statistics), and fresh optimizer state for each."""
        with torch.no_grad():
            for reps in self.replicas:
                for k in range(1, len(reps)):
                    for src, dst in zip(reps[0], reps[k]):
                        for a, b in zip(src.parameters(), dst.parameters()):
                            b.copy_(a)
                        for a, b in zip(src.buffers(), dst.buffers()):
                            b.copy_(a)
        self.opt = [[self._opt_init([p.detach() for p in
                                     self.replica_params(s, k)])
                     for k in range(r)] for s, r in enumerate(self.repl)]

    def materialize_params(self) -> torch.Tensor:
        """[S, L] on the CPU in float32: row s is stage s's parameters
        (replica 0's) in the reference's leaf order and layout, zero-padded
        to the longest row: the reference's [N, L] rows taken at each
        stage's first device (convert.py ``from_jax_hetero_rows``)."""
        rows = []
        for s in range(self.num_stages):
            sub = LayerModel("stage", list(self.replicas[s][0]), (1,), 1)
            params, _ = ref_param_order(sub)
            rows.append(torch.cat(
                [to_ref_layout(p.detach()).float().reshape(-1).cpu()
                 for p in params]) if params else torch.zeros(0))
        L = max(max(r.numel() for r in rows), 1)
        return torch.stack([torch.nn.functional.pad(r, (0, L - r.numel()))
                            for r in rows])

    def _devices_rows(self, get) -> List[List[torch.Tensor]]:
        """``get(s, k)`` for every device row d = (s, k), in device
        order (the reference's [N, L] rows)."""
        return [get(s, k) for s, r in enumerate(self.repl)
                for k in range(r)]

    def _replica_order(self, s: int, k: int):
        params = state.ref_params(self.replicas[s][k])
        return params, state.order_of(params, self.replica_params(s, k))

    def checkpoint_state(self) -> dict:
        """The reference's [N, L] device rows (parallel/state.py): row d
        is its stage's replica's parameters, BatchNorm statistics and
        optimizer ``m``/``v``, packed; ``step`` one a row."""
        rows = state.pack_rows
        params = rows(self._devices_rows(
            lambda s, k: self._replica_order(s, k)[0]))
        opt = {}
        for key in state.OPT_TENSOR_KEYS:
            if key in self.opt[0][0]:
                opt[key] = rows(self._devices_rows(lambda s, k: [
                    self.opt[s][k][key][i]
                    for i in self._replica_order(s, k)[1]]))
        if "step" in self.opt[0][0]:
            opt["step"] = torch.tensor(self._devices_rows(
                lambda s, k: [self.opt[s][k]["step"]]), dtype=torch.int32)
        return {"params": params,
                "model_state": rows(self._devices_rows(
                    lambda s, k: state.ref_buffers(self.replicas[s][k]))),
                "opt": opt}

    def load_checkpoint_state(self, saved: dict) -> None:
        """The inverse of :meth:`checkpoint_state`, in place."""
        state.unpack_rows(self._devices_rows(
            lambda s, k: self._replica_order(s, k)[0]), saved["params"])
        state.unpack_rows(self._devices_rows(
            lambda s, k: state.ref_buffers(self.replicas[s][k])),
            saved["model_state"])
        sopt = saved["opt"]
        for key in state.OPT_TENSOR_KEYS:
            if key in self.opt[0][0]:
                state.unpack_rows(self._devices_rows(lambda s, k: [
                    self.opt[s][k][key][i]
                    for i in self._replica_order(s, k)[1]]), sopt[key])
        if "step" in self.opt[0][0]:
            steps = iter(sopt["step"].reshape(-1).tolist())
            for s, r in enumerate(self.repl):
                for k in range(r):
                    self.opt[s][k]["step"] = int(next(steps))

    def shard_batch(self, x: torch.Tensor, y: torch.Tensor):
        """Global batch [M*mb, ...] -> (each stage-0 replica's input rows,
        each last-stage replica's label rows, each microbatch's valid
        label count), a list a microbatch: xs[m][k] on replica (0, k)'s
        device, ys[m][k] on replica (S-1, k)'s."""
        M, mb = self.num_microbatches, self.mb
        if x.shape[0] != M * mb:
            raise ValueError(f"batch of {x.shape[0]} rows; the pipeline "
                             f"takes {M} microbatches of {mb}")
        S = self.num_stages
        r0, rL = self.rows[0], self.rows[-1]
        xs = [[t[k * r0:(k + 1) * r0].to(self.device_of(0, k))
               for k in range(self.repl[0])] for t in x.split(mb)]
        ys = [[t[k * rL:(k + 1) * rL].to(self.device_of(S - 1, k))
               for k in range(self.repl[-1])] for t in y.split(mb)]
        valid = [(t >= 0).sum() for t in y.split(mb)]
        return xs, ys, valid

    # -- one replica ---------------------------------------------------------

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype) if t.is_floating_point() else t

    def _run(self, s: int, k: int, x: torch.Tensor,
             labels: Optional[torch.Tensor], params=None,
             update_stats: bool = True, train: bool = True) -> dict:
        """Replica (s, k) on its rows x: ``y`` (None on the last stage),
        ``aux`` (its MoE router losses or None), and on the last stage the
        sums ``obj`` (label-smoothed CE, train only), ``ce``, ``correct``,
        ``valid`` (and ``correct5`` in eval)."""
        layers = self.replicas[s][k]
        x = cast_input(x, self.compute_dtype)
        out: dict = {"y": None}
        if s < self.num_stages - 1:
            out["y"] = apply_chunk(layers, x, self.compute_dtype, params,
                                   update_stats)
        elif self.fused and train:
            out["obj"], out["ce"], out["correct"], out["valid"] = \
                fused_chunk_loss_sums(layers, x, labels, self.compute_dtype,
                                      self.smoothing, params, update_stats)
        elif self.fused:
            (out["ce"], out["correct"], out["correct5"],
             out["valid"]) = fused_chunk_eval_sums(layers, x, labels,
                                                   self.compute_dtype)
        else:
            logits = apply_chunk(layers, x, self.compute_dtype, params,
                                 update_stats)
            if train:
                out["obj"], out["ce"], out["correct"], out["valid"] = \
                    logits_loss_sums(logits, labels, self.smoothing)
            else:
                (out["ce"], out["correct"], out["correct5"],
                 out["valid"]) = logits_eval_sums(logits, labels)
        out["aux"] = chunk_aux(layers) if train else None
        return out

    def _stage_input(self, s: int, k: int, m: int, xs, pieces
                     ) -> torch.Tensor:
        """Replica (s, k)'s input rows of microbatch m: its rows of the
        batch on stage 0, else its rows of the producers' outputs."""
        if s == 0:
            return xs[m][k]
        rows = self.rows[s]
        return take_rows(pieces, self.rows[s - 1], k * rows,
                         (k + 1) * rows, self.device_of(s, k))

    def _forward_order(self) -> List[Tuple[int, int]]:
        tv, tm, valid = self._fill_drain.forward_tick_arrays()
        return [(s, int(tm[t, s])) for t in range(tv.shape[0])
                for s in range(self.num_stages) if valid[t, s]]

    # -- the step's reductions -----------------------------------------------

    def _group_sum(self, s: int, per_replica: Sequence[Sequence[torch.Tensor]]
                   ) -> List[torch.Tensor]:
        """Stage s's gradient: its replicas' lists summed, in replica
        order, on replica 0's device."""
        dev = self.device_of(s, 0)
        total = [t.clone() for t in per_replica[0]]
        for g in per_replica[1:]:
            for a, b in zip(total, g):
                a.add_(b.to(dev))
        return total

    def _apply(self, s: int, grads: Sequence[torch.Tensor],
               lr: float) -> None:
        """Every replica of stage s updated with the stage's gradient."""
        for k in range(self.repl[s]):
            params = self.replica_params(s, k)
            if not params:
                continue
            dev = self.device_of(s, k)
            with torch.no_grad():
                self._opt_update([p.detach() for p in params],
                                 [g.to(dev) for g in grads],
                                 self.opt[s][k], lr)

    def _sync_stats(self) -> None:
        """Each stage's BatchNorm running statistics averaged over its
        replicas (the sum in replica order over the count)."""
        with torch.no_grad():
            for s, reps in enumerate(self.replicas):
                if len(reps) == 1:
                    continue
                per = [bn_layers(rep) for rep in reps]
                dev = self.device_of(s, 0)
                for i in range(len(per[0])):
                    for name in ("mean", "var"):
                        ts = [getattr(bns[i], name) for bns in per]
                        total = ts[0].clone()
                        for t in ts[1:]:
                            total += t.to(dev)
                        total /= len(ts)
                        for t in ts:
                            t.copy_(total.to(t.device))

    # -- the step ------------------------------------------------------------

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One fill-drain step on the global batch (x, y) at ``lr``:
        {"loss": the unsmoothed CE over the batch's valid labels,
        "accuracy": top-1 over them}."""
        xs, ys, valid_mb = self.shard_batch(x, y)
        self.model.train()
        for reps in self.replicas:
            for rep in reps:
                for layer in rep:
                    layer.train()
                    for p in layer.parameters():
                        p.grad = None
        S, M = self.num_stages, self.num_microbatches
        last_dev = self.device_of(S - 1, 0)
        denom = sum(v.to(last_dev) for v in valid_mb).clamp(min=1).float()
        remat = self.cfg.remat_stages
        order = self._forward_order()
        outs: Dict[Tuple[int, int], list] = {}  # stage outputs, by replica
        kept: Dict[Tuple[int, int, int], tuple] = {}
        ce = correct = None
        with torch.no_grad() if remat else contextlib.nullcontext():
            for s, m in order:
                pieces = outs.pop((s - 1, m)) if s else None
                ys_out = []
                for k in range(self.repl[s]):
                    xin = self._stage_input(s, k, m, xs, pieces)
                    if not remat and s:
                        xin = xin.detach().requires_grad_(True)
                    o = self._run(s, k, xin, ys[m][k] if s == S - 1
                                  else None)
                    kept[(s, m, k)] = (xin, None if remat else o)
                    if s < S - 1:
                        ys_out.append(self._send(o["y"]))
                        continue
                    c_ce, c_ok = o["ce"].detach().to(last_dev), \
                        o["correct"].to(last_dev)
                    ce = c_ce if ce is None else ce + c_ce
                    correct = c_ok if correct is None else correct + c_ok
                if s < S - 1:
                    outs[(s, m)] = ys_out
        self._backward(order, kept, ys, denom, remat)
        for s in range(S):
            grads = [[torch.zeros_like(p) if p.grad is None else p.grad
                      for p in self.replica_params(s, k)]
                     for k in range(self.repl[s])]
            self._apply(s, self._group_sum(s, grads), lr)
        self._sync_stats()
        return {"loss": ce / denom,
                "accuracy": correct.float() / denom}

    def _backward(self, order, kept, ys, denom, remat: bool) -> None:
        """The fill-drain backward, events in reverse: each replica's
        objective part (its CE sum over the batch's count, its MoE losses
        at moe_aux_weight / (r M)) or its output seeded with its rows of
        the consumers' input cotangents; parameter gradients accumulate
        in ``.grad``."""
        S, M = self.num_stages, self.num_microbatches
        cots: Dict[Tuple[int, int], list] = {}
        for s, m in reversed(order):
            r = self.repl[s]
            aux_seed = self.aux_weight / (r * M)
            gx_pieces = []
            pieces = cots.pop((s, m)) if s < S - 1 else None
            for k in range(r):
                xin, o = kept.pop((s, m, k))
                if remat:
                    if s:
                        xin = xin.detach().requires_grad_(True)
                    with torch.enable_grad():
                        o = self._run(s, k, xin, ys[m][k] if s == S - 1
                                      else None, update_stats=False)
                tensors, seeds = [], []
                if s == S - 1:
                    tensors.append(o["obj"] / denom.to(o["obj"].device))
                    seeds.append(None)
                else:
                    rows = self.rows[s]
                    g = take_rows(pieces, self.rows[s + 1], k * rows,
                                  (k + 1) * rows, self.device_of(s, k))
                    tensors.append(o["y"])
                    seeds.append(g.to(o["y"].dtype))
                if o["aux"] is not None:
                    tensors.append(o["aux"])
                    seeds.append(torch.full_like(o["aux"], aux_seed))
                seeds = [torch.ones_like(t) if g is None else g
                         for t, g in zip(tensors, seeds)]
                keep = [i for i, t in enumerate(tensors) if t.requires_grad]
                if keep:
                    with torch.enable_grad():
                        torch.autograd.backward([tensors[i] for i in keep],
                                                [seeds[i] for i in keep])
                if s:
                    gx_pieces.append(self._send(
                        torch.zeros_like(xin) if xin.grad is None
                        else xin.grad))
            if s:
                cots[(s - 1, m)] = gx_pieces

    def eval_step(self, x: torch.Tensor,
                  y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The fill-drain forward in eval mode: {loss (the CE over the
        batch's valid labels), correct, correct5, count}."""
        xs, ys, _ = self.shard_batch(x, y)
        for reps in self.replicas:
            for rep in reps:
                for layer in rep:
                    layer.eval()
        S = self.num_stages
        last_dev = self.device_of(S - 1, 0)
        outs: Dict[Tuple[int, int], list] = {}
        tot = {"ce": None, "correct": None, "correct5": None, "valid": None}
        with torch.no_grad():
            for s, m in self._forward_order():
                pieces = outs.pop((s - 1, m)) if s else None
                ys_out = []
                for k in range(self.repl[s]):
                    xin = self._stage_input(s, k, m, xs, pieces)
                    o = self._run(s, k, xin, ys[m][k] if s == S - 1
                                  else None, train=False)
                    if s < S - 1:
                        ys_out.append(self._send(o["y"]))
                        continue
                    for key in tot:
                        v = o[key].to(last_dev)
                        tot[key] = v if tot[key] is None else tot[key] + v
                if s < S - 1:
                    outs[(s, m)] = ys_out
        count = tot["valid"]
        return {"loss": tot["ce"] / count.clamp(min=1).float(),
                "correct": tot["correct"], "correct5": tot["correct5"],
                "count": count}


class HeteroPipeDreamStrategy(HeteroGPipeStrategy):
    """strategy='pipedream' with uneven ``stage_replication``: async 1F1B
    with weight stashing over the replicas' row split (module
    docstring)."""

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One async-1F1B step (M updates a stage) on the global batch
        (x, y) at ``lr``: {"loss": the unsmoothed CE each forward saw over
        the batch's valid labels, "accuracy": top-1 over them}."""
        xs, ys, valid_mb = self.shard_batch(x, y)
        for reps in self.replicas:
            for rep in reps:
                for layer in rep:
                    layer.train()
        S, M = self.num_stages, self.num_microbatches
        H = 2 * M + 2 * S - 2
        nslot = min(S, M)
        last_dev = self.device_of(S - 1, 0)
        stash_p: Dict[Tuple[int, int, int], List[torch.Tensor]] = {}
        stash_x: Dict[Tuple[int, int, int], torch.Tensor] = {}
        fwd_q: Dict[Tuple[int, int], list] = {}
        bwd_q: Dict[Tuple[int, int], list] = {}
        ce = correct = count = None
        for h in range(H):
            for s in range(S):
                f, valid_f = fwd_mb_at(s, S, M, h)
                if valid_f:
                    pieces = fwd_q.pop((s, f)) if s else None
                    outs = []
                    for k in range(self.repl[s]):
                        xin = self._stage_input(s, k, f, xs, pieces)
                        stash_p[(s, k, f % nslot)] = [
                            p.detach().clone()
                            for p in self.replica_params(s, k)]
                        stash_x[(s, k, f % nslot)] = xin
                        with torch.no_grad():
                            o = self._run(s, k, xin, ys[f][k]
                                          if s == S - 1 else None)
                        if s < S - 1:
                            outs.append(self._send(o["y"]))
                            continue
                        parts = (o["ce"].to(last_dev),
                                 o["correct"].to(last_dev),
                                 o["valid"].to(last_dev))
                        if ce is None:
                            ce, correct, count = parts
                        else:
                            ce, correct, count = (ce + parts[0],
                                                  correct + parts[1],
                                                  count + parts[2])
                    if s < S - 1:
                        fwd_q[(s + 1, f)] = outs
                b, valid_b = bwd_mb_at(s, S, M, h)
                if not valid_b:
                    continue
                gps, gxs = [], []
                pieces = bwd_q.pop((s, b)) if s < S - 1 else None
                for k in range(self.repl[s]):
                    gp, gx = self._replica_backward(
                        s, k, b, ys, valid_mb, stash_p, stash_x, pieces,
                        nslot)
                    gps.append([g.to(torch.promote_types(
                        g.dtype, torch.float32)) for g in gp])
                    if gx is not None:
                        gxs.append(self._send(gx))
                if s:
                    bwd_q[(s - 1, b)] = gxs
                self._apply(s, self._group_sum(s, gps), lr)
        self._sync_stats()
        fvalid = count.clamp(min=1).float()
        return {"loss": ce / fvalid, "accuracy": correct.float() / fvalid}

    def _replica_backward(self, s: int, k: int, b: int, ys, valid_mb,
                          stash_p, stash_x, pieces, nslot: int):
        """Replica (s, k)'s backward of microbatch b at its forward's
        weights: (parameter gradients, its input rows' cotangent or None
        on stage 0)."""
        slot = b % nslot
        p_st = [t.requires_grad_(True) for t in stash_p.pop((s, k, slot))]
        it = iter(p_st)
        pdicts = [{n: next(it) for n, _ in layer.named_parameters()}
                  for layer in self.replicas[s][k]]
        x_st = stash_x.pop((s, k, slot))
        if s:
            x_st = x_st.detach().requires_grad_(True)
        wrt = p_st + ([x_st] if s else [])
        aux_w = self.aux_weight / self.repl[s]
        last = s == self.num_stages - 1
        with torch.enable_grad():
            o = self._run(s, k, x_st, ys[b][k] if last else None, pdicts,
                          update_stats=False)
            if last:
                denom = valid_mb[b].to(o["obj"].device).clamp(min=1).float()
                loss = o["obj"] / denom
                if o["aux"] is not None:
                    loss = loss + aux_w * o["aux"]
                g = _grad([loss], wrt, None)
            else:
                rows = self.rows[s]
                cot = take_rows(pieces, self.rows[s + 1], k * rows,
                                (k + 1) * rows, self.device_of(s, k))
                outs, seeds = [o["y"]], [cot.to(o["y"].dtype)]
                if o["aux"] is not None:
                    outs.append(o["aux"])
                    seeds.append(torch.full_like(o["aux"], aux_w))
                g = _grad(outs, wrt, seeds)
        n = len(p_st)
        return g[:n], (g[n] if s else None)
