"""``--plan auto`` of the port: the joint dp/pp/tp solver closing
profile -> graph -> plan (the reference's ``partition/planner.py``, whose
choices and messages it keeps).

Given a profiled layer graph (profiler/profile.py: node times and
activation/parameter bytes) and the topology (:class:`HardwareModel`'s
bandwidths and per-device memory cap, the world size), it

1. enumerates every (pp, dp, tp) factorization of the world (tp gated to
   token/seq2seq workloads and to the widths the Megatron slicing of
   models/transformer.py can run) and every schedule at that pp,
2. solves a memory-capped compute-balanced contiguous stage split per pp
   (:func:`optimizer.capped_balanced_split`),
3. prices each candidate with the cost-aware timetables of
   partition/schedule.py (``make_timetable(costs=...)`` event orders
   repriced under the true float costs where small enough, the analytic
   ``schedule_bubble_fraction`` closed forms beyond) plus the ring
   collectives' wire terms that train/comm_stats.py reports,
4. returns the argmin as a :class:`PlanResult`, and
   :func:`resolve_auto_plan` rewrites the RunConfig onto the port's
   engines: a pure-dp winner runs dp with the ZeRO-1 update
   (``dp_shard_update``), a pipelined one gpipe or the timetable runtime
   (the hybrid PP x ZeRO-1 when dp > 1), a tensor-sliced one tp or tpp;
   the chosen stage bounds travel as ``cfg.plan_bounds``, so the engine
   executes exactly the split the solver priced.

Cost model (one interconnect level: NVLink inside a host):

* per-microbatch per-device stage time: ``(f_s + b_s) / (dp * tp)`` plus
  the Megatron activation all-reduces when tp > 1;
* pipeline makespan: the weighted timetable's event order repriced under
  the true float costs when ``pp * M`` is small enough, else
  ``ideal / (1 - analytic bubble)``, and a steady-state boundary-transfer
  bottleneck term;
* dp sync: a ring over the bottleneck stage's parameter bytes
  (``2 (dp-1)/dp * P_s / tp``);
* memory per device: ``(weights + grads + opt) * P_s / tp`` with the
  optimizer slots divided by dp under ZeRO-1, plus the schedule's
  in-flight activation stash; candidates over ``hw.hbm_bytes`` are
  infeasible, which is how a tight cap flips the chosen mix.

The reference also persists the decision in ``partition.json`` beside the
checkpoints and pins an elastic resume to a checkpoint's recorded split;
both wait for the port's checkpoints (ROADMAP A.8), so
:func:`resolve_auto_plan` always solves.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ddlbench_tpu_torch.config import HardwareModel, RunConfig
from ddlbench_tpu_torch.graph.graph import Graph
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.partition.optimizer import INF, capped_balanced_split

PLAN_MODES = ("manual", "auto")

# exact weighted-makespan pricing is used while the greedy generator's
# pure-Python table stays below this many (chunk, microbatch) events;
# larger shapes fall back to the analytic closed forms (same bound family
# as schedule.bubble_is_estimate)
_EXACT_TABLE_EVENTS = 512


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (pp, dp, tp, schedule) point of the search space, priced."""

    pp: int
    dp: int
    tp: int
    schedule: str
    bounds: Optional[Tuple[int, ...]]  # pp+1 graph-node stage bounds
    step_time_ms: float  # predicted; inf when infeasible
    peak_bytes_per_chip: float
    feasible: bool
    reason: str = ""  # why infeasible / pricing notes
    # per-stage predicted resident bytes/chip (peak is their max)
    stage_mem: Optional[Tuple[float, ...]] = None
    # EXTRA activation bytes/chip the schedule's lifted in-flight cap
    # stashes beyond the 1F1B family's (zero-bubble-h2 only; 0 elsewhere)
    # — recorded so the candidate says what memory the bubble was bought
    # with
    stash_bytes: float = 0.0

    def mix(self) -> str:
        return f"pp={self.pp} dp={self.dp} tp={self.tp} @{self.schedule}"

    def as_record(self) -> dict:
        return {
            "pp": self.pp, "dp": self.dp, "tp": self.tp,
            "schedule": self.schedule,
            "bounds": list(self.bounds) if self.bounds else None,
            "step_time_ms": (None if self.step_time_ms == INF
                             else round(self.step_time_ms, 4)),
            "peak_bytes_per_chip": round(self.peak_bytes_per_chip, 1),
            "feasible": self.feasible,
            "reason": self.reason,
            "stage_mem": ([round(m, 1) for m in self.stage_mem]
                          if self.stage_mem else None),
            "stash_bytes": round(self.stash_bytes, 1),
        }


@dataclasses.dataclass
class PlanResult:
    winner: Candidate
    candidates: List[Candidate]
    reason: str  # why the winner won (vs the runner-up)


def _ring_ms(bytes_: float, r: int, bw: float) -> float:
    """Ring allreduce wire time in ms — the SAME byte formula comm_stats
    reports for the executed run, so predictions and runtime accounting
    cannot silently diverge."""
    from ddlbench_tpu_torch.train.comm_stats import _ring_allreduce_bytes

    if bw <= 0:
        return 0.0
    return 1000.0 * _ring_allreduce_bytes(bytes_, r) / bw


def _reprice_float(tt, F: Sequence[float], B: Sequence[float]) -> float:
    """Execute the timetable's event ORDER under the true float ms costs.

    ``quantize_cost_vectors`` rounds every event to half-tick units capped
    at 8, so ``half_ticks * cheapest_event`` would under-price uneven
    splits severalfold (a stage 90x the cheapest event bills 8 ticks).
    Instead, walk the events in start-half-tick order — a valid
    topological order of the dependency DAG, since a consumer starts
    strictly after its producer on the grid — and start each at
    max(device ready, producers done) with its REAL cost: the honest
    makespan of the order the runtime would execute."""
    from ddlbench_tpu_torch.partition.schedule import (EVENT_BWD_IN, EVENT_BWD_W,
                                                 EVENT_FWD)

    S, C = tt.num_stages, tt.num_chunks
    cost = {EVENT_FWD: lambda c: F[c],
            EVENT_BWD_IN: lambda c: B[c] / 2.0,  # the quantizer's B/W split
            EVENT_BWD_W: lambda c: B[c] / 2.0}
    evs = []
    for kind in (EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W):
        for (chunk, mb), h in tt.event_times(kind).items():
            evs.append((h, chunk % S, kind, chunk, mb))
    evs.sort()
    ready = [0.0] * S
    done: Dict[Tuple[int, int, int], float] = {}
    t_end = 0.0
    for h, s, kind, chunk, mb in evs:
        if kind == EVENT_FWD:
            deps = [(EVENT_FWD, chunk - 1, mb)] if chunk > 0 else []
        elif kind == EVENT_BWD_IN:
            deps = [(EVENT_FWD, chunk, mb)]
            if chunk < C - 1:
                deps.append((EVENT_BWD_IN, chunk + 1, mb))
        else:
            deps = [(EVENT_BWD_IN, chunk, mb)]
        t0 = max([ready[s]] + [done[d] for d in deps if d in done])
        t1 = t0 + cost[kind](chunk)
        ready[s] = t1
        done[(kind, chunk, mb)] = t1
        t_end = max(t_end, t1)
    return t_end


def _pipe_ms(schedule: str, pp: int, M: int,
             F: Sequence[float], B: Sequence[float], *,
             h2_stash: int = 1, search_budget: int = 256,
             search_seed: int = 0) -> float:
    """Predicted pipeline portion of one step in ms: per-chunk forward /
    backward costs F/B (already per-chip), M microbatches, one of the
    V=1 schedules. Where the table is small enough, build the weighted
    timetable and reprice its event order under the true float costs
    (:func:`_reprice_float`); analytic bubble closed forms beyond.

    The search path quantizes at max_units=64 instead of 8 — the packer
    needs to SEE the real unevenness to place events around it, and a
    clipped vector would hand it the same flattened profile the
    heuristics already pack. zero-bubble-h2 is priced at its steady-state
    period (the per-step cost of back-to-back steps; the deferred tail-W
    overlaps the next step's warmup)."""
    if pp == 1:
        return M * (F[0] + B[0])
    from ddlbench_tpu_torch.partition.schedule import (make_timetable,
                                                 quantize_cost_vectors,
                                                 schedule_bubble_fraction)

    if pp * M <= _EXACT_TABLE_EVENTS:
        max_units = 64 if schedule == "searched" else 8
        costs = quantize_cost_vectors(F, B, max_units=max_units)
        tt = make_timetable(schedule, pp, M, 1, costs, stash=h2_stash,
                            search_budget=search_budget,
                            search_seed=search_seed)
        ms = _reprice_float(tt, F, B)
        if schedule == "zero-bubble-h2":
            ms *= tt.steady_period() / tt.half_ticks
        return ms
    ideal = M * max(F[s] + B[s] for s in range(pp))
    frac = schedule_bubble_fraction(schedule, pp, M, stash=h2_stash)
    return ideal / max(1e-9, 1.0 - frac)


def solve_plan(graph: Graph, world: int, micro_batch: int,
               num_microbatches: int, hw: Optional[HardwareModel] = None,
               *, optimizer: str = "sgd", token_model: bool = False,
               tp_candidates: Optional[Sequence[int]] = None,
               remat: bool = True, pin_pp: Optional[int] = None,
               pin_bounds: Optional[Sequence[int]] = None,
               zero1: bool = True, h2_stash: int = 1,
               search_budget: int = 256,
               search_seed: int = 0) -> PlanResult:
    """Solve the dp/pp/tp mix + stage split + schedule for one profile
    graph on ``world`` chips. Pure host math — no devices touched.

    ``pin_pp`` constrains the stage count and ``pin_bounds`` the exact
    layer split (the elastic-resume cross-link: a checkpointed run's
    recorded split must be kept VERBATIM — same count, same cuts — so the
    per-stage packed rows line up and the dp-axis reshard stays a
    permutation); tp candidates are then excluded (the recorded ZeRO-1
    flat layouts have no tp axis). ``zero1=False`` prices the replicated
    optimizer state (MoE archs, where the explicit dp collective engine
    is unavailable). ``h2_stash`` sizes zero-bubble-h2's extra in-flight
    stash (both its memory term and its steady-state pricing);
    ``search_budget``/``search_seed`` parameterize the searched packer so
    the priced table is exactly the one the runtime will execute."""
    hw = hw or HardwareModel()
    order = graph.topological_sort()
    n = len(order)
    if n == 0:
        raise ValueError("empty profile graph")
    f = [nd.forward_compute_time for nd in order]
    b = [nd.backward_compute_time for nd in order]
    p = [nd.parameter_size for nd in order]
    a = [nd.activation_size for nd in order]
    pre_f = [0.0]
    pre_b = [0.0]
    pre_p = [0.0]
    pre_a = [0.0]
    for i in range(n):
        pre_f.append(pre_f[-1] + f[i])
        pre_b.append(pre_b[-1] + b[i])
        pre_p.append(pre_p[-1] + p[i])
        pre_a.append(pre_a[-1] + a[i])
    # sparse table over a[] for O(1) range max — stage_mem runs inside
    # capped_balanced_split's O(n^2 * pp) inner loop, so an O(n) slice
    # there would make each candidate O(n^3 * pp) in pure Python
    log2 = [0] * (n + 1)
    for i in range(2, n + 1):
        log2[i] = log2[i >> 1] + 1
    sp_a = [list(a)]
    k = 1
    while (1 << k) <= n:
        prev = sp_a[-1]
        half = 1 << (k - 1)
        sp_a.append([max(prev[i], prev[i + half])
                     for i in range(n - (1 << k) + 1)])
        k += 1

    def max_a(i, j):
        """max(a[i:j]), 0.0 when empty."""
        if i >= j:
            return 0.0
        k = log2[j - i]
        return max(sp_a[k][i], sp_a[k][j - (1 << k)])
    M = num_microbatches
    opt_slots = 2.0 if optimizer == "adam" else 1.0
    if tp_candidates is None:
        tp_candidates = [t for t in (2, 4, 8) if world % t == 0] \
            if token_model else []
    if pin_pp is not None:
        tp_candidates = []
    if pin_bounds is not None:
        pb = tuple(int(x) for x in pin_bounds)
        if pin_pp is None or len(pb) != pin_pp + 1 or pb[0] != 0 or \
                pb[-1] != n or any(x >= y for x, y in zip(pb, pb[1:])):
            raise ValueError(
                f"pin_bounds {pin_bounds} must be pin_pp+1 strictly "
                f"increasing cuts from 0 to the graph's {n} nodes")
        pin_bounds = pb

    def span_f(i, j):
        return pre_f[j] - pre_f[i]

    def span_b(i, j):
        return pre_b[j] - pre_b[i]

    def span_p(i, j):
        return pre_p[j] - pre_p[i]

    def span_a(i, j):
        return pre_a[j] - pre_a[i]

    candidates: List[Candidate] = []

    def consider(pp: int, dp: int, tp: int, schedule: str) -> None:
        denom = dp * tp
        shard = zero1 and tp == 1  # the engines the mapping selects
        pmult = 2.0 + opt_slots / (dp if shard else 1)

        def _inflight():
            if schedule == "fill-drain":
                return M
            extra = h2_stash if schedule == "zero-bubble-h2" else 0
            return min(M, pp + extra)

        def stage_mem(i, j):
            """Predicted resident bytes/chip for span [i, j)."""
            weights = pmult * span_p(i, j) / tp
            if pp == 1:
                # one-apply engines: the whole per-device batch's
                # activations live through the backward (M microbatches'
                # rows land in one forward)
                acts = span_a(i, j) * M / denom
            else:
                # searched tables keep the strict 1F1B cap (the packer
                # rejects cap-busting orders); zero-bubble-h2 stashes
                # h2_stash extra in-flight microbatches per chunk
                inflight = _inflight()
                # remat stashes one boundary activation per in-flight
                # microbatch (+ one layer's working set during recompute);
                # without it the whole span's interiors stay live
                boundary = a[i - 1] if i > 0 else a[0]
                stash = (boundary if remat else span_a(i, j))
                acts = (inflight * stash + max_a(i, j)) / denom
            return weights + acts

        def stage_stash_extra(i, j):
            """Bytes/chip the schedule stashes BEYOND the 1F1B cap."""
            if pp == 1 or schedule in ("fill-drain",):
                return 0.0
            extra = _inflight() - min(M, pp)
            if extra <= 0:
                return 0.0
            boundary = a[i - 1] if i > 0 else a[0]
            return extra * (boundary if remat else span_a(i, j)) / denom

        def stage_ms_f(i, j):
            t = span_f(i, j) / denom
            if tp > 1:
                # Megatron block allreduces: ~2 rings over the span's
                # activation bytes each direction (rows already /dp)
                t += _ring_ms(2.0 * span_a(i, j) / dp, tp,
                              hw.ici_bandwidth)
            return t

        def stage_ms_b(i, j):
            t = span_b(i, j) / denom
            if tp > 1:
                t += _ring_ms(2.0 * span_a(i, j) / dp, tp,
                              hw.ici_bandwidth)
            return t

        def edge_ms(i):  # cut before node i: boundary activation transfer
            return 1000.0 * (a[i - 1] / dp) / hw.ici_bandwidth

        # feasibility gates before the split DP
        if pp > n:
            candidates.append(Candidate(
                pp, dp, tp, schedule, None, INF, 0.0, False,
                f"{pp} stages need {pp} layers; graph has {n}"))
            return
        if pp > 1 or tp > 1:
            if micro_batch % dp:
                candidates.append(Candidate(
                    pp, dp, tp, schedule, None, INF, 0.0, False,
                    f"micro-batch {micro_batch} not divisible by dp={dp}"))
                return
        elif (micro_batch * M) % dp:
            candidates.append(Candidate(
                pp, dp, tp, schedule, None, INF, 0.0, False,
                f"global batch {micro_batch * M} not divisible by "
                f"dp={dp}"))
            return

        if pin_bounds is not None:
            # elastic resume: the checkpoint's exact recorded cuts, priced
            # (and memory-gated) at the new world rather than re-chosen —
            # per-stage packed rows must line up for the dp reshard
            bounds = list(pin_bounds)
            peak0 = max(stage_mem(bounds[s], bounds[s + 1])
                        for s in range(pp))
            if peak0 > hw.hbm_bytes:
                candidates.append(Candidate(
                    pp, dp, tp, schedule, tuple(bounds), INF, peak0, False,
                    f"checkpoint-pinned split needs {peak0 / 2**30:.2f} "
                    f"GiB/chip of {hw.hbm_bytes / 2**30:.2f} GiB at the "
                    f"new world"))
                return
        else:
            bounds = capped_balanced_split(
                n, pp, lambda i, j: stage_ms_f(i, j) + stage_ms_b(i, j),
                edge_ms, lambda i, j: stage_mem(i, j) <= hw.hbm_bytes)
        if bounds is None:
            # report the memory the best UNCAPPED split would need, so the
            # record says why the cap killed the candidate
            free = capped_balanced_split(
                n, pp, lambda i, j: stage_ms_f(i, j) + stage_ms_b(i, j),
                edge_ms, lambda i, j: True)
            need = max(stage_mem(free[s], free[s + 1]) for s in range(pp)) \
                if free else 0.0
            candidates.append(Candidate(
                pp, dp, tp, schedule, None, INF, need, False,
                f"exceeds HBM cap: best split needs "
                f"{need / 2**30:.2f} GiB/chip of "
                f"{hw.hbm_bytes / 2**30:.2f} GiB"))
            return
        F = [stage_ms_f(bounds[s], bounds[s + 1]) for s in range(pp)]
        B = [stage_ms_b(bounds[s], bounds[s + 1]) for s in range(pp)]
        pipe = _pipe_ms(schedule, pp, M, F, B, h2_stash=h2_stash,
                        search_budget=search_budget,
                        search_seed=search_seed)
        # steady-state boundary bottleneck (activation fwd + gradient bwd
        # per microbatch per interior cut), partition_hierarchical-style
        if pp > 1:
            worst_edge = max(edge_ms(bounds[s]) for s in range(1, pp))
            pipe = max(pipe, M * 2.0 * worst_edge)
        sync = max(_ring_ms(span_p(bounds[s], bounds[s + 1]) / tp, dp,
                            hw.ici_bandwidth)
                   for s in range(pp))
        mems = tuple(stage_mem(bounds[s], bounds[s + 1])
                     for s in range(pp))
        candidates.append(Candidate(
            pp, dp, tp, schedule, tuple(bounds), pipe + sync, max(mems),
            True, stage_mem=mems,
            stash_bytes=max(stage_stash_extra(bounds[s], bounds[s + 1])
                            for s in range(pp))))

    pps = [d for d in range(1, world + 1) if world % d == 0]
    if pin_pp is not None:
        pps = [pin_pp] if world % pin_pp == 0 else []
        if not pps:
            raise ValueError(
                f"checkpoint-pinned stage count {pin_pp} does not divide "
                f"the new world {world}; restart at the saved topology")
    for pp in pps:
        rest = world // pp
        for dp in [d for d in range(1, rest + 1) if rest % d == 0]:
            tp = rest // dp
            if tp > 1 and tp not in tp_candidates:
                # still RECORDED, so partition.json shows why every
                # factorization of the world was ruled out
                if pin_pp is not None:
                    reason = ("elastic pin: the checkpoint's recorded "
                              "ZeRO-1 flat layouts have no tp axis")
                elif not token_model:
                    reason = ("tensor parallelism needs a token/seq2seq "
                              "benchmark (transformer blocks get sliced)")
                else:
                    reason = (f"tp={tp} outside the supported widths "
                              f"{sorted(tp_candidates)}")
                candidates.append(Candidate(
                    pp, dp, tp, "fill-drain", None, INF, 0.0, False,
                    reason))
                continue
            if pp == 1:
                consider(pp, dp, tp, "fill-drain")
            elif tp > 1:
                # the tpp composition executes the fill-drain scan only
                consider(pp, dp, tp, "fill-drain")
            else:
                for schedule in ("fill-drain", "1f1b", "zero-bubble",
                                 "zero-bubble-h2", "searched"):
                    consider(pp, dp, tp, schedule)

    feasible = [c for c in candidates if c.feasible]
    if not feasible:
        detail = "; ".join(f"{c.mix()}: {c.reason}" for c in candidates[:6])
        raise ValueError(
            f"--plan auto: no feasible (pp, dp, tp) mix for world={world} "
            f"under the {hw.hbm_bytes / 2**30:.2f} GiB/chip cap ({detail})")
    ranked = sorted(feasible,
                    key=lambda c: (c.step_time_ms, c.pp, -c.dp, c.tp,
                                   c.schedule))
    winner = ranked[0]
    if len(ranked) > 1:
        ru = ranked[1]
        reason = (f"{winner.mix()} predicts {winner.step_time_ms:.3f} "
                  f"ms/step vs {ru.step_time_ms:.3f} for next-best "
                  f"{ru.mix()}; peak {winner.peak_bytes_per_chip / 2**30:.3f}"
                  f" GiB/chip of {hw.hbm_bytes / 2**30:.2f} GiB cap")
    else:
        reason = (f"{winner.mix()} is the only feasible mix "
                  f"({winner.step_time_ms:.3f} ms/step predicted)")
    if pin_pp is not None:
        reason += f" [stage count pinned to checkpoint pp={pin_pp}]"
    return PlanResult(winner, candidates, reason)


# ---- config-level resolution: profile -> solve -> rewrite -----------------


def _rewrite_fields(cfg: RunConfig, winner: Candidate, micro_batch: int,
                    num_microbatches: int) -> Dict[str, object]:
    """The ``cfg.replace`` kwargs that map the winning mix onto the
    port's engines. The rewrite PRESERVES the global batch
    (micro_batch * num_microbatches under the pre-plan gpipe accounting)
    and returns a plan='manual' config — by construction equal to the same
    mix passed explicitly, which is what the bitwise end-to-end pin holds
    the planner to. (The reference's ``force_shard``, its elastic resume
    of a ZeRO-1 checkpoint, waits for the port's checkpoints.)"""
    world = cfg.num_devices
    base: Dict[str, object] = dict(
        plan="manual", auto_partition=False, plan_bounds=None,
        num_stages=None, dp_replicas=1, tp_size=1, dp_shard_update=False,
        batch_size=None, micro_batch_size=None, num_microbatches=None,
        pipe_schedule="fill-drain")
    global_batch = micro_batch * num_microbatches
    if world == 1:
        base.update(strategy="single", batch_size=global_batch)
        return base
    pp, dp, tp = winner.pp, winner.dp, winner.tp
    if pp == 1 and tp == 1:
        # pure data parallelism: the dp ZeRO-1 engine (explicit sharded
        # weight update) — except MoE archs, whose router statistics need
        # the replicated engine (config.validate).
        base.update(strategy="dp", batch_size=global_batch // dp,
                    dp_shard_update="moe" not in cfg.arch)
        return base
    if pp == 1 and dp == 1:
        # pure tensor parallelism: the standalone Megatron-sharded engine
        base.update(strategy="tp", batch_size=global_batch)
        return base
    base.update(
        strategy="gpipe", num_stages=pp, dp_replicas=dp, tp_size=tp,
        micro_batch_size=micro_batch // dp,
        num_microbatches=num_microbatches,
        pipe_schedule=winner.schedule,
        # hybrid PP x ZeRO-1 shard axis (the tpp composition keeps the
        # replicated update; validate scopes the shard to tp_size == 1)
        dp_shard_update=dp > 1 and tp == 1,
        plan_bounds=tuple(winner.bounds) if winner.pp > 1 else None)
    return base


def _model_tp_widths(arch: str, world: int) -> List[int]:
    """The tp widths the Megatron splitter can actually EXECUTE for
    ``arch``: they must divide the world, the head count, d_model, and
    the MLP width (models/transformer.py's tp_split_layer_params). Archs
    without sliced attention blocks (LSTM seq2seq, image models) get
    none: the planner must never emit a plan the engine cannot run."""
    import ddlbench_tpu_torch.models.moe as moe
    import ddlbench_tpu_torch.models.seq2seq as seq2seq
    import ddlbench_tpu_torch.models.transformer as tr

    v = (tr._VARIANTS.get(arch) or seq2seq._VARIANTS.get(arch)
         or moe._VARIANTS.get(arch))
    if not v or "n_heads" not in v:
        return []
    d, h = v["d_model"], v["n_heads"]
    mlp = 4 * d  # the transformer block's mlp_ratio=4 FFN width
    return [t for t in (2, 4, 8)
            if world % t == 0 and h % t == 0 and d % t == 0
            and mlp % t == 0]


def plan_for_config(cfg: RunConfig, input_time_ms: float = 0.0,
                    device=None) -> Tuple[PlanResult, Dict[str, object],
                                          Graph]:
    """Profile ``cfg``'s model (``cfg.profile_mode``; "time" on
    ``device``, the card unless the CPU is asked for) and solve the mix:
    returns (plan, cfg-replace kwargs, profile graph)."""
    from ddlbench_tpu_torch.models.branchy import get_dag
    from ddlbench_tpu_torch.profiler.profile import (fold_input_node,
                                                     profile_model)

    spec = cfg.dataset()
    if get_dag(cfg.arch, spec.image_size, spec.num_classes) is not None:
        raise ValueError(
            f"--plan auto covers chain archs; {cfg.arch!r} is a branchy "
            f"DAG — use --auto-partition (its packed-boundary chainization "
            f"solves the split at a fixed strategy)")
    mb, chunks = cfg.resolved_batches()
    model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed,
                      moe_capacity_factor=cfg.moe_capacity_factor)
    if cfg.profile_mode == "time":
        from ddlbench_tpu_torch.device import resolve_device

        model = model.to(resolve_device(
            None if device is None else str(device)))
    graph = profile_model(model, mb, mode=cfg.profile_mode, hw=cfg.hardware,
                          input_time_ms=input_time_ms)
    del model
    graph = fold_input_node(graph)
    token_model = spec.kind in ("tokens", "seq2seq")
    plan = solve_plan(
        graph, cfg.num_devices, mb, chunks, cfg.hardware,
        optimizer=cfg.resolved_optimizer(), token_model=token_model,
        tp_candidates=(_model_tp_widths(cfg.arch, cfg.num_devices)
                       if token_model else []),
        remat=cfg.remat_stages, zero1="moe" not in cfg.arch,
        h2_stash=cfg.zb_h2_stash,
        search_budget=cfg.sched_search_budget,
        search_seed=cfg.sched_search_seed)
    rewrite = _rewrite_fields(cfg, plan.winner, mb, chunks)
    return plan, rewrite, graph


def _apply_rewrite(cfg: RunConfig, rewrite: Dict[str, object]) -> RunConfig:
    kw = dict(rewrite)
    if kw.get("plan_bounds") is not None:
        kw["plan_bounds"] = tuple(int(x) for x in kw["plan_bounds"])
    out = cfg.replace(**kw)
    out.validate()
    return out


def _broadcast_json(obj, comm):
    """Rank 0's JSON-able ``obj`` on every rank of ``comm``."""
    import torch

    data = json.dumps(obj).encode() if comm.rank == 0 else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=comm.device)
    comm.broadcast(n)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=comm.device)
    if comm.rank == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    comm.broadcast(buf)
    return json.loads(bytes(buf.cpu().tolist()).decode())


def resolve_auto_plan(cfg: RunConfig, input_time_ms=0.0, device=None,
                      comm=None) -> RunConfig:
    """The ``--plan auto`` entry point: returns the config rewritten onto
    the winning mix (a plan='manual' config, equal to the explicit
    flags). ``input_time_ms`` may be a zero-arg callable (the on-disk
    loader's probe), evaluated only where the plan is solved. On the
    ranks of ``comm`` rank 0 solves and broadcasts the rewrite, so every
    rank runs the same plan (a "time" profile differs from run to run)."""
    if cfg.plan != "auto":
        return cfg
    cfg.validate()
    if comm is None or comm.rank == 0:
        if callable(input_time_ms):
            input_time_ms = input_time_ms()
        plan, rewrite, _ = plan_for_config(cfg, input_time_ms=input_time_ms,
                                           device=device)
        w = plan.winner
        print(f"plan auto: {plan.reason}", flush=True)
        print(f"plan auto: executing pp={w.pp} dp={w.dp} tp={w.tp} "
              f"@{w.schedule} (bounds="
              f"{list(w.bounds) if w.bounds else None}, predicted "
              f"{w.step_time_ms:.3f} ms/step, peak "
              f"{w.peak_bytes_per_chip / 2**30:.3f} GiB/chip; "
              f"{len(plan.candidates)} candidates considered)", flush=True)
        rewrite = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in rewrite.items()}
    else:
        rewrite = None
    if comm is not None and comm.world > 1:
        rewrite = _broadcast_json(rewrite, comm)
    return _apply_rewrite(cfg, rewrite)
