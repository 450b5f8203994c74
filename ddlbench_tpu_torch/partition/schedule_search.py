"""The port's copy of ``ddlbench_tpu/partition/schedule_search.py``
(numpy only; ``pipe_schedule="searched"``). Searched pipeline timetables: budgeted local search over event orders.

The heuristic factory (partition/schedule.py) picks the better of exactly
two candidates per schedule family — the cost-aware greedy table and the
unit-cost order repriced under true costs. On genuinely uneven profiled
chunks both leave bubble on the table: the greedy commits one device at a
time and the unit order was packed for the F=B=W fiction. This module is
the Piper direction (PAPERS.md 2606.11169: search the schedule space,
don't hand-pick a point) on top of that machinery:

* **Representation.** A schedule is its PER-DEVICE EVENT ORDER — one
  tuple of (kind, chunk, microbatch) per device. Start times are derived
  by list-scheduling (:func:`simulate_orders`): each device runs its
  events in order, each starting at max(device free, producer end). The
  cross-device interleaving of independent events therefore never needs
  to be searched — only the per-device orders do.
* **Seeds.** Both heuristics of every 1F1B-memory family
  (``SEARCH_SEED_SCHEDULES``: 1f1b and zero-bubble; fill-drain is the
  autodiff scan, zero-bubble-h2 trades memory) — so the searched table
  NEVER packs worse than the min-of-two-heuristics the factory shipped
  before this module existed.
* **Moves.** Deterministic first-improvement ADJACENT-SWAP sweeps per
  device, then seeded random SHIFT moves (pull one event a few slots
  earlier/later) with the remaining budget. Every move is evaluated by
  re-simulation; strictly-better makespan only (busy cells are fixed, so
  minimizing makespan IS minimizing the bubble fraction).
* **Legality.** A move must keep the per-device order schedulable (the
  list scheduler deadlocks otherwise → move rejected) and within the
  1F1B in-flight cap ``min(M, C - c)`` per chunk — a pure ORDER property
  (:func:`caps_ok`), so searched tables inherit 1F1B activation memory
  and the planner prices them with the same ``min(M, pp)`` stash term.
  :func:`check_legal` is the public validator every generated table —
  heuristic or searched — must pass (the pipesched suite pins a
  hand-corrupted table failing it).
* **Determinism.** Fixed move budget + ``np.random.default_rng(seed)``:
  the same (S, M, V, costs, budget, seed) reproduces the table bitwise,
  which is what makes :func:`searched_timetable` ``lru_cache``-able and
  the planner's pricing stable across re-plans.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ddlbench_tpu_torch.partition.schedule import (
    EVENT_BWD_IN, EVENT_BWD_W, EVENT_FWD, SEARCH_SEED_SCHEDULES,
    CostVectors, Timetable, _greedy_timetable, normalize_costs,
    reprice_timetable, timetable_from_times)

# (kind, chunk, microbatch) — one entry per event, per device, in order
DeviceOrders = Tuple[Tuple[Tuple[int, int, int], ...], ...]


def orders_of(tt: Timetable) -> DeviceOrders:
    """``tt``'s per-device event order (the search representation)."""
    per_dev: Dict[int, List[Tuple[int, int, int, int]]] = {
        s: [] for s in range(tt.num_stages)}
    for kind in (EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W):
        for (c, m), h in tt.event_times(kind).items():
            per_dev[c % tt.num_stages].append((h, kind, c, m))
    return tuple(tuple((k, c, m) for _, k, c, m in sorted(per_dev[s]))
                 for s in range(tt.num_stages))


def simulate_orders(orders: DeviceOrders, S: int, V: int, M: int,
                    costs: Optional[CostVectors]):
    """List-schedule per-device orders into start times: every device runs
    its events in order, each starting at max(device free, producer end).
    Returns ``(F, B, W, makespan)`` start-time tables, or None when the
    order deadlocks (a device's head waits on an event stuck behind it) —
    the searched packer's illegal-move signal."""
    C = S * V
    fc, bc, wc = costs if costs is not None else ((1,) * C,) * 3
    F: Dict[Tuple[int, int], int] = {}
    B: Dict[Tuple[int, int], int] = {}
    W: Dict[Tuple[int, int], int] = {}
    free = [0] * S
    ptr = [0] * S
    placed, total = 0, sum(len(o) for o in orders)
    while placed < total:
        progressed = False
        for s in range(S):
            while ptr[s] < len(orders[s]):
                kind, c, m = orders[s][ptr[s]]
                if kind == EVENT_FWD:
                    if c > 0 and (c - 1, m) not in F:
                        break
                    arrival = 0 if c == 0 else F[(c - 1, m)] + fc[c - 1]
                    start = max(free[s], arrival)
                    F[(c, m)] = start
                    free[s] = start + fc[c]
                elif kind == EVENT_BWD_IN:
                    if (c, m) not in F or (c < C - 1 and (c + 1, m) not in B):
                        break
                    arrival = (F[(c, m)] + fc[c] if c == C - 1
                               else B[(c + 1, m)] + bc[c + 1])
                    start = max(free[s], arrival, F[(c, m)] + fc[c])
                    B[(c, m)] = start
                    free[s] = start + bc[c]
                else:
                    if (c, m) not in B:
                        break
                    start = max(free[s], B[(c, m)] + bc[c])
                    W[(c, m)] = start
                    free[s] = start + wc[c]
                ptr[s] += 1
                placed += 1
                progressed = True
        if not progressed:
            return None
    return F, B, W, max(free)


def caps_ok(orders: DeviceOrders, S: int, V: int, M: int,
            extra_inflight: int = 0) -> bool:
    """True when every device order respects the per-chunk in-flight cap
    ``min(M, C - c + extra_inflight)`` (microbatches with F scheduled, B
    not). A pure ORDER property: all of a chunk's F and B events live on
    one device, and any rebuild that preserves per-device order preserves
    their interleaving — so the searched packer can reject cap-busting
    moves without a simulation."""
    C = S * V
    for order in orders:
        inflight: Dict[int, int] = {}
        for kind, c, _m in order:
            if kind == EVENT_FWD:
                inflight[c] = inflight.get(c, 0) + 1
                if inflight[c] > min(M, C - c + extra_inflight):
                    return False
            elif kind == EVENT_BWD_IN:
                inflight[c] = inflight.get(c, 0) - 1
    return True


def chunk_inflight(tt: Timetable) -> Tuple[int, ...]:
    """Per-chunk peak in-flight count (F scheduled, B not) — the
    activation-stash high-water the schedule implies, per chunk."""
    orders = orders_of(tt)
    C = tt.num_chunks
    peak = [0] * C
    for order in orders:
        inflight: Dict[int, int] = {}
        for kind, c, _m in order:
            if kind == EVENT_FWD:
                inflight[c] = inflight.get(c, 0) + 1
                peak[c] = max(peak[c], inflight[c])
            elif kind == EVENT_BWD_IN:
                inflight[c] = inflight.get(c, 0) - 1
    return tuple(peak)


def check_legal(tt: Timetable, extra_inflight: Optional[int] = 0) -> None:
    """The legality validator every generated table — heuristic or
    searched — must pass. Raises AssertionError with the violated
    relation.

    * per-stage serialization + F→B→W microbatch dependencies + event
      coverage + chunk locality: :meth:`Timetable.validate`;
    * in-flight/stash caps: per-chunk peak in-flight (F done, B not) must
      stay within ``min(M, C - c + extra_inflight)``. ``extra_inflight=0``
      is the strict 1F1B cap (1f1b / zero-bubble / searched tables);
      ZB-H2 passes its stash; ``None`` skips the cap check (fill-drain
      legitimately holds all M microbatches in flight).
    """
    tt.validate()
    if extra_inflight is None:
        return
    C, M = tt.num_chunks, tt.num_microbatches
    peaks = chunk_inflight(tt)
    for c in range(C):
        cap = min(M, C - c + extra_inflight)
        assert peaks[c] <= cap, (
            f"{tt.name}: chunk {c} holds {peaks[c]} microbatches in "
            f"flight; cap is {cap} (extra_inflight={extra_inflight})")


def _seed_tables(S: int, M: int, V: int,
                 costs: Optional[CostVectors]) -> List[Timetable]:
    """Both heuristics of every seed family: the cost-aware greedy table
    and the unit-cost order repriced under true costs — exactly the
    candidates the factory's min-of-two picks from, so the searched
    result is ≤ that min by construction."""
    seeds: List[Timetable] = []
    for name in SEARCH_SEED_SCHEDULES:
        defer = name == "zero-bubble"
        unit = _greedy_timetable(name, S, M, V, defer_weight_grads=defer)
        if costs is None:
            seeds.append(unit)
        else:
            seeds.append(_greedy_timetable(name, S, M, V,
                                           defer_weight_grads=defer,
                                           costs=costs))
            seeds.append(reprice_timetable(unit, costs))
    return seeds


@functools.lru_cache(maxsize=32)
def searched_timetable(S: int, M: int, V: int = 1,
                       costs: Optional[CostVectors] = None,
                       budget: int = 256, seed: int = 0) -> Timetable:
    """Budgeted local search over per-device event orders (module
    docstring). ``budget`` counts move EVALUATIONS (simulations) across
    all seeds; ``seed`` drives the shift-move rng. Deterministic and
    cached: the same arguments reproduce the table bitwise."""
    costs = normalize_costs(costs, S * V)
    seeds = _seed_tables(S, M, V, costs)
    # baseline: the best seed TABLE (legal by construction); the search
    # only ever replaces it with a strictly shorter simulated schedule
    best_tt = min(seeds, key=lambda t: (t.half_ticks, t.name))
    best_span = best_tt.half_ticks
    best_times = None  # (F, B, W) when a searched order beat every seed

    rng = np.random.default_rng(seed)
    remaining = max(0, int(budget))

    def evaluate(orders: DeviceOrders):
        nonlocal remaining
        if remaining <= 0:
            return None
        remaining -= 1
        if not caps_ok(orders, S, V, M):
            return None
        return simulate_orders(orders, S, V, M, costs)

    for tt in seeds:
        if remaining <= 0:
            break
        cur = [list(o) for o in orders_of(tt)]
        sim = simulate_orders(tuple(tuple(o) for o in cur), S, V, M, costs)
        assert sim is not None, "seed order must be schedulable"
        cur_span = sim[3]
        if cur_span < best_span:
            best_span, best_times, best_tt = cur_span, sim[:3], tt
        # deterministic first-improvement adjacent-swap sweeps
        improved = True
        while improved and remaining > 0:
            improved = False
            for s in range(S):
                for i in range(len(cur[s]) - 1):
                    if remaining <= 0:
                        break
                    cur[s][i], cur[s][i + 1] = cur[s][i + 1], cur[s][i]
                    sim = evaluate(tuple(tuple(o) for o in cur))
                    if sim is not None and sim[3] < cur_span:
                        cur_span, improved = sim[3], True
                        if cur_span < best_span:
                            best_span, best_times = cur_span, sim[:3]
                            best_tt = tt
                    else:
                        cur[s][i], cur[s][i + 1] = cur[s][i + 1], cur[s][i]
        # seeded random shift moves with this seed's share of the budget
        share = remaining // max(1, len(seeds))
        for _ in range(share):
            if remaining <= 0:
                break
            s = int(rng.integers(S))
            n = len(cur[s])
            if n < 2:
                continue
            i = int(rng.integers(n))
            j = int(rng.integers(max(0, i - 3), min(n, i + 4)))
            if i == j:
                continue
            moved = cur[s][:]
            moved.insert(j, moved.pop(i))
            trial = [o[:] for o in cur]
            trial[s] = moved
            sim = evaluate(tuple(tuple(o) for o in trial))
            if sim is not None and sim[3] < cur_span:
                cur, cur_span = trial, sim[3]
                if cur_span < best_span:
                    best_span, best_times = cur_span, sim[:3]
                    best_tt = tt
    if best_times is None:
        out = dataclasses.replace(best_tt, name="searched")
    else:
        F, B, W = best_times
        out = timetable_from_times("searched", S, V, M, F, B, W, costs)
    check_legal(out, extra_inflight=0)
    return out
