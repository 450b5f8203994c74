"""The port's copy of ``ddlbench_tpu/partition/schedule.py`` (numpy only;
the pipeline engines of ``ddlbench_tpu_torch/parallel/`` execute these
tables, tests/test_torch_pipe_schedule.py pins them equal to the
reference's). Pipeline-schedule math: timetables as DATA, bubble fractions, advice.

The schedule-programmable pipeline runtime (parallel/pipeline_rt.py)
consumes a :class:`Timetable` — a dense ``(half_tick, device) -> {fwd,
bwd_input, bwd_weight, idle}`` description — rather than baking a schedule
into engine code (Piper's "schedules are descriptions" design, PAPERS.md).
This module is where the shipped schedule FAMILY lives:

* ``fill-drain``   — GPipe: all forwards flush through, then the combined
  backward drains in reverse (the autodiff schedule of parallel/gpipe.py).
* ``1f1b``         — synchronous 1F1B: warmup of ``S-1-s`` forwards per
  stage, then one-forward-one-backward steady state; same weights for every
  microbatch (no stashing, unlike pipedream's ASYNC 1F1B). At V > 1 it IS
  the interleaved table (the composed schedule, not an error).
* ``interleaved``  — interleaved 1F1B over ``C = S*V`` model chunks
  (generalizing ``cfg.virtual_stages`` beyond the fill-drain schedule).
* ``zero-bubble``  — ZB-H1-style: the backward is split into an input-grad
  event (B, produces the upstream cotangent) and a weight-grad event (W,
  consumes the stashed input + cotangent), and W is deferred to fill the
  fill/drain bubbles. At V > 1 the same W-deferral composes with the
  interleaved chunk rows (``defer_weight_grads`` over C = S*V chunks).
* ``zero-bubble-h2`` — ZB-H2-style: the 1F1B in-flight cap is lifted by a
  configurable extra activation stash (``stash`` microbatches per chunk)
  and up to ``stash`` trailing W events per chunk are DEFERRED PAST THE
  STEP BOUNDARY into the next step's warmup idle. Execution stays linear
  (the deferred W events still run at the step's tail, before the
  optimizer update, so per-step math is unchanged and trajectories stay
  pinned); the deferral is the STEADY-STATE accounting —
  :meth:`Timetable.bubble_fraction` prices the wrapped period
  :meth:`Timetable.steady_period` instead of the linear makespan. The
  extra stash is priced into the planner's memory term, so a tight
  ``--hbm-gb`` cap can reject H2 for exactly that memory.
* ``searched``     — partition/schedule_search.py: deterministic budgeted
  local search (per-device swap/shift moves on the weighted event grid,
  seeded by BOTH heuristics of every 1F1B-memory family) that never packs
  worse than the min-of-two-heuristics table and strictly beats it on
  genuinely uneven profiled costs.

Event cost model (the half-tick grid): one F, one B (input grad) or one W
(weight grad) each occupy ONE half-tick, one event per device per half-tick
— the F = B = W unit-cost model of the zero-bubble literature. A legacy
combined backward is B immediately followed by W (2 half-ticks). Activation
handoffs take one half-tick (ring ppermute), so F(c+1, m) and B(c, m) run
at least one half-tick after their producers.

Analytic bubble fractions under this model, at equal (S, M), V = 1::

    fill-drain:   3(S-1) / (3M + 3(S-1))  =  (S-1)/(M+S-1)
    1f1b:         2(S-1) / (3M + 2(S-1))          (< fill-drain: the split
                  W lets stage s-1's B start under stage s's W in the drain)
    interleaved:  == 1f1b at V=1; fill/drain cost shrinks toward /V as the
                  per-device chunks interleave (measured from the table)
    zero-bubble:   (S-1) / (3M + 1(S-1))          (deferred W fills the
                  drain; only the F fill bubble remains)

so ``zero-bubble < 1f1b <= interleaved < fill-drain`` — the ordering the
schedule-parity suite pins. ``1f1b``/``zero-bubble`` formulas are verified
against the table-derived fractions in tests/test_pipeline_rt.py.

Cost-aware timetables (ISSUE 8): every generator also accepts per-chunk
``costs = (f, b, w)`` — three length-C tuples of positive ints pricing each
chunk's F/B/W event in half-ticks — so the auto-partitioner's deliberately
UNEVEN stage splits get timetables packed for their true costs instead of
the F=B=W unit fiction. An event occupies ``cost`` consecutive grid cells;
``event_times`` reports START half-ticks, handoffs remain one half-tick
after the producer's END, and ``validate``/``ring_slots``/
``bubble_fraction`` generalize (a weighted cell grid's idle fraction IS the
weighted bubble). Unit costs reproduce the PR 7 tables bitwise (pinned by
tests/test_schedule_costs.py); :func:`quantize_cost_vectors` maps profiled
per-chunk milliseconds onto the integer grid, and
:func:`reprice_timetable` re-simulates a unit-cost table's event ORDER
under true costs — the baseline a cost-aware table must beat.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

# Event codes (Timetable.events values). IDLE must stay 0 (zeros padding).
EVENT_IDLE, EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W = 0, 1, 2, 3
EVENT_NAMES = ("idle", "F", "B", "W")

PIPE_SCHEDULES = ("fill-drain", "1f1b", "interleaved", "zero-bubble",
                  "zero-bubble-h2", "searched")

# the 1F1B-memory event family the searched packer draws its seeds from
# (fill-drain is the autodiff scan; zero-bubble-h2 trades memory for its
# bubble, so a searched table must not silently inherit its lifted cap)
SEARCH_SEED_SCHEDULES = ("1f1b", "zero-bubble")

# costs = (f, b, w): three length-C tuples of positive ints, half-ticks per
# chunk event. None = the F=B=W unit-cost model.
CostVectors = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]


def normalize_costs(costs, num_chunks: int) -> Optional[CostVectors]:
    """Canonical cost vectors: three length-``num_chunks`` int tuples, all
    >= 1; all-unit vectors normalize to None (the closed-form unit paths
    are then taken, which is what makes "unit costs reproduce the legacy
    tables bitwise" true by routing as well as by construction)."""
    if costs is None:
        return None
    if len(costs) != 3:
        raise ValueError(f"costs must be (f, b, w) vectors; got {costs!r}")
    out = []
    for vec in costs:
        vec = tuple(int(v) for v in vec)
        if len(vec) != num_chunks:
            raise ValueError(
                f"cost vector length {len(vec)} != num_chunks {num_chunks}")
        if any(v < 1 for v in vec):
            raise ValueError(f"event costs must be >= 1 half-tick; got {vec}")
        out.append(vec)
    f, b, w = out
    if all(v == 1 for v in f + b + w):
        return None
    return (f, b, w)


@dataclasses.dataclass(frozen=True)
class Timetable:
    """One pipeline schedule as data, on the global half-tick grid.

    ``events[h, s]`` is the event device ``s`` executes at half-tick ``h``
    (EVENT_* code), ``mbs[h, s]`` the microbatch index (-1 when idle) and
    ``chunks[h, s]`` the model-chunk index ``c = v*S + s`` it applies to
    (-1 when idle; always the device's own chunk row, i.e. c % S == s).
    """

    name: str
    num_stages: int
    virtual_stages: int
    num_microbatches: int
    events: np.ndarray  # [H, S] int8
    mbs: np.ndarray  # [H, S] int32
    chunks: np.ndarray  # [H, S] int32
    # per-chunk (f, b, w) half-tick costs; None = unit-cost model. A
    # weighted event occupies ``cost`` consecutive grid cells starting at
    # its event_times() half-tick.
    costs: Optional[CostVectors] = None
    # (chunk, microbatch) W events the STEADY-STATE model defers past the
    # step boundary (ZB-H2): they are still painted (and executed) at the
    # step's tail — per-step math unchanged — but bubble_fraction prices
    # the wrapped steady_period instead of the linear makespan, because in
    # back-to-back steps those cells overlap the next step's warmup idle.
    deferred_w: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def num_chunks(self) -> int:
        return self.num_stages * self.virtual_stages

    @property
    def half_ticks(self) -> int:
        return int(self.events.shape[0])

    def cost_of(self, kind: int, chunk: int) -> int:
        """Half-ticks event ``kind`` occupies on ``chunk`` (1 when unit)."""
        if self.costs is None:
            return 1
        return self.costs[kind - EVENT_FWD][chunk]

    # -- derived figures ---------------------------------------------------

    def bubble_fraction(self) -> float:
        """Idle fraction of the device-time grid: idle half-ticks over
        S * H. This is THE schedule's analytic bubble — the runtime executes
        the table verbatim, and telemetry/bubble.py measures the same
        quantity from emitted tick spans.

        With ``deferred_w`` set (ZB-H2) the fraction is priced over the
        STEADY-STATE period instead: idle cells over
        ``S * steady_period()``. A single linear step still measures the
        grid fraction (``bubble_is_estimate`` flags exactly this gap for
        telemetry consumers)."""
        total = self.events.size
        busy = int(np.count_nonzero(self.events))
        if not total:
            return 0.0
        if self.deferred_w:
            P = self.steady_period()
            return (self.num_stages * P - busy) / (self.num_stages * P)
        return (total - busy) / total

    def steady_period(self) -> int:
        """Half-ticks per step in the back-to-back steady state.

        Without deferral this is the linear makespan (the grid height H).
        With ``deferred_w``, each stage's deferred tail-W cells wrap into
        the NEXT step's idle, so the per-stage period is
        ``max(end of last non-deferred event, total busy cells)`` — the
        first term keeps the in-step critical path, the second is work
        conservation (wrapped cells must fit in that stage's idle). The
        step period is the max over stages."""
        if not self.deferred_w:
            return self.half_ticks
        deferred = set(self.deferred_w)
        S = self.num_stages
        busy = [0] * S
        e_nondef = [0] * S
        for kind in (EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W):
            for (c, m), h in self.event_times(kind).items():
                s = c % S
                cost = self.cost_of(kind, c)
                busy[s] += cost
                if not (kind == EVENT_BWD_W and (c, m) in deferred):
                    e_nondef[s] = max(e_nondef[s], h + cost)
        return max(max(e_nondef[s], busy[s]) for s in range(S))

    def event_times(self, kind: int) -> Dict[Tuple[int, int], int]:
        """{(chunk, microbatch): START half_tick} for one event kind.
        Weighted events fill ``cost`` consecutive cells; np.nonzero walks
        h-ascending, so the first cell seen is the start."""
        out: Dict[Tuple[int, int], int] = {}
        hs, ss = np.nonzero(self.events == kind)
        for h, s in zip(hs.tolist(), ss.tolist()):
            out.setdefault(
                (int(self.chunks[h, s]), int(self.mbs[h, s])), int(h))
        return out

    def validate(self) -> None:
        """Dependency-correctness: every (chunk, mb) runs F once, B once,
        W once, in an order that respects the one-half-tick handoffs —
        generalized to weighted events (a consumer may start no earlier
        than its producer's END, i.e. start + cost). Raises AssertionError
        with the violated relation."""
        S, V, M, C = (self.num_stages, self.virtual_stages,
                      self.num_microbatches, self.num_chunks)
        F = self.event_times(EVENT_FWD)
        B = self.event_times(EVENT_BWD_IN)
        W = self.event_times(EVENT_BWD_W)
        fc = lambda c: self.cost_of(EVENT_FWD, c)
        bc = lambda c: self.cost_of(EVENT_BWD_IN, c)
        wc = lambda c: self.cost_of(EVENT_BWD_W, c)
        for table, nm in ((F, "F"), (B, "B"), (W, "W")):
            assert len(table) == C * M, (
                f"{self.name}: {nm} covers {len(table)} of {C * M} "
                f"(chunk, microbatch) events")
        for c in range(C):
            for m in range(M):
                f, b, w = F[(c, m)], B[(c, m)], W[(c, m)]
                if c > 0:
                    assert f >= F[(c - 1, m)] + fc(c - 1), (
                        f"{self.name}: F({c},{m})@{f} before its input "
                        f"arrives (producer F({c - 1},{m})@{F[(c - 1, m)]}"
                        f"+{fc(c - 1)})")
                if c < C - 1:
                    assert b >= B[(c + 1, m)] + bc(c + 1), (
                        f"{self.name}: B({c},{m})@{b} before its cotangent "
                        f"arrives (producer B({c + 1},{m})@{B[(c + 1, m)]}"
                        f"+{bc(c + 1)})")
                assert b >= f + fc(c), (
                    f"{self.name}: B({c},{m})@{b} not after its F@{f}"
                    f"+{fc(c)}")
                assert w >= b + bc(c), (
                    f"{self.name}: W({c},{m})@{w} not after B@{b}+{bc(c)}")
        # one event per device per half-tick is structural ([H, S] grid)
        # PROVIDED no generator overwrote a cell: the busy-cell count must
        # equal the summed event costs (catches overlapping placements)
        busy = int(np.count_nonzero(self.events))
        expect = M * sum(fc(c) + bc(c) + wc(c) for c in range(C))
        assert busy == expect, (
            f"{self.name}: {busy} busy cells != {expect} summed event "
            f"costs (overlapping weighted events?)")
        # chunk-locality: every event's chunk lives on its device
        hs, ss = np.nonzero(self.events)
        assert all(int(self.chunks[h, s]) % S == s
                   for h, s in zip(hs.tolist(), ss.tolist())), (
            f"{self.name}: an event landed on a foreign device")
        if self.deferred_w:
            # ZB-H2 accounting soundness: a deferred W must be a real W
            # event forming its stage's TAIL (it starts at/after every
            # non-deferred event on that stage ends), so wrapping it into
            # the next period cannot collide with in-step work
            deferred = set(self.deferred_w)
            for (c, m) in deferred:
                assert (c, m) in W, (
                    f"{self.name}: deferred_w ({c},{m}) is not a W event")
            e_nondef = [0] * S
            for table, kind in ((F, EVENT_FWD), (B, EVENT_BWD_IN),
                                (W, EVENT_BWD_W)):
                for (c, m), h in table.items():
                    if kind == EVENT_BWD_W and (c, m) in deferred:
                        continue
                    s = c % S
                    e_nondef[s] = max(e_nondef[s],
                                      h + self.cost_of(kind, c))
            for (c, m) in deferred:
                assert W[(c, m)] >= e_nondef[c % S], (
                    f"{self.name}: deferred W({c},{m})@{W[(c, m)]} is not "
                    f"its stage's tail (non-deferred work ends at "
                    f"{e_nondef[c % S]})")

    def forward_tick_arrays(self) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """The F events of the leading forward phase as per-tick arrays
        ``(v, m, valid)``, each ``[T, S]`` with ``T = M*V + S - 1`` — what
        the autodiff (fill-drain) runtime scans over; the backward half of
        the table is realized by jax.grad reversing that scan. Only
        meaningful for fill-drain (whose forward phase IS its first T
        half-ticks); asserts that shape."""
        assert self.costs is None, (
            f"{self.name}: the autodiff (fill-drain) runtime executes the "
            f"unit-cost schedule only; weighted tables are event-mode/"
            f"analysis data")
        S, V, M = self.num_stages, self.virtual_stages, self.num_microbatches
        T = M * V + S - 1
        fwd = self.events[:T] == EVENT_FWD
        assert int(np.count_nonzero(fwd)) == S * V * M, (
            f"{self.name}: forward phase is not the leading {T} half-ticks")
        v = np.where(fwd, self.chunks[:T] // S, 0).astype(np.int32)
        m = np.where(fwd, self.mbs[:T], 0).astype(np.int32)
        return v, m, fwd.astype(np.bool_)

    def max_inflight(self) -> int:
        """Max microbatches any chunk holds stashed at once (F done, W not)
        — the activation-memory high-water mark the schedule implies."""
        F = self.event_times(EVENT_FWD)
        W = self.event_times(EVENT_BWD_W)
        worst = 0
        for c in range(self.num_chunks):
            spans = [(F[(c, m)], W[(c, m)])
                     for m in range(self.num_microbatches)]
            for h in range(self.half_ticks):
                worst = max(worst, sum(1 for a, b in spans if a <= h < b))
        return worst

    def engine_arrays(self) -> Dict[str, np.ndarray]:
        """Everything the event-mode runtime (parallel/pipeline_rt.py)
        needs to EXECUTE this table, precomputed on the host:

        * ``ev/vrow/mb [He, S]`` — the EXECUTION grid over the He ticks on
          which at least one device dispatches an event (for unit-cost
          tables every busy half-tick; for weighted tables the event START
          ticks — the in-between cells only model predicted duration, and
          compressing them out keeps the compiled scan length equal to the
          event count instead of the weighted makespan). -1s are clipped
          to 0, ev==IDLE masks them;
        * forward-arrival routing ``fa_valid/fa_row/fa_m [He, S]`` — at
          execution tick i, device s's ring buffer holds the activation
          chunk ``vrow*S + s`` sent by its left neighbor's F dispatched at
          tick i-1 (V>1 wrap transfers are baked into the row index);
        * backward-arrival routing ``ba_* [He, S]`` — same for cotangents
          from the right neighbor's B events;
        * ring sizes ``nq_f/nq_b`` (arrival->use queues, slot = m % n) and
          ``ns_x/ns_g`` (F->W input stash, B->W cotangent stash).
        """
        S, V, M, C = (self.num_stages, self.virtual_stages,
                      self.num_microbatches, self.num_chunks)
        F = self.event_times(EVENT_FWD)
        B = self.event_times(EVENT_BWD_IN)
        W = self.event_times(EVENT_BWD_W)
        # execution ticks: every half-tick where some device STARTS an
        # event. Dependency-correct by construction: a consumer's start is
        # a later execution tick than its producer's, and physical ring
        # arrivals land one EXECUTION tick after the producer's dispatch
        # (the engine ships at the dispatch tick regardless of the
        # modelled duration).
        starts = sorted({h for d in (F, B, W) for h in d.values()})
        idx = {h: i for i, h in enumerate(starts)}
        He = len(starts)
        ev = np.zeros((He, S), np.int32)
        vrow = np.zeros((He, S), np.int32)
        mb = np.zeros((He, S), np.int32)
        fa_valid = np.zeros((He, S), np.bool_)
        fa_row = np.zeros((He, S), np.int32)
        fa_m = np.zeros((He, S), np.int32)
        ba_valid = np.zeros((He, S), np.bool_)
        ba_row = np.zeros((He, S), np.int32)
        ba_m = np.zeros((He, S), np.int32)
        for table, kind in ((F, EVENT_FWD), (B, EVENT_BWD_IN),
                            (W, EVENT_BWD_W)):
            for (c, m), h in table.items():
                i = idx[h]
                ev[i, c % S] = kind
                vrow[i, c % S] = c // S
                mb[i, c % S] = m
        for (c, m), h in F.items():
            if c < C - 1:  # last chunk's output is the loss, never shipped
                dev = (c + 1) % S
                fa_valid[idx[h] + 1, dev] = True
                fa_row[idx[h] + 1, dev] = (c + 1) // S
                fa_m[idx[h] + 1, dev] = m
        for (c, m), h in B.items():
            if c > 0:  # chunk 0's input grad has no consumer
                dev = (c - 1) % S
                ba_valid[idx[h] + 1, dev] = True
                ba_row[idx[h] + 1, dev] = (c - 1) // S
                ba_m[idx[h] + 1, dev] = m
        # ring live-ranges in EXECUTION ticks (write = arrival, one tick
        # after the producer's dispatch; read = the consumer's dispatch)
        Fi = {k: idx[h] for k, h in F.items()}
        Bi = {k: idx[h] for k, h in B.items()}
        Wi = {k: idx[h] for k, h in W.items()}
        interior = {(c, m): t for (c, m), t in Fi.items() if c > 0}
        return {
            "ev": ev,
            "vrow": vrow,
            "mb": mb,
            "fa_valid": fa_valid, "fa_row": fa_row, "fa_m": fa_m,
            "ba_valid": ba_valid, "ba_row": ba_row, "ba_m": ba_m,
            "nq_f": ring_slots(
                {k: Fi[(k[0] - 1, k[1])] + 1 for k in interior},
                interior, C, M),
            "nq_b": ring_slots(
                {(c, m): Bi[(c + 1, m)] + 1 for (c, m) in Bi if c < C - 1},
                {k: Bi[k] for k in Bi if k[0] < C - 1}, C, M),
            "ns_x": ring_slots(interior,
                               {k: Wi[k] for k in interior}, C, M),
            "ns_g": ring_slots({k: Bi[k] for k in Bi if k[0] < C - 1},
                               {k: Wi[k] for k in Wi if k[0] < C - 1}, C, M),
        }


def ring_slots(writes: Dict[Tuple[int, int], int],
               reads: Dict[Tuple[int, int], int],
               num_chunks: int, num_microbatches: int) -> int:
    """Smallest ring size ``n`` such that slot ``m % n`` never holds two
    live values at once (live = [write half-tick, read half-tick]). The
    runtime sizes its stash/queue rings with this, per table, on the host.
    """
    for n in range(1, num_microbatches + 1):
        ok = True
        for c in range(num_chunks):
            spans = [(writes[(c, m)], reads[(c, m)], m)
                     for m in range(num_microbatches) if (c, m) in writes]
            for i, (a0, b0, m0) in enumerate(spans):
                for a1, b1, m1 in spans[i + 1:]:
                    if m0 % n == m1 % n and a0 <= b1 and a1 <= b0:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            return n
    return num_microbatches


# -- generators ------------------------------------------------------------


def _empty(H: int, S: int):
    return (np.zeros((H, S), np.int8), np.full((H, S), -1, np.int32),
            np.full((H, S), -1, np.int32))


def _paint(events, mbs, chunks, h: int, s: int, kind: int, c: int, m: int,
           cost: int) -> None:
    """Write one weighted event's ``cost`` consecutive cells."""
    events[h:h + cost, s] = kind
    mbs[h:h + cost, s] = m
    chunks[h:h + cost, s] = c


def fill_drain_timetable(S: int, M: int, V: int = 1,
                         costs: Optional[CostVectors] = None) -> Timetable:
    """GPipe: the forward scan's timetable (chunk c = v*S + s runs
    microbatch m = g*S + r at tick t = g*S*V + v*S + s + r — the same
    closed form parallel/gpipe.py compiles), followed by the reversed
    combined backward: forward tick t replays as B then W at half-ticks
    T + 2*(T-1-t) and T + 2*(T-1-t) + 1 (jax.grad reverses the scan).

    With ``costs``, the same STRUCTURE priced by per-chunk weights: every
    device runs its forwards in the identical (g, v, r) order, each
    starting at max(device free, input arrival = producer start + cost);
    the backward replays the per-device forward order REVERSED after the
    global forward flush, items glued B+W, cotangent arrival = the
    producer's whole reversed-scan item (B+W) completing — the weighted
    generalization of jax.grad's tick-reversed schedule. Unit costs
    reproduce the closed form bitwise (tests/test_schedule_costs.py)."""
    costs = normalize_costs(costs, S * V)
    if costs is None:
        T = M * V + S - 1
        H = 3 * T
        events, mbs, chunks = _empty(H, S)
        for t in range(T):
            for s in range(S):
                u = t - s
                if not 0 <= u < M * V:
                    continue
                g, rem = divmod(u, S * V)
                v, r = divmod(rem, S)
                m = g * S + r
                if m >= M:
                    continue
                c = v * S + s
                events[t, s] = EVENT_FWD
                mbs[t, s], chunks[t, s] = m, c
                tb = T + 2 * (T - 1 - t)
                events[tb, s], events[tb + 1, s] = EVENT_BWD_IN, EVENT_BWD_W
                mbs[tb, s] = mbs[tb + 1, s] = m
                chunks[tb, s] = chunks[tb + 1, s] = c
        return Timetable("fill-drain", S, V, M, events, mbs, chunks)

    fc, bc, wc = costs
    assert M % S == 0 or V == 1, "V > 1 needs M % S == 0"
    F: Dict[Tuple[int, int], int] = {}
    order: Dict[int, List[Tuple[int, int]]] = {s: [] for s in range(S)}
    free = [0] * S
    # forward: per device, (g, v, r) ascending — the closed form's order
    for g in range(-(-M // S)):
        for v in range(V):
            for r in range(S):
                m = g * S + r
                if m >= M:
                    continue
                for s in range(S):
                    c = v * S + s
                    arrival = (0 if c == 0
                               else F[(c - 1, m)] + fc[c - 1])
                    h = max(free[s], arrival)
                    F[(c, m)] = h
                    free[s] = h + fc[c]
                    order[s].append((c, m))
    flush = max(free)  # the synchronous flush: no B before every F ends
    B: Dict[Tuple[int, int], int] = {}
    W: Dict[Tuple[int, int], int] = {}
    free = [flush] * S
    # backward: per device, the forward order reversed, B+W glued; the
    # cotangent arrives when the producer's whole reversed-scan item
    # (its B and its glued W) has completed
    done = [0] * S  # per-device position in the reversed order
    pending = sum(len(order[s]) for s in range(S))
    while pending:
        progressed = False
        for s in range(S):
            while done[s] < len(order[s]):
                c, m = order[s][len(order[s]) - 1 - done[s]]
                if c == S * V - 1:
                    arrival = F[(c, m)] + fc[c]
                elif (c + 1, m) not in B:
                    break  # producer not placed yet; try other devices
                else:
                    arrival = B[(c + 1, m)] + bc[c + 1] + wc[c + 1]
                h = max(free[s], arrival)
                B[(c, m)] = h
                W[(c, m)] = h + bc[c]
                free[s] = h + bc[c] + wc[c]
                done[s] += 1
                pending -= 1
                progressed = True
        assert progressed, "fill-drain backward deadlocked (internal bug)"
    H = max(free)
    events, mbs, chunks = _empty(H, S)
    for (c, m), h in F.items():
        _paint(events, mbs, chunks, h, c % S, EVENT_FWD, c, m, fc[c])
    for (c, m), h in B.items():
        _paint(events, mbs, chunks, h, c % S, EVENT_BWD_IN, c, m, bc[c])
    for (c, m), h in W.items():
        _paint(events, mbs, chunks, h, c % S, EVENT_BWD_W, c, m, wc[c])
    tt = Timetable("fill-drain", S, V, M, events, mbs, chunks, costs)
    tt.validate()
    return tt


@functools.lru_cache(maxsize=64)
def _greedy_timetable(name: str, S: int, M: int, V: int,
                      defer_weight_grads: bool,
                      costs: Optional[CostVectors] = None,
                      extra_inflight: int = 0) -> Timetable:
    """Event-driven greedy generator for the synchronous 1F1B family.

    Closed-form rule set (this IS the schedule description; the dense table
    is its materialization):

    * chunk c runs a warmup of ``C - 1 - c`` forwards, i.e. at most
      ``C - c`` microbatches may be in flight (F done, B not) — the classic
      1F1B in-flight cap over C = S*V chunks. ``extra_inflight`` (ZB-H2)
      LIFTS the cap to ``min(M, C - c + extra_inflight)``: deeper warmup,
      more stashed activations, fewer forced idles;
    * readiness: F(c, m) one half-tick after F(c-1, m) ENDS; B(c, m) one
      after B(c+1, m) ends (after F(c, m) ends on the last chunk); W(c, m)
      any time after B(c, m) ends;
    * per half-tick each FREE device (weighted events keep it busy for
      their whole cost) runs its highest-priority ready event: B first
      (drain the pipe), then — 1f1b — W (the legacy combined backward, W
      glued behind B) or — zero-bubble — F (ZB-H1: W is deferred into
      half-ticks where nothing else is ready, filling the bubbles). Ties
      go to the earliest microbatch, then the deepest chunk.

    With unit costs (``costs is None``) every end is start + 1 and the
    busy-until bookkeeping is a no-op, so the emitted grid is bitwise the
    PR 7 table.
    """
    C = S * V
    fc, bc, wc = costs if costs is not None else ((1,) * C,) * 3
    F: Dict[Tuple[int, int], int] = {}
    B: Dict[Tuple[int, int], int] = {}
    W: Dict[Tuple[int, int], int] = {}
    rows: List[Tuple[int, int, int, int, int, int]] = []
    # per-chunk microbatches in flight (F done, B not), maintained
    # incrementally — the O(M) scan per readiness probe made large-M
    # advisory builds (recommend_virtual_stages) a visible startup stall
    inflight = [0] * C

    def ready_f(c, m, h):
        if (c, m) in F or m >= M:
            return False
        if c > 0 and F.get((c - 1, m), h) + fc[c - 1] > h:
            return False
        return inflight[c] < min(M, C - c + extra_inflight)

    def ready_b(c, m, h):
        if (c, m) in B or (c, m) not in F:
            return False
        if c == C - 1:
            return F[(c, m)] + fc[c] <= h
        return B.get((c + 1, m), h) + bc[c + 1] <= h

    def ready_w(c, m, h):
        return ((c, m) in B and (c, m) not in W
                and B[(c, m)] + bc[c] <= h)

    h = 0
    total = 3 * C * M
    done = 0
    busy = [0] * S  # device s is mid-event until half-tick busy[s]
    max_cost = max(fc + bc + wc)
    while done < total:
        for s in range(S):
            if busy[s] > h:
                continue
            # candidate (priority, m, -c, event, c) rows; lowest wins
            cand = []
            for v in range(V):
                c = v * S + s
                for m in range(M):
                    if ready_b(c, m, h):
                        cand.append((0, m, -c, EVENT_BWD_IN, c))
                    if ready_w(c, m, h):
                        cand.append((2 if defer_weight_grads else 1,
                                     m, -c, EVENT_BWD_W, c))
                    if ready_f(c, m, h):
                        cand.append((1 if defer_weight_grads else 2,
                                     m, -c, EVENT_FWD, c))
            if not cand:
                continue
            _, m, _, ev, c = min(cand)
            {EVENT_FWD: F, EVENT_BWD_IN: B, EVENT_BWD_W: W}[ev][(c, m)] = h
            if ev == EVENT_FWD:
                inflight[c] += 1
            elif ev == EVENT_BWD_IN:
                inflight[c] -= 1
            cost = {EVENT_FWD: fc, EVENT_BWD_IN: bc, EVENT_BWD_W: wc}[ev][c]
            busy[s] = h + cost
            rows.append((h, s, ev, c, m, cost))
            done += 1
        h += 1
        assert h <= (6 * C * M + 6 * C + 16) * max_cost, (
            f"{name}: greedy schedule did not converge (S={S}, V={V}, "
            f"M={M})")
    events, mbs, chunks = _empty(max(busy), S)
    for hh, s, ev, c, m, cost in rows:
        _paint(events, mbs, chunks, hh, s, ev, c, m, cost)
    tt = Timetable(name, S, V, M, events, mbs, chunks, costs)
    tt.validate()
    return tt


def sync_1f1b_timetable(S: int, M: int, V: int = 1,
                        costs: Optional[CostVectors] = None) -> Timetable:
    """Synchronous 1F1B (V=1) / interleaved 1F1B (V>1): same step-start
    weights for every microbatch, grads accumulated, ONE optimizer update
    per step — unlike parallel/pipedream.py's async engine."""
    return _greedy_timetable("1f1b" if V == 1 else "interleaved",
                             S, M, V, defer_weight_grads=False,
                             costs=normalize_costs(costs, S * V))


def zero_bubble_timetable(S: int, M: int, V: int = 1,
                          costs: Optional[CostVectors] = None) -> Timetable:
    """ZB-H1-style: weight-grad events deferred to fill the drain bubble
    (same in-flight cap as 1F1B, so activation memory is 1F1B-equal).
    V > 1 composes the same W-deferral with the interleaved chunk rows —
    the ``defer_weight_grads`` priority over C = S*V chunks."""
    return _greedy_timetable("zero-bubble", S, M, V,
                             defer_weight_grads=True,
                             costs=normalize_costs(costs, S * V))


def _defer_tail_w(tt: Timetable, stash: int) -> Timetable:
    """Mark up to ``stash`` trailing W events per chunk as deferred past
    the step boundary (the ZB-H2 steady-state accounting). Only a stage's
    TAIL is eligible — a contiguous run of W events after every other
    event on that stage — so the wrapped cells provably land in the next
    period's idle (Timetable.validate pins the invariant). Execution is
    untouched: the events stay painted where they are."""
    if stash <= 0:
        return tt
    S = tt.num_stages
    # per-stage events sorted by start
    per_stage: Dict[int, List[Tuple[int, int, int, int]]] = {
        s: [] for s in range(S)}
    for kind in (EVENT_FWD, EVENT_BWD_IN, EVENT_BWD_W):
        for (c, m), h in tt.event_times(kind).items():
            per_stage[c % S].append((h, kind, c, m))
    deferred: List[Tuple[int, int]] = []
    for s in range(S):
        taken: Dict[int, int] = {}  # chunk -> deferred count
        for h, kind, c, m in sorted(per_stage[s], reverse=True):
            if kind != EVENT_BWD_W or taken.get(c, 0) >= stash:
                break  # the tail run ended (or this chunk's stash is full)
            taken[c] = taken.get(c, 0) + 1
            deferred.append((c, m))
    if not deferred:
        return tt
    return dataclasses.replace(tt, deferred_w=tuple(sorted(deferred)))


@functools.lru_cache(maxsize=64)
def zero_bubble_h2_timetable(S: int, M: int, V: int = 1,
                             costs: Optional[CostVectors] = None,
                             stash: int = 1) -> Timetable:
    """ZB-H2-style: the greedy W-deferring packer with the 1F1B in-flight
    cap LIFTED by ``stash`` extra microbatches per chunk, then up to
    ``stash`` trailing W events per chunk marked deferred past the step
    boundary. The linear event order still executes within the step (so
    trajectories pin against 1f1b exactly like zero-bubble); the payoff is
    the steady-state period — bubble_fraction prices the wrapped schedule,
    which the lifted warmup + boundary deferral drive toward zero at the
    price of ``stash`` extra stashed activations per chunk (the planner's
    stage_mem term; a tight --hbm-gb cap rejects exactly this)."""
    tt = _greedy_timetable("zero-bubble-h2", S, M, V,
                           defer_weight_grads=True,
                           costs=normalize_costs(costs, S * V),
                           extra_inflight=stash)
    out = _defer_tail_w(tt, stash)
    out.validate()
    return out


def timetable_from_times(name: str, S: int, V: int, M: int,
                         F: Dict[Tuple[int, int], int],
                         B: Dict[Tuple[int, int], int],
                         W: Dict[Tuple[int, int], int],
                         costs: Optional[CostVectors]) -> Timetable:
    """Materialize a dense validated grid from start-time tables — the
    shared tail of :func:`reprice_timetable` and the searched packer's
    list scheduler (partition/schedule_search.py)."""
    fc, bc, wc = costs if costs is not None else ((1,) * (S * V),) * 3
    H = max(max(h + wc[c] for (c, _), h in W.items()),
            max(h + bc[c] for (c, _), h in B.items()),
            max(h + fc[c] for (c, _), h in F.items()))
    events, mbs, chunks = _empty(H, S)
    for table, kind, cv in ((F, EVENT_FWD, fc), (B, EVENT_BWD_IN, bc),
                            (W, EVENT_BWD_W, wc)):
        for (c, m), h in table.items():
            _paint(events, mbs, chunks, h, c % S, kind, c, m, cv[c])
    out = Timetable(name, S, V, M, events, mbs, chunks, costs)
    out.validate()
    return out


def make_timetable(schedule: str, S: int, M: int, V: int = 1,
                   costs: Optional[CostVectors] = None, *,
                   stash: int = 1, search_budget: int = 256,
                   search_seed: int = 0) -> Timetable:
    """Factory keyed by the ``--pipe-schedule`` flag value. ``costs`` are
    per-chunk (f, b, w) half-tick vectors (None / all-unit = the PR 7
    unit-cost tables, reproduced bitwise).

    For weighted EVENT schedules the factory builds two candidates — the
    cost-aware greedy table and the unit-cost table's event order
    repriced under the true costs (:func:`reprice_timetable`) — and
    returns the lower-bubble one: the greedy is a heuristic that can
    commit early where the unit order happens to interleave better, so
    taking the min guarantees a weighted timetable never packs WORSE
    than executing the classic schedule on the same uneven chunks.

    ``1f1b``/``zero-bubble`` at V > 1 return the COMPOSED schedules (the
    interleaved table; the W-deferring interleaved table) instead of the
    pre-PR-18 ValueError. ``stash`` sizes zero-bubble-h2's extra in-flight
    stash; ``search_budget``/``search_seed`` parameterize the searched
    packer (deterministic: same budget + seed reproduce the table
    bitwise)."""
    costs = normalize_costs(costs, S * V)
    if schedule == "fill-drain":
        return fill_drain_timetable(S, M, V, costs)
    if schedule == "searched":
        from ddlbench_tpu_torch.partition.schedule_search import searched_timetable

        return searched_timetable(S, M, V, costs, budget=search_budget,
                                  seed=search_seed)
    if schedule in ("1f1b", "interleaved"):
        # 1f1b at V > 1 IS the interleaved table (the composed schedule)
        gen = lambda c: sync_1f1b_timetable(S, M, V, c)
    elif schedule == "zero-bubble":
        gen = lambda c: zero_bubble_timetable(S, M, V, c)
    elif schedule == "zero-bubble-h2":
        gen = lambda c: zero_bubble_h2_timetable(S, M, V, c, stash=stash)
    else:
        raise ValueError(f"unknown pipe schedule {schedule!r} "
                         f"(choose from {', '.join(PIPE_SCHEDULES)})")
    if costs is None:
        return gen(None)
    aware = gen(costs)
    repriced = reprice_timetable(gen(None), costs)
    if schedule == "zero-bubble-h2":
        # compare on the steady-state accounting both candidates use:
        # repricing rebuilds the grid, so re-mark its deferred tail
        repriced = _defer_tail_w(repriced, stash)
        repriced.validate()
    return (aware if aware.bubble_fraction() <= repriced.bubble_fraction()
            else repriced)


def reprice_timetable(tt: Timetable, costs: CostVectors) -> Timetable:
    """Re-simulate ``tt``'s event ORDER under per-chunk ``costs``: each
    device runs its events in the original start order, each starting at
    max(device free, producer end) — what executing a unit-cost schedule
    on genuinely uneven stages would actually cost. The cost-aware
    generator's table must beat (or match) this table's bubble; the
    uneven-cost acceptance fixture pins strictly-lower for 1f1b."""
    costs = normalize_costs(costs, tt.num_chunks)
    if costs is None:
        return tt
    fc, bc, wc = costs
    C = tt.num_chunks
    F0 = tt.event_times(EVENT_FWD)
    B0 = tt.event_times(EVENT_BWD_IN)
    W0 = tt.event_times(EVENT_BWD_W)
    # global original start order; producers always precede consumers
    seq = sorted(
        [(h, c % tt.num_stages, EVENT_FWD, c, m) for (c, m), h in F0.items()]
        + [(h, c % tt.num_stages, EVENT_BWD_IN, c, m)
           for (c, m), h in B0.items()]
        + [(h, c % tt.num_stages, EVENT_BWD_W, c, m)
           for (c, m), h in W0.items()])
    F: Dict[Tuple[int, int], int] = {}
    B: Dict[Tuple[int, int], int] = {}
    W: Dict[Tuple[int, int], int] = {}
    free = [0] * tt.num_stages
    for _h0, s, kind, c, m in seq:
        if kind == EVENT_FWD:
            arrival = 0 if c == 0 else F[(c - 1, m)] + fc[c - 1]
            start = max(free[s], arrival)
            F[(c, m)] = start
            free[s] = start + fc[c]
        elif kind == EVENT_BWD_IN:
            arrival = (F[(c, m)] + fc[c] if c == C - 1
                       else B[(c + 1, m)] + bc[c + 1])
            start = max(free[s], arrival, F[(c, m)] + fc[c])
            B[(c, m)] = start
            free[s] = start + bc[c]
        else:
            start = max(free[s], B[(c, m)] + bc[c])
            W[(c, m)] = start
            free[s] = start + wc[c]
    return timetable_from_times(tt.name, tt.num_stages, tt.virtual_stages,
                                tt.num_microbatches, F, B, W, costs)


def quantize_cost_vectors_clipped(
        f_ms, b_ms, w_ms=None,
        max_units: int = 8) -> Tuple[CostVectors, int]:
    """Per-chunk profiled milliseconds -> integer half-tick cost vectors,
    plus HOW MANY events the ``max_units`` cap clipped (the no-silent-caps
    rule: a clipped vector flattens genuinely uneven profiles, and the
    caller should say so — parallel/api.py logs it, and the search path
    raises the cap so the packer sees the real unevenness).

    The cheapest event maps to one half-tick; everything else scales
    relative to it, rounded, capped at ``max_units`` (bounding the
    weighted grid's height). ``w_ms=None`` splits the combined backward
    evenly into B and W — the profiler measures fwd and fwd+bwd only, and
    dL/dx vs dL/dw each cost about one forward (the same 2x heuristic
    profiler/profile.py's flops mode uses)."""
    f_ms = [float(v) for v in f_ms]
    if w_ms is None:
        b_ms = [float(v) / 2.0 for v in b_ms]
        w_ms = list(b_ms)
    else:
        b_ms = [float(v) for v in b_ms]
        w_ms = [float(v) for v in w_ms]
    lo = min(v for v in f_ms + b_ms + w_ms if v > 0) if any(
        v > 0 for v in f_ms + b_ms + w_ms) else 1.0
    clipped = sum(1 for v in f_ms + b_ms + w_ms
                  if int(round(v / lo)) > max_units)
    q = lambda v: max(1, min(max_units, int(round(v / lo))))
    return (tuple(q(v) for v in f_ms), tuple(q(v) for v in b_ms),
            tuple(q(v) for v in w_ms)), clipped


def quantize_cost_vectors(f_ms, b_ms, w_ms=None,
                          max_units: int = 8) -> CostVectors:
    """:func:`quantize_cost_vectors_clipped` without the clip count — for
    callers that handle/report clipping elsewhere (or don't care)."""
    return quantize_cost_vectors_clipped(f_ms, b_ms, w_ms, max_units)[0]


# -- analytic bubble fractions (module docstring's closed forms) -----------


def pipeline_bubble_fraction(num_stages: int, num_microbatches: int,
                             virtual_stages: int = 1) -> float:
    """Idle fraction of the synchronous fill-drain schedule — the classic
    (S-1)/(M*V + S-1). Identical on the half-tick grid: both the forward
    tick and the 2-half-tick combined backward idle S-1 units per device."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    if S <= 1:
        return 0.0
    return (S - 1) / (M * V + S - 1)


def schedule_bubble_fraction(schedule: str, num_stages: int,
                             num_microbatches: int,
                             virtual_stages: int = 1,
                             costs: Optional[CostVectors] = None,
                             stash: int = 1) -> float:
    """Analytic bubble fraction for one shipped schedule at (S, M, V).

    fill-drain / 1f1b / zero-bubble use the closed forms (module
    docstring); interleaved / zero-bubble-h2 / searched are measured from
    their tables at runtime-plausible shapes (their packing depends on how
    the generator interleaves / defers / searches) and fall back to
    lower-bound closed forms at advisory scale. Closed forms are pinned
    against table-derived fractions by the ``pipesched`` suite. With
    ``costs`` the WEIGHTED bubble is measured from the cost-aware table
    (no closed forms exist for uneven chunks). ``stash`` is
    zero-bubble-h2's extra in-flight stash."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    if S <= 1:
        return 0.0
    costs = normalize_costs(costs, S * V)
    if costs is not None:
        return make_timetable(schedule, S, M, V, costs,
                              stash=stash).bubble_fraction()
    if schedule == "fill-drain":
        return pipeline_bubble_fraction(S, M, V)
    if schedule == "1f1b" and V == 1 or schedule == "interleaved" and V == 1:
        return 2 * (S - 1) / (3 * M + 2 * (S - 1))
    if schedule == "zero-bubble" and V == 1:
        return (S - 1) / (3 * M + (S - 1))
    if bubble_is_estimate(schedule, S, M, V):
        # advisory-scale guard: the generators are pure Python (the greedy
        # O(H*S*V*M^2) worst case; the searched packer budget * O(events)
        # on top) — beyond a few thousand events, report the ideal-packing
        # LOWER BOUND instead of materializing the table for a printed
        # hint; the runtime still builds (and caches) the exact table when
        # the schedule actually executes
        if schedule in ("1f1b", "interleaved"):
            return 2 * (S - 1) / (3 * M * V + 2 * (S - 1))
        if schedule == "zero-bubble":
            return (S - 1) / (3 * M * V + (S - 1))
        if schedule == "zero-bubble-h2":
            # the zero-bubble form with the fill shrunk by the stash —
            # each extra in-flight microbatch hides one warmup idle
            d = max(0, S - 1 - stash)
            return d / (3 * M * V + d) if d else 0.0
        if schedule == "searched":
            # searched seeds include zero-bubble, so its form bounds below
            return (S - 1) / (3 * M * V + (S - 1))
    if schedule not in PIPE_SCHEDULES:
        raise ValueError(f"unknown pipe schedule {schedule!r}")
    return make_timetable(schedule, S, M, V, stash=stash).bubble_fraction()


def bubble_is_estimate(schedule: str, num_stages: int,
                       num_microbatches: int,
                       virtual_stages: int = 1) -> bool:
    """True when :func:`schedule_bubble_fraction` returns a value a
    single-step measured trace will NOT reproduce — either an
    ideal-packing LOWER BOUND (large table-derived shapes, where the pure-
    Python generators are too slow for a printed hint), or zero-bubble-h2
    ALWAYS (its analytic figure prices the wrapped steady-state period;
    one linear step measures the strictly-higher grid fraction). Callers
    reporting the figure (scalebench ``bubble_analytic``) tag it so
    measured-vs-analytic comparisons don't read an optimistic bound as
    the schedule's true prediction."""
    S, V, M = num_stages, virtual_stages, num_microbatches
    if schedule == "zero-bubble-h2":
        return True
    if schedule == "searched":
        return S * V * M > 512
    return (schedule in ("1f1b", "interleaved", "zero-bubble")
            and V > 1 and S * V * M > 2048)


def recommend_schedule(num_stages: int, num_microbatches: int,
                       virtual_stages: int = 1,
                       costs: Optional[CostVectors] = None,
                       measured: Optional[Dict[str, float]] = None,
                       ) -> List[dict]:
    """Feasible schedules at (S, M, V) with their analytic bubbles, best
    first — what --auto-partition's advisor now reports alongside the best
    V. Ranks the FULL grown family (fill-drain, 1f1b, interleaved,
    zero-bubble, zero-bubble-h2, searched); the 1f1b row is skipped at
    V > 1 where it aliases the interleaved table.

    ``costs``: per-chunk (f, b, w) half-tick vectors — rows then carry the
    WEIGHTED analytic bubble of each schedule's cost-aware table.
    ``measured``: {schedule: bubble} fractions reduced from a real trace
    (telemetry/bubble.py) — a schedule with a measured figure ranks by it
    (reality outranks the model; ROADMAP item 2c), keeping the analytic
    value alongside as ``bubble``.
    """
    S, M, V = num_stages, num_microbatches, virtual_stages
    rows = []
    for name in PIPE_SCHEDULES:
        if name == "1f1b" and V != 1:
            continue  # at V > 1 the 1f1b row IS the interleaved row
        if name != "fill-drain" and V > 1 and M % S:
            continue  # event schedules group microbatches in rounds of S
        row = {
            "schedule": name,
            "bubble": round(
                schedule_bubble_fraction(name, S, M, V, costs), 4),
            "virtual_stages": V,
        }
        if bubble_is_estimate(name, S, M, V):
            row["bubble_is_estimate"] = True
        if measured and name in measured:
            row["bubble_measured"] = round(float(measured[name]), 4)
        rows.append(row)
    rows.sort(key=lambda r: (r.get("bubble_measured", r["bubble"]),
                             r["schedule"]))
    return rows


def recommend_virtual_stages(num_stages: int, num_microbatches: int,
                             num_layers: int,
                             candidates: Tuple[int, ...] = (1, 2, 3, 4, 6, 8),
                             ) -> List[dict]:
    """Feasible interleaving factors with their bubble fractions, best first.

    Feasibility: V=1 always; V>1 needs num_microbatches % num_stages == 0
    (the interleaved timetable groups microbatches in rounds of S) and
    enough layers for S*V chunks. Rows carry the transfer count per
    microbatch so callers can weigh bubble savings against rotation cost
    (the bubble always shrinks with V; communication always grows), plus
    the best schedule at that V (recommend_schedule) now that schedules
    are data.
    """
    S, M = num_stages, num_microbatches
    rows = []
    for v in candidates:
        if v > 1 and (M % S or S * v > num_layers or S <= 1):
            continue
        if v == 1 and S * v > num_layers:
            continue
        best = recommend_schedule(S, M, v)[0]
        rows.append({
            "virtual_stages": v,
            "bubble": round(pipeline_bubble_fraction(S, M, v), 4),
            "transfers_per_microbatch": max(0, S * v - 1),
            "best_schedule": best["schedule"],
            "best_schedule_bubble": best["bubble"],
        })
    rows.sort(key=lambda r: (r["bubble"], r["virtual_stages"]))
    return rows
