"""Self-healing SLO autoscaler: the closed control loop over the serving
fleet (the port's copy of ``ddlbench_tpu/serve/autoscaler.py``).

:class:`FleetController` closes the loop over a
:class:`~ddlbench_tpu_torch.serve.engine.ReplicatedServer`:

    sense   — an incremental online form of ``telemetry/serveview.py``'s
              windowed attainment/goodput reducer (:class:`OnlineTimeline`:
              the same tumbling buckets and the same ``request_slo_ok``
              predicate, fed one finished record at a time), plus live
              fleet state (queue depth, worst occupancy) and the
              shed/timeout counter deltas per window.
    decide  — a PURE function of (window signal, policy): hysteresis
              bands suppress flapping, per-direction cooldowns block
              back-to-back actuations, min/max clamps bound the fleet, and
              a bounded actuation budget degrades gracefully (the named
              ``budget_exhausted`` ledger event fires once and the fleet
              keeps serving at its current size).
    actuate — the fleet's own surfaces only: ``resize(n +/- 1)`` to scale,
              and AUTO-REPAIR: a dead (``fail_events``) or
              heartbeat-drained (``heartbeat_events``) replica is replaced
              through the engine-factory spawn resize uses. Repair is not
              a scale decision: it spends budget but neither consults nor
              arms the scale cooldowns.

Everything runs on the drivers' virtual clock (1 unit = 1 model pass):
servebench's drivers call ``advance(now)`` after every global step and
idle jump, so every decision lands at a deterministic virtual instant and
the trajectory is reproducible per seed. Each actuation also emits an
``autoscale:*`` trace instant carrying its signal snapshot
(``telemetry/export.autoscale_decisions`` reads them back). Pure host
arithmetic: nothing here touches a device.

Repair exactly once: the controller consumes the fail and heartbeat
ledgers by index, so an expiry that spans two windows is still one entry
and can never spawn twice.

:func:`make_controllers` builds one controller for a replicated fleet and
one PER FLEET for a disaggregated server (serve/handoff.py): prefill and
decode scale independently, each clamped to the same band.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from ddlbench_tpu_torch.telemetry.stats import request_slo_ok
from ddlbench_tpu_torch.telemetry.tracer import get_tracer


def _vns(t: float) -> int:
    """Virtual model-pass time -> integer trace-ns (the serving engine's
    1 pass = 1000 trace-ns stamping)."""
    return int(round(t * 1000.0))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The controller's policy: with the window signal, the ONLY inputs to
    :func:`decide`. The hysteresis band is ``[attain_lo, attain_hi]``: a
    window whose attainment falls inside it (with no shed, timeout or
    queue pressure and no idle-fleet slack) actuates nothing."""

    lo: int                      # min replicas (clamp floor)
    hi: int                      # max replicas (clamp ceiling)
    window: float = 32.0         # observation window (virtual units)
    cooldown_up: float = 64.0    # min time between scale-ups
    cooldown_down: float = 64.0  # min time between scale-downs
    attain_lo: float = 0.9       # window attainment below this = pressure
    attain_hi: float = 0.98      # at/above this (idle fleet) = slack
    queue_hi: float = 1.0        # queued requests per replica = pressure
    occ_lo: float = 0.5          # worst-replica occupancy under this = idle
    budget: int = 16             # total actuations (scales + repairs)

    def __post_init__(self):
        if self.lo < 1 or self.hi < self.lo:
            raise ValueError(
                f"autoscale clamps need 1 <= lo <= hi, got "
                f"{self.lo}:{self.hi}")
        if self.window <= 0:
            raise ValueError(f"window must be > 0, got {self.window}")
        if self.cooldown_up < 0 or self.cooldown_down < 0:
            raise ValueError("cooldowns must be >= 0")
        if not 0.0 <= self.attain_lo <= self.attain_hi <= 1.0:
            raise ValueError(
                f"hysteresis band needs 0 <= attain_lo <= attain_hi <= 1, "
                f"got [{self.attain_lo}, {self.attain_hi}]")
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")


@dataclasses.dataclass(frozen=True)
class WindowSignal:
    """One closed observation window: the online timeline bucket
    (serveview's attainment and goodput) plus the live pressure signals."""

    t0: float
    t1: float
    completed: int
    slo_ok: int
    attainment: float
    tokens: int
    good_tokens: int
    goodput_tokens_per_unit: float
    shed: int           # shed-counter delta inside this window
    timeouts: int       # timeout-counter delta inside this window
    queue_depth: int    # live, at window close
    active: int         # live in-flight, at window close
    occupancy: float    # live worst-replica pool occupancy, at window close
    replicas: int       # fleet size at window close


def decide(sig: WindowSignal, policy: AutoscalePolicy) -> Optional[str]:
    """``"up"``, ``"down"`` or ``None`` from ONE window signal and the
    policy (cooldowns and budget are the controller's).

    Pressure (any of): attainment below the band on a window that
    completed work, a shed or timeout inside the window, or queue depth
    above ``queue_hi`` per replica. Slack (all of): empty queue, worst
    occupancy under ``occ_lo``, and attainment at or above the band (an
    all-idle window is slack too: the diurnal trough). In between: the
    hysteresis dead band."""
    if sig.replicas < policy.lo:
        return "up"      # below the floor
    if sig.replicas > policy.hi:
        return "down"
    pressure = ((sig.completed > 0 and sig.attainment < policy.attain_lo)
                or sig.shed > 0 or sig.timeouts > 0
                or sig.queue_depth > policy.queue_hi * sig.replicas)
    if pressure:
        return "up" if sig.replicas < policy.hi else None  # clamped at hi
    slack = (sig.queue_depth == 0 and sig.occupancy < policy.occ_lo
             and (sig.completed == 0
                  or sig.attainment >= policy.attain_hi))
    if slack and sig.replicas > policy.lo:                 # clamped at lo
        return "down"
    return None


class OnlineTimeline:
    """``telemetry/serveview.timeline`` in an incremental online form: the
    same tumbling ``[k*W, (k+1)*W)`` buckets, attainment and goodput, fed
    one finished record at a time (``add``) and closed at exact window
    boundaries (``close``). It drops serveview's ``submitted`` (a driver
    event the finished records do not carry); the controller reads the
    live queue depth instead."""

    def __init__(self, window: float, slo_ttft: Optional[float] = None,
                 slo_itl: Optional[float] = None):
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.window = float(window)
        self.slo_ttft = slo_ttft
        self.slo_itl = slo_itl
        self.closed: List[Dict[str, Any]] = []
        self.completed_total = 0
        self.slo_ok_total = 0
        self._open: Dict[int, Dict[str, Any]] = {}  # bucket -> partial row

    def _fresh(self, k: int) -> Dict[str, Any]:
        return {"t0": k * self.window, "t1": (k + 1) * self.window,
                "completed": 0, "slo_ok": 0, "attainment": 0.0,
                "tokens": 0, "good_tokens": 0,
                "goodput_tokens_per_unit": 0.0}

    def add(self, rec: Dict[str, Any]) -> None:
        """Ingest one engine finished record."""
        k = int(rec["completed_t"] // self.window)
        b = self._open.setdefault(k, self._fresh(k))
        n_tok = int(rec["n_tokens"])
        b["completed"] += 1
        b["tokens"] += n_tok
        self.completed_total += 1
        if request_slo_ok(rec, self.slo_ttft, self.slo_itl):
            b["slo_ok"] += 1
            b["good_tokens"] += n_tok
            self.slo_ok_total += 1

    def close(self, k: int) -> Dict[str, Any]:
        """Finalise bucket ``k`` (an untouched bucket closes as the
        all-zero row, so the series runs on through idle troughs)."""
        b = self._open.pop(k, None) or self._fresh(k)
        b["attainment"] = (b["slo_ok"] / b["completed"]
                           if b["completed"] else 0.0)
        b["goodput_tokens_per_unit"] = b["good_tokens"] / self.window
        self.closed.append(b)
        return b

    @property
    def attainment(self) -> float:
        """Attainment over every ingested record."""
        return (self.slo_ok_total / self.completed_total
                if self.completed_total else 0.0)


class FleetController:
    """The closed loop over ONE replicated fleet.

    Drivers call :meth:`advance` with the virtual clock after every global
    step and idle jump; the controller integrates replica-hours, ingests
    newly finished records, repairs newly ledgered replica deaths and
    drains, and at each window boundary crossed closes the window and runs
    :func:`decide` under the cooldown and budget gates. The same traffic
    and policy give the same event ledger."""

    def __init__(self, server, policy: AutoscalePolicy, *,
                 name: str = "fleet", start: float = 0.0):
        self.server = server
        self.policy = policy
        self.name = name
        cfg = server.engines[0].cfg
        self.timeline = OnlineTimeline(policy.window,
                                       slo_ttft=cfg.slo_ttft or None,
                                       slo_itl=cfg.slo_itl or None)
        self.events: List[Dict[str, Any]] = []  # the decision ledger
        self.replica_hours = 0.0  # integral of fleet size over virtual time
        self.scale_ups = 0
        self.scale_downs = 0
        self.repairs = 0
        self.suppressed = 0       # decisions blocked by cooldown/exhaustion
        self._t = float(start)
        self._start = float(start)
        self._windows_closed = 0
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        self._budget_left = policy.budget
        self._exhausted = False
        self._seen_rids: set = set()
        self._seen_fail = 0
        self._seen_drain = 0
        self._prev_shed = 0
        self._prev_timeouts = 0

    # -- the driver hook ---------------------------------------------------

    def advance(self, now: float) -> None:
        """Advance the controller's clock to ``now`` (monotone): integrate
        replica-hours at the size that did the work, ingest completions,
        repair ledgered deaths, and fire every window boundary crossed."""
        if now > self._t:
            self.replica_hours += len(self.server.engines) * (now - self._t)
            self._t = now
        self._ingest()
        self._check_repairs(now)
        while self._next_boundary() <= now:
            t1 = self._next_boundary()
            self._decide_window(t1)
            self._windows_closed += 1

    def _next_boundary(self) -> float:
        # boundary k is exactly start + (k+1) * window: no float drift
        return self._start + (self._windows_closed + 1) * self.policy.window

    # -- sense -------------------------------------------------------------

    def _ingest(self) -> None:
        for rec in self.server.finished:
            if rec["rid"] in self._seen_rids:
                continue
            self._seen_rids.add(rec["rid"])
            self.timeline.add(rec)

    def _signal(self, t1: float) -> WindowSignal:
        b = self.timeline.close(self._windows_closed)
        s = self.server.stats_summary()
        shed, timeouts = int(s.get("shed", 0)), int(s.get("timeouts", 0))
        d_shed, d_to = shed - self._prev_shed, timeouts - self._prev_timeouts
        self._prev_shed, self._prev_timeouts = shed, timeouts
        snap = self.server.snapshot()
        return WindowSignal(
            t0=b["t0"], t1=b["t1"], completed=b["completed"],
            slo_ok=b["slo_ok"], attainment=b["attainment"],
            tokens=b["tokens"], good_tokens=b["good_tokens"],
            goodput_tokens_per_unit=b["goodput_tokens_per_unit"],
            shed=d_shed, timeouts=d_to,
            queue_depth=int(snap["queue_depth"]),
            active=int(snap["active"]),
            occupancy=float(snap["occupancy"]),
            replicas=len(self.server.engines))

    # -- actuate -----------------------------------------------------------

    def _record(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        tr = get_tracer()
        if tr.enabled:
            # the decision instant on its own track, with its signal
            tr.emit("i", f"autoscale:{ev['event']}", _vns(ev["t"]),
                    track=f"autoscale/{self.name}", args=dict(ev))

    def _spend(self, t: float, wanted: str) -> bool:
        """Take one actuation from the budget; on exhaustion emit the
        named ``budget_exhausted`` event ONCE and refuse."""
        if self._budget_left > 0:
            self._budget_left -= 1
            return True
        if not self._exhausted:
            self._exhausted = True
            self._record({"t": t, "event": "budget_exhausted",
                          "fleet": self.name, "wanted": wanted,
                          "replicas": len(self.server.engines)})
        else:
            self.suppressed += 1
        return False

    def _check_repairs(self, now: float) -> None:
        """AUTO-REPAIR: every not-yet-consumed fail or heartbeat ledger
        entry is one replica to replace through the factory spawn resize
        uses, consumed by index (so exactly once)."""
        fails = self.server.fail_events
        drains = self.server.heartbeat_events
        pending = ([("fail", ev) for ev in fails[self._seen_fail:]]
                   + [("heartbeat", ev) for ev in drains[self._seen_drain:]])
        self._seen_fail = len(fails)
        self._seen_drain = len(drains)
        for trigger, ev in pending:
            n0 = len(self.server.engines)
            target = min(self.policy.hi, n0 + 1)
            if target == n0:
                continue  # already at the ceiling
            if not self._spend(now, "repair"):
                continue
            self.server.resize(target, now)
            self.repairs += 1
            self._record({"t": now, "event": "repair", "fleet": self.name,
                          "trigger": trigger,
                          "replica_id": ev["replica_id"],
                          "from": n0, "to": target,
                          "budget_left": self._budget_left})

    def _decide_window(self, t1: float) -> None:
        sig = self._signal(t1)
        action = decide(sig, self.policy)
        if action == "up" and self._last_up is not None \
                and t1 - self._last_up < self.policy.cooldown_up:
            self.suppressed += 1
            return
        if action == "down" and self._last_down is not None \
                and t1 - self._last_down < self.policy.cooldown_down:
            self.suppressed += 1
            return
        if action is None:
            return
        if not self._spend(t1, f"scale_{action}"):
            return
        n0 = len(self.server.engines)
        target = n0 + 1 if action == "up" else n0 - 1
        self.server.resize(target, t1)
        if action == "up":
            self.scale_ups += 1
            self._last_up = t1
        else:
            self.scale_downs += 1
            self._last_down = t1
        self._record({"t": t1, "event": f"scale_{action}",
                      "fleet": self.name, "from": n0, "to": target,
                      "budget_left": self._budget_left,
                      "signal": dataclasses.asdict(sig)})

    # -- row figures -------------------------------------------------------

    @property
    def scale_events(self) -> int:
        return self.scale_ups + self.scale_downs

    @property
    def attainment(self) -> float:
        return self.timeline.attainment


def make_controllers(server, policy: AutoscalePolicy,
                     start: float = 0.0) -> List[FleetController]:
    """Controllers for any driver-compatible server: one for a
    ReplicatedServer, one per fleet for a disaggregated server
    (``DisaggregatedServer.controllers``)."""
    if hasattr(server, "controllers"):
        return server.controllers(policy, start=start)
    return [FleetController(server, policy, start=start)]


def combined_attainment(controllers: List[FleetController]) -> float:
    """Online attainment over a controller set's ingested records (in the
    disaggregated layout completions land on the decode fleet's
    controller; the union is the fleet-wide figure)."""
    ok = sum(c.timeline.slo_ok_total for c in controllers)
    done = sum(c.timeline.completed_total for c in controllers)
    return ok / done if done else 0.0


def replica_hours(controllers: List[FleetController]) -> float:
    """Total replica-hours (virtual units x replicas) over the controllers:
    a static fleet pays ``replicas * duration``; the autoscaler's integral
    is what it used. ``math.fsum`` keeps the sum order-independent."""
    return math.fsum(c.replica_hours for c in controllers)
