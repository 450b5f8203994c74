"""The port's self-healing autoscaler (ddlbench_tpu_torch/serve/
autoscaler.py, telemetry/export.autoscale_decisions, servebench
--autoscale) held against the JAX reference on the CPU: the counterparts
of tests/test_autoscale.py.

* ``decide`` gives the reference's decision on every signal and policy,
  and the policy refuses what the reference refuses with its message.
* On a host-only stub fleet, the port's FleetController and the
  reference's, fed the same script, write the same decision ledger and
  counters: hysteresis, both cooldowns, the clamps, the actuation budget
  with its one ``budget_exhausted`` event, repair exactly once and its
  exemption from the cooldowns, replica-hours; each scenario also pins
  the reference's expected outcome.
* The online timeline and the ``autoscale:*`` trace instants (read back
  by ``autoscale_decisions`` from the live tracer and the exported dict)
  are the reference's.
* On the tiny LM with the reference's weights: the diurnal A/B (fewer
  replica-hours than the static fleet at the same goodput, reproducible),
  a kill and a heartbeat drain under the controller (repaired once, no
  request lost, streams those of the control, MTTR no worse than the
  scripted baseline's), each with the reference's records and ledgers.
* servebench's ``--autoscale`` row equals the reference's on every field
  but the provenance, carries exactly the reference's autoscale keys, and
  the tool exits nonzero when an autoscaled run loses a request.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import types
import unittest.mock as mock

import pytest

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve import autoscaler as jax_as
from ddlbench_tpu.serve.workload import make_workload as jax_workload
from ddlbench_tpu.telemetry import tracer as jax_tracer_mod
from ddlbench_tpu.telemetry.export import \
    autoscale_decisions as jax_decisions
from ddlbench_tpu.tools.servebench import \
    run_closed_loop as jax_closed_loop
from ddlbench_tpu.tools.servebench import run_open_loop as jax_open_loop
from ddlbench_tpu.tools.servechaos import \
    mttr_from_events as jax_mttr_from_events

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.serve import autoscaler as tas
from ddlbench_tpu_torch.serve.engine import make_server
from ddlbench_tpu_torch.serve.workload import make_workload
from ddlbench_tpu_torch.telemetry import tracer as tracer_mod
from ddlbench_tpu_torch.telemetry.export import (autoscale_decisions,
                                                 chrome_trace_dict)
from ddlbench_tpu_torch.telemetry.stats import serve_summary
from ddlbench_tpu_torch.tools import servebench
from ddlbench_tpu_torch.tools.servebench import (run_closed_loop,
                                                 run_open_loop)
from ddlbench_tpu_torch.tools.servechaos import mttr_from_events

from test_torch_serve import CPU
from test_torch_serve_fleet import same_fleet
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import ROW_ARGS, TINY, row_mismatches

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
PACKAGES = (tas, jax_as)  # the port's module, the reference's


# ---------------------------------------------------------------------------
# Host-only stub fleet (tests/test_autoscale.py's).
# ---------------------------------------------------------------------------


class StubFleet:
    """Duck-types the fleet surface the controller reads (engines,
    finished, ledgers, stats_summary, snapshot, resize) with signals a
    script sets."""

    def __init__(self, n=2, slo_ttft=8.0, slo_itl=2.5):
        self._slo = (slo_ttft, slo_itl)
        self.engines = [self._mk() for _ in range(n)]
        self.finished = []
        self.fail_events = []
        self.heartbeat_events = []
        self.resize_events = []
        self.shed = 0
        self.timeouts = 0
        self.queue_depth = 0
        self.active = 0
        self.occupancy = 0.0

    def _mk(self):
        return types.SimpleNamespace(cfg=types.SimpleNamespace(
            slo_ttft=self._slo[0], slo_itl=self._slo[1]))

    def stats_summary(self):
        return {"shed": self.shed, "timeouts": self.timeouts}

    def snapshot(self):
        return {"queue_depth": self.queue_depth, "active": self.active,
                "occupancy": self.occupancy}

    def resize(self, n, now=0.0):
        ev = {"t": now, "from": len(self.engines), "to": n}
        while len(self.engines) > n:
            self.engines.pop()
        while len(self.engines) < n:
            self.engines.append(self._mk())
        self.resize_events.append(ev)
        return ev


def _rec(rid, t, ok=True):
    """A finished record that meets the (8, 2.5) SLOs, or misses TTFT."""
    arrival = t - 2.0 if ok else t - 100.0
    return {"rid": rid, "arrival": arrival, "first_token_t": t - 1.0,
            "token_times": [t - 1.0, t], "n_tokens": 2, "completed_t": t}


def _feed(fleet, t0, n_ok, n_bad, rid0):
    for j in range(n_ok):
        fleet.finished.append(_rec(rid0 + j, t0 + 0.5, ok=True))
    for j in range(n_bad):
        fleet.finished.append(_rec(rid0 + n_ok + j, t0 + 0.5, ok=False))
    return rid0 + n_ok + n_bad


def _fail_ev(t, replica_id):
    return {"t": t, "replica_id": replica_id, "fleet_index": 0,
            "salvaged": 0, "displaced_inflight": [], "displaced_queued": 0,
            "resubmitted": 0, "shed_on_failover": 0}


def _both(script, n=2, **policy):
    """Run ``script(fleet, ctl)`` against the port's controller and the
    reference's on stub fleets of their own; the two must keep the same
    ledger and counters. Returns the port's (fleet, controller)."""
    out = []
    for mod in PACKAGES:
        fleet = StubFleet(n=n)
        ctl = mod.FleetController(fleet, mod.AutoscalePolicy(**policy))
        script(fleet, ctl)
        out.append((fleet, ctl))
    (tf, tc), (jf, jc) = out
    assert tc.events == jc.events
    for k in ("scale_ups", "scale_downs", "repairs", "suppressed",
              "replica_hours", "scale_events", "attainment"):
        assert getattr(tc, k) == getattr(jc, k), k
    assert len(tf.engines) == len(jf.engines)
    assert tf.resize_events == jf.resize_events
    assert tc.timeline.closed == jc.timeline.closed
    return tf, tc


# ---------------------------------------------------------------------------
# Policy and the pure decide.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(lo=0, hi=2), dict(lo=3, hi=2), dict(lo=1, hi=2, window=0.0),
    dict(lo=1, hi=2, cooldown_up=-1.0),
    dict(lo=1, hi=2, attain_lo=0.99, attain_hi=0.9),
    dict(lo=1, hi=2, budget=0)])
def test_policy_validation_is_the_references(bad):
    with pytest.raises(ValueError) as got:
        tas.AutoscalePolicy(**bad)
    with pytest.raises(ValueError) as want:
        jax_as.AutoscalePolicy(**bad)
    assert str(got.value) == str(want.value)


def _sig(mod, **kw):
    base = dict(t0=0.0, t1=10.0, completed=0, slo_ok=0, attainment=0.0,
                tokens=0, good_tokens=0, goodput_tokens_per_unit=0.0,
                shed=0, timeouts=0, queue_depth=0, active=0,
                occupancy=0.0, replicas=2)
    base.update(kw)
    return mod.WindowSignal(**base)


# (signal fields, policy (lo, hi), the reference test's decision)
DECISIONS = [
    (dict(completed=10, slo_ok=5, attainment=0.5), (1, 4), "up"),
    (dict(completed=10, slo_ok=10, attainment=1.0, shed=1), (1, 4), "up"),
    (dict(timeouts=2), (1, 4), "up"),
    (dict(queue_depth=5, replicas=2), (1, 4), "up"),
    (dict(occupancy=0.1), (1, 4), "down"),
    (dict(completed=8, slo_ok=8, attainment=1.0, occupancy=0.2), (1, 4),
     "down"),
    (dict(completed=20, slo_ok=19, attainment=0.95, occupancy=0.8), (1, 4),
     None),
    (dict(completed=8, slo_ok=8, attainment=1.0, occupancy=0.9), (1, 4),
     None),
    (dict(replicas=3, completed=10, attainment=0.0), (2, 3), None),
    (dict(replicas=2, occupancy=0.0), (2, 3), None),
    (dict(replicas=1), (2, 3), "up"),
    (dict(replicas=5), (2, 3), "down"),
]


@pytest.mark.parametrize("fields,lohi,want", DECISIONS)
def test_decide_equals_jax(fields, lohi, want):
    got = tas.decide(_sig(tas, **fields),
                     tas.AutoscalePolicy(lo=lohi[0], hi=lohi[1]))
    ref = jax_as.decide(_sig(jax_as, **fields),
                        jax_as.AutoscalePolicy(lo=lohi[0], hi=lohi[1]))
    assert got == ref == want


# ---------------------------------------------------------------------------
# Controller: hysteresis, cooldown, clamps, budget, repair.
# ---------------------------------------------------------------------------


def test_hysteresis_suppresses_flapping():
    def script(fleet, ctl):
        fleet.occupancy = 0.8
        rid = 0
        for w in range(10):
            ok, bad = (23, 2) if w % 2 == 0 else (24, 1)  # 0.92 <-> 0.96
            rid = _feed(fleet, w * 10.0, ok, bad, rid)
            ctl.advance((w + 1) * 10.0)

    fleet, ctl = _both(script, lo=1, hi=4, window=10.0, cooldown_up=0.0,
                       cooldown_down=0.0)
    assert ctl.events == [] and len(fleet.engines) == 2
    atts = [b["attainment"] for b in ctl.timeline.closed]
    assert min(atts) == 0.92 and max(atts) == 0.96


@pytest.mark.parametrize("cooldown,ups,times", [
    (0.0, 5, [10.0, 20.0, 30.0, 40.0, 50.0]), (25.0, 2, [10.0, 40.0])])
def test_cooldown_blocks_back_to_back_ups(cooldown, ups, times):
    def script(fleet, ctl):
        fleet.queue_depth = 50
        for w in range(5):
            ctl.advance((w + 1) * 10.0)

    _, ctl = _both(script, n=1, lo=1, hi=8, window=10.0,
                   cooldown_up=cooldown, cooldown_down=cooldown)
    assert ctl.scale_ups == ups
    assert [e["t"] for e in ctl.events] == times
    assert ctl.suppressed == 5 - ups


def test_clamps_hold_under_sustained_signal():
    def ceiling(fleet, ctl):
        fleet.queue_depth = 99
        for w in range(6):
            ctl.advance((w + 1) * 10.0)

    fleet, ctl = _both(ceiling, n=3, lo=1, hi=3, window=10.0,
                       cooldown_up=0.0, cooldown_down=0.0)
    assert len(fleet.engines) == 3 and ctl.scale_events == 0

    def floor(fleet, ctl):
        for w in range(8):
            ctl.advance((w + 1) * 10.0)

    fleet, ctl = _both(floor, n=4, lo=2, hi=4, window=10.0,
                       cooldown_up=0.0, cooldown_down=0.0)
    assert len(fleet.engines) == 2 and ctl.scale_downs == 2
    assert all(e["event"] == "scale_down" for e in ctl.events)


def test_budget_exhaustion_degrades_gracefully():
    def script(fleet, ctl):
        fleet.queue_depth = 50
        for w in range(6):
            ctl.advance((w + 1) * 10.0)

    fleet, ctl = _both(script, n=1, lo=1, hi=10, window=10.0,
                       cooldown_up=0.0, cooldown_down=0.0, budget=2)
    assert [e["event"] for e in ctl.events] == \
        ["scale_up", "scale_up", "budget_exhausted"]
    assert ctl.events[-1]["t"] == 30.0
    assert ctl.events[-1]["wanted"] == "scale_up"
    assert len(fleet.engines) == 3 and ctl.suppressed == 3


def test_repair_exactly_once_across_windows():
    def script(fleet, ctl):
        fleet.engines.pop()
        fleet.heartbeat_events.append(
            {"t": 3.0, "replica_id": 7, "fleet_index": 1,
             "stalled_for": 5.0, "evicted": 2, "redistributed": 1,
             "shed": 0})
        ctl.advance(5.0)
        ctl.advance(15.0)
        ctl.advance(25.0)
        fleet.engines.pop()
        fleet.fail_events.append(_fail_ev(27.0, 3))
        ctl.advance(28.0)
        ctl.advance(45.0)

    fleet, ctl = _both(script, lo=2, hi=2, window=10.0)
    assert ctl.repairs == 2 and len(fleet.engines) == 2
    reps = [e for e in ctl.events if e["event"] == "repair"]
    assert [e["trigger"] for e in reps] == ["heartbeat", "fail"]
    assert reps[0]["replica_id"] == 7
    assert (reps[0]["from"], reps[0]["to"]) == (1, 2)


def test_repair_exempt_from_scale_cooldown():
    def script(fleet, ctl):
        fleet.queue_depth = 50
        ctl.advance(10.0)  # scale_up 1 -> 2; cooldown until t=1010
        fleet.engines.pop()
        fleet.fail_events.append(_fail_ev(12.0, 1))
        ctl.advance(15.0)
        ctl.advance(30.0)

    fleet, ctl = _both(script, n=1, lo=1, hi=3, window=10.0,
                       cooldown_up=1000.0, cooldown_down=1000.0)
    assert ctl.repairs == 1 and ctl.scale_ups == 1
    assert len(fleet.engines) == 2


def test_budget_covers_repairs_too():
    def script(fleet, ctl):
        for t, rid in ((1.0, 0), (3.0, 1)):
            fleet.engines.pop()
            fleet.fail_events.append(_fail_ev(t, rid))
            ctl.advance(t + 1.0)

    fleet, ctl = _both(script, lo=2, hi=3, window=10.0, budget=1)
    assert ctl.repairs == 1 and len(fleet.engines) == 1
    assert [e["event"] for e in ctl.events] == \
        ["repair", "budget_exhausted"]
    assert ctl.events[-1]["wanted"] == "repair"


def test_replica_hours_integrate_fleet_size():
    def script(fleet, ctl):
        ctl.advance(10.0)          # 2 replicas x 10
        fleet.resize(4)
        ctl.advance(15.0)          # 4 replicas x 5

    _, ctl = _both(script, lo=1, hi=4, window=100.0)
    assert ctl.replica_hours == 40.0
    assert tas.replica_hours([ctl]) == 40.0


def test_online_timeline_equals_jax():
    out = []
    for mod in PACKAGES:
        tl = mod.OnlineTimeline(window=10.0, slo_ttft=8.0, slo_itl=2.5)
        tl.add(_rec(0, 3.0, ok=True))
        tl.add(_rec(1, 7.0, ok=False))
        tl.add(_rec(2, 23.0, ok=True))
        out.append(([tl.close(k) for k in range(3)], tl.attainment))
    assert out[0] == out[1]
    (b0, b1, b2), att = out[0]
    assert (b0["completed"], b0["slo_ok"], b0["attainment"]) == (2, 1, 0.5)
    assert b1["completed"] == 0 and b2["attainment"] == 1.0
    assert att == 2 / 3
    for mod in PACKAGES:
        with pytest.raises(ValueError, match="window"):
            mod.OnlineTimeline(window=0.0)


# ---------------------------------------------------------------------------
# Trace instants.
# ---------------------------------------------------------------------------


@pytest.fixture
def _restore_tracers():
    before = (tracer_mod.get_tracer(), jax_tracer_mod.get_tracer())
    yield
    tracer_mod.set_tracer(before[0])
    jax_tracer_mod.set_tracer(before[1])


def test_decisions_are_trace_instants(_restore_tracers):
    from ddlbench_tpu.telemetry.export import \
        chrome_trace_dict as jax_chrome_trace_dict

    jtr = jax_tracer_mod.set_tracer(jax_tracer_mod.Tracer(1000)).enable()
    ttr = tracer_mod.set_tracer(tracer_mod.Tracer(1000)).enable()

    def script(fleet, ctl):
        fleet.queue_depth = 50
        ctl.advance(10.0)
        fleet.engines.pop()
        fleet.fail_events.append(_fail_ev(12.0, 1))
        ctl.advance(15.0)

    _both(script, n=1, lo=1, hi=2, window=10.0, cooldown_up=0.0,
          cooldown_down=0.0)
    strip = lambda evs: [(p, n, t0, d, trk, a)  # noqa: E731
                         for p, n, t0, d, _, trk, a in evs]
    assert strip(ttr.events()) == strip(jtr.events())
    for doc, jdoc in ((ttr, jtr), (chrome_trace_dict(ttr),
                                   jax_chrome_trace_dict(jtr))):
        dec = autoscale_decisions(doc)
        assert dec == jax_decisions(jdoc)
        assert [d["kind"] for d in dec] == ["scale_up", "repair"]
        assert dec[0]["t"] == 10.0 and dec[0]["signal"]["queue_depth"] == 50
    assert autoscale_decisions(
        chrome_trace_dict(ttr)["traceEvents"]) == dec


def test_make_controllers_single_fleet():
    fleet = StubFleet(n=2)
    ctls = tas.make_controllers(fleet, tas.AutoscalePolicy(lo=1, hi=4))
    assert len(ctls) == 1 and ctls[0].server is fleet
    assert tas.combined_attainment(ctls) == 0.0


# ---------------------------------------------------------------------------
# The controller over real fleets (tiny LM, the reference's weights).
# ---------------------------------------------------------------------------


FLEET = dict(max_batch=4, pool_pages=20, page=4, max_len=16,
             prefill_chunk=4, replicas=2, slo_ttft=8.0, slo_itl=2.5)


def _pair(serve_factory, port_lm, **kw):
    cfg = {**FLEET, **kw}
    return (serve_factory(JaxServeConfig(**cfg), server=True),
            make_server(port_lm, ServeConfig(**cfg), CPU))


def _diurnal():
    wl = dict(seed=11, n_requests=32, vocab=VOCAB, arrival="poisson",
              rate=0.5, shape="diurnal", prompt_lo=2, prompt_typical=5,
              prompt_hi=9, out_lo=2, out_typical=4, out_hi=6, max_len=16)
    return jax_workload(**wl), make_workload(**wl)


def _controllers(jsrv, tsrv, **policy):
    return (jax_as.make_controllers(jsrv, jax_as.AutoscalePolicy(**policy)),
            tas.make_controllers(tsrv, tas.AutoscalePolicy(**policy)))


def _same_controllers(jctls, tctls):
    assert [c.events for c in tctls] == [c.events for c in jctls]
    assert tas.replica_hours(tctls) == jax_as.replica_hours(jctls)
    assert tas.combined_attainment(tctls) == \
        jax_as.combined_attainment(jctls)


@pytest.fixture(scope="module")
def diurnal_ab(serve_factory, port_lm):
    """Static-max fleet against the autoscaled one on the same diurnal
    traffic, both packages, plus a repeat of the port's autoscaled arm."""
    jsrv, tsrv = _pair(serve_factory, port_lm, replicas=3)
    jreqs, treqs = _diurnal()
    jd, td = jax_open_loop(jsrv, jreqs), run_open_loop(tsrv, treqs)
    assert td == jd
    same_fleet(jsrv, tsrv)
    out = {"static": (tsrv, td)}
    for name in ("auto", "auto2"):
        jsrv, tsrv = _pair(serve_factory, port_lm)
        jctls, tctls = _controllers(jsrv, tsrv, lo=1, hi=3, window=12.0,
                                    cooldown_up=12.0, cooldown_down=12.0)
        jreqs, treqs = _diurnal()
        jd = jax_open_loop(jsrv, jreqs, controllers=jctls)
        td = run_open_loop(tsrv, treqs, controllers=tctls)
        for c in jctls + tctls:
            c.advance(td)
        assert td == jd
        same_fleet(jsrv, tsrv)
        _same_controllers(jctls, tctls)
        out[name] = (tsrv, td, tctls)
    return out


def _goodput(srv, duration):
    return serve_summary(srv.finished, duration=duration, slo_ttft=8.0,
                         slo_itl=2.5)["goodput_tokens_per_unit"]


def test_diurnal_autoscale_fewer_replica_hours(diurnal_ab):
    srv_s, dur_s = diurnal_ab["static"]
    srv_a, dur_a, ctls = diurnal_ab["auto"]
    assert len(srv_s.finished) == len(srv_a.finished) == 32
    assert tas.replica_hours(ctls) < 3 * dur_s
    assert _goodput(srv_a, dur_a) >= 0.9 * _goodput(srv_s, dur_s)
    assert {f["rid"]: f["tokens"] for f in srv_s.finished} == \
        {f["rid"]: f["tokens"] for f in srv_a.finished}
    assert any(e["event"] == "scale_down" for c in ctls for e in c.events)


def test_diurnal_autoscale_trajectory_reproducible(diurnal_ab):
    srv_a, dur_a, ctls_a = diurnal_ab["auto"]
    srv_b, dur_b, ctls_b = diurnal_ab["auto2"]
    assert dur_a == dur_b
    assert srv_a.finished == srv_b.finished
    assert [c.events for c in ctls_a] == [c.events for c in ctls_b]
    assert len(srv_a.engines) == len(srv_b.engines)


def _closed():
    wl = dict(seed=3, n_requests=12, vocab=VOCAB, arrival="closed",
              prompt_lo=2, prompt_typical=5, prompt_hi=9, out_lo=2,
              out_typical=4, out_hi=6, max_len=16)
    return jax_workload(**wl), make_workload(**wl)


@pytest.fixture(scope="module")
def kill_repair(serve_factory, port_lm):
    """Control, scripted kill and kill under the controller, both
    packages (the servechaos --autoscale structure)."""
    out = {}
    for name, kill, auto in (("control", False, False),
                             ("scripted", True, False),
                             ("auto", True, True)):
        jsrv, tsrv = _pair(serve_factory, port_lm, heartbeat=4.0)
        jctls = tctls = None
        if auto:
            jctls, tctls = _controllers(jsrv, tsrv, lo=2, hi=2, window=16.0,
                                        cooldown_up=16.0,
                                        cooldown_down=16.0)
        ev = (lambda: [(6.0, lambda s, c: s.fail(1, now=c))]) if kill \
            else (lambda: None)
        jreqs, treqs = _closed()
        jd = jax_closed_loop(jsrv, jreqs, 6, events=ev(), controllers=jctls)
        td = run_closed_loop(tsrv, treqs, 6, events=ev(), controllers=tctls)
        for c in (jctls or []) + (tctls or []):
            c.advance(td)
        assert td == jd
        same_fleet(jsrv, tsrv)
        if auto:
            _same_controllers(jctls, tctls)
        out[name] = (jsrv, tsrv, tctls)
    return out


def test_kill_under_controller_no_loss_bitwise(kill_repair):
    _, ctrl, _ = kill_repair["control"]
    _, srv, ctls = kill_repair["auto"]
    assert sorted(f["rid"] for f in srv.finished) == list(range(12))
    assert {f["rid"]: f["tokens"] for f in srv.finished} == \
        {f["rid"]: f["tokens"] for f in ctrl.finished}
    assert sum(c.repairs for c in ctls) == 1 and len(srv.engines) == 2
    reps = [e for c in ctls for e in c.events if e["event"] == "repair"]
    assert len(reps) == 1 and reps[0]["trigger"] == "fail"
    # the spawned replica shares the one model with its siblings
    assert len({id(e.model) for e in srv.engines}) == 1


def test_repair_mttr_beats_scripted(kill_repair):
    jscript, script, _ = kill_repair["scripted"]
    jauto, auto, _ = kill_repair["auto"]
    m_script = mttr_from_events(script.fail_events, script.finished)
    m_auto = mttr_from_events(auto.fail_events, auto.finished)
    assert m_script == jax_mttr_from_events(jscript.fail_events,
                                            jscript.finished)
    assert m_auto == jax_mttr_from_events(jauto.fail_events,
                                          jauto.finished)
    assert m_script[0] is not None and m_auto[0] is not None
    assert m_auto[0] <= m_script[0]


def test_heartbeat_drain_triggers_repair(serve_factory, port_lm):
    jsrv, tsrv = _pair(serve_factory, port_lm, heartbeat=4.0)
    jctls, tctls = _controllers(jsrv, tsrv, lo=2, hi=2, window=16.0,
                                cooldown_up=16.0, cooldown_down=16.0)
    ev = lambda: [(6.0, lambda s, c: s.stall(1, 24, now=c))]  # noqa: E731
    jreqs, treqs = _closed()
    jd = jax_closed_loop(jsrv, jreqs, 6, events=ev(), controllers=jctls)
    td = run_closed_loop(tsrv, treqs, 6, events=ev(), controllers=tctls)
    for c in jctls + tctls:
        c.advance(td)
    assert td == jd
    same_fleet(jsrv, tsrv)
    _same_controllers(jctls, tctls)
    assert len(tsrv.heartbeat_events) == 1
    assert sum(c.repairs for c in tctls) == 1 and len(tsrv.engines) == 2
    assert len(tsrv.finished) == 12
    reps = [e for c in tctls for e in c.events if e["event"] == "repair"]
    assert reps[0]["trigger"] == "heartbeat"


# ---------------------------------------------------------------------------
# servebench --autoscale.
# ---------------------------------------------------------------------------

# tests/test_autoscale.py's flagged-row keys
AUTOSCALE_ROW_KEYS = {
    "autoscale", "scale_window", "scale_cooldown", "replica_hours",
    "scale_events", "repairs", "autoscale_attainment", "autoscale_events",
    "final_replicas", "requests_lost",
}
# tests/test_autoscale.py's invocation on test_serve_trace.py's arguments
AUTOSCALE_ARGS = ["--policies", "continuous", "--arrival", "poisson",
                  "--rate", "0.4", "--shape", "diurnal", "--autoscale",
                  "1:2", "--scale-window", "8", "--scale-cooldown", "8",
                  "--requests", "8", "--concurrency", "4"]


def _port_rows(port_lm, extra):
    args = servebench.build_parser().parse_args(
        ROW_ARGS + extra + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        return servebench.run(args, port_lm, CPU)


def test_servebench_autoscale_row_equals_jax(capsys, port_lm):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched):
        assert jax_servebench.main(ROW_ARGS + AUTOSCALE_ARGS
                                   + ["--platform", "cpu"]) == 0
    jrows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    out = _port_rows(port_lm, AUTOSCALE_ARGS)
    trows = [rec for rec, _, _ in out]
    assert row_mismatches(trows, jrows) == []
    plain = {rec_key for rec_key in
             _port_rows(port_lm, ["--policies", "continuous"])[0][0]}
    row = trows[0]
    assert set(row) == plain | {"shape"} | AUTOSCALE_ROW_KEYS
    assert row["autoscale"] == "1:2" and row["requests_lost"] == 0
    assert 1 <= row["final_replicas"] <= 2 and row["replica_hours"] > 0
    assert row["completed"] == row["requests"]


def test_servebench_autoscale_exits_nonzero_on_a_lost_request(
        capsys, port_lm, monkeypatch):
    """The no-loss gate: a planted loss (one request's finished record
    dropped at its completion) turns the exit code to 1; the same run
    unplanted exits 0."""
    from ddlbench_tpu_torch.serve.engine import ServeEngine

    argv = ROW_ARGS + AUTOSCALE_ARGS + ["--device", "cpu"]
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        assert servebench.main(argv) == 0
    real_complete = ServeEngine._complete

    def complete_loses_rid_3(self, a, t, rep):
        real_complete(self, a, t, rep)
        if a.req.rid == 3:
            self.finished.pop()

    monkeypatch.setattr(ServeEngine, "_complete", complete_loses_rid_3)
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        assert servebench.main(argv) == 1
    out = capsys.readouterr()
    rows = [json.loads(l) for l in out.out.splitlines()
            if l.startswith("{")]
    assert rows[-1]["requests_lost"] == 1
    assert "FAILED no-loss gate" in out.err
