"""The port's replicated serving fleet (ddlbench_tpu_torch/serve/engine.py
ReplicatedServer, fleet_stats, make_server; train/watchdog.py
ProgressMonitor) held against the JAX reference on the CPU: the
counterparts of tests/test_serve.py's replicated server, tests/
test_elastic.py's resize and drain pins and tests/test_serve_chaos.py's
fleet pins.

With the reference's weights carried over, the two fleets must keep the
same records on the same traffic: finished, timed-out and shed records,
every engine's eviction log, the fail, stall, heartbeat and resize event
ledgers, the fleet's stats summary and snapshot, and the trace events of
a traced run. Besides:

* least-loaded dispatch spreads work over every replica, and a killed,
  stalled, drained or resized fleet loses no request and keeps every
  token stream of the unfaulted run;
* every replica shares the one model object (one copy of the weights)
  with a KV pool of its own, a retired replica's pool is released, and
  replica ids grow monotonically across resizes;
* servebench's ``--replicas``, ``--resize`` and ``--heartbeat`` rows equal
  the reference's on every field but the provenance, its argument errors
  for those flags are the reference's, and the reference's flags that wait
  for a later slice fail naming their ROADMAP item.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import unittest.mock as mock

import numpy as np
import pytest

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.workload import ServeRequest as JaxRequest
from ddlbench_tpu.serve.workload import make_workload as jax_workload
from ddlbench_tpu.telemetry import tracer as jax_tracer_mod
from ddlbench_tpu.tools.servebench import \
    run_closed_loop as jax_closed_loop
from ddlbench_tpu.tools.servechaos import \
    mttr_from_events as jax_mttr_from_events
from ddlbench_tpu.train.watchdog import ProgressMonitor as JaxMonitor

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.serve.engine import (ReplicatedServer, ServeEngine,
                                             make_server)
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry import tracer as tracer_mod
from ddlbench_tpu_torch.tools import servebench
from ddlbench_tpu_torch.tools.servebench import run_closed_loop
from ddlbench_tpu_torch.tools.servechaos import mttr_from_events
from ddlbench_tpu_torch.train.watchdog import ProgressMonitor

from test_torch_serve import CPU
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import (ROW_ARGS, TINY, drains_clean,
                                  row_mismatches)

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
# tests/test_elastic.py's and test_serve_chaos.py's fleet shapes
FLEET = dict(max_batch=4, pool_pages=20, page=4, max_len=16,
             prefill_chunk=4, replicas=2)


def _servers(serve_factory, port_lm, **kw):
    """The reference's fleet and the port's for one config."""
    cfg = {**FLEET, **kw}
    return (serve_factory(JaxServeConfig(**cfg), server=True),
            make_server(port_lm, ServeConfig(**cfg), CPU))


def _workloads(seed=3, n=12, **kw):
    wl = dict(seed=seed, n_requests=n, vocab=VOCAB, arrival="closed",
              prompt_lo=2, prompt_typical=5, prompt_hi=9, out_lo=2,
              out_typical=4, out_hi=6, max_len=16, **kw)
    return jax_workload(**wl), make_workload(**wl)


def _streams(srv):
    return {f["rid"]: f["tokens"] for f in srv.finished}


def same_fleet(jsrv, tsrv):
    """Every record and ledger of two fleets, and their stats summaries
    (the SDC counters, all 0 here, included)."""
    for key in ("finished", "timed_out", "shed_records", "resize_events",
                "fail_events", "stall_events", "heartbeat_events"):
        assert getattr(tsrv, key) == getattr(jsrv, key), key
    jall = jsrv.engines + jsrv._retired
    tall = tsrv.engines + tsrv.retired
    assert [e.replica for e in tall] == [e.replica for e in jall]
    assert [e.evicted_log for e in tall] == [e.evicted_log for e in jall]
    js, ts = jsrv.stats_summary(), tsrv.stats_summary()
    assert set(ts) == set(js)
    for k in ts:
        assert ts[k] == js[k], k


def _run_both(jsrv, tsrv, jreqs, treqs, concurrency=6, **kw):
    """The reference's closed-loop driver on its fleet and the port's on
    the port's, with the same keyword arguments (events are built per
    package by ``kw["events"]``, a callable of the package)."""
    make_events = kw.pop("events", None)
    jc = jax_closed_loop(jsrv, jreqs, concurrency,
                         events=make_events() if make_events else None, **kw)
    tc = run_closed_loop(tsrv, treqs, concurrency,
                         events=make_events() if make_events else None, **kw)
    assert tc == jc
    return tc


# ---------------------------------------------------------------------------
# ProgressMonitor and the fleet knobs of ServeConfig.
# ---------------------------------------------------------------------------


def test_progress_monitor_equals_jax():
    for mon_cls in (ProgressMonitor, JaxMonitor):
        m = mon_cls(4.0, now=10.0)
        assert not m.expired(14.0)
        assert m.expired(14.5)
        m.kick(14.5)
        assert not m.expired(18.0)
        assert m.stalled_for(16.5) == 2.0
        assert m.last_progress == 14.5
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError) as got:
            ProgressMonitor(bad)
        with pytest.raises(ValueError) as want:
            JaxMonitor(bad)
        assert str(got.value) == str(want.value)


def test_fleet_knobs_validate_like_the_reference():
    ServeConfig(replicas=3, heartbeat=4.0).validate()
    for kw in (dict(replicas=0), dict(heartbeat=-1.0)):
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw).validate()
        with pytest.raises(ValueError) as want:
            JaxServeConfig(**kw).validate()
        assert str(got.value) == str(want.value)


def test_engine_monitor_and_replica_tracks(port_lm):
    srv = make_server(port_lm, ServeConfig(**FLEET, heartbeat=4.0), CPU)
    assert [e.replica for e in srv.engines] == [0, 1]
    assert [e._trk for e in srv.engines] == ["r0", "r1"]
    assert all(e.monitor.window == 4.0 for e in srv.engines)
    assert all(e.cfg.replicas == 1 for e in srv.engines)
    plain = make_server(port_lm, ServeConfig(**FLEET), CPU)
    assert all(e.monitor is None for e in plain.engines)
    with pytest.raises(ValueError, match="at least one engine"):
        ReplicatedServer([])


# ---------------------------------------------------------------------------
# Dispatch, resize and drain (tests/test_serve.py, tests/test_elastic.py).
# ---------------------------------------------------------------------------


def test_replicated_server_matches_jax(serve_factory, port_lm):
    """Least-loaded dispatch over 2 replicas: the reference's records and
    streams, work on both engines, and every stream that of a one-replica
    server."""
    wl = dict(seed=9, n_requests=6, vocab=VOCAB, arrival="closed",
              prompt_lo=2, prompt_typical=6, prompt_hi=10, out_lo=2,
              out_typical=5, out_hi=8, max_len=16)
    cfg = dict(max_batch=2, pool_pages=9, page=4, max_len=16,
               prefill_chunk=4)
    jsrv, tsrv = _servers(serve_factory, port_lm, **cfg)
    single = make_server(port_lm, ServeConfig(**cfg), CPU)
    for srv, reqs in ((jsrv, jax_workload(**wl)), (tsrv, make_workload(**wl)),
                      (single, make_workload(**wl))):
        for r in reqs:
            r.arrival = 0.0
            srv.submit(r)
        now = 0.0
        while srv.has_work():
            now += srv.step(now).cost
    same_fleet(jsrv, tsrv)
    assert len(tsrv.finished) == 6
    assert all(e.stats["admitted"] > 0 for e in tsrv.engines)
    assert _streams(tsrv) == _streams(single)


def test_resize_no_request_lost_streams_bitwise(serve_factory, port_lm):
    """Shrink 2 -> 1 mid-run, then grow 1 -> 3: the reference's records
    and resize ledger, every request completed, every stream that of the
    un-resized control."""
    ctrl = make_server(port_lm, ServeConfig(**FLEET), CPU)
    run_closed_loop(ctrl, _workloads()[1], 6)
    jsrv, tsrv = _servers(serve_factory, port_lm)
    _run_both(jsrv, tsrv, *_workloads(), resizes=[(6.0, 1), (14.0, 3)])
    same_fleet(jsrv, tsrv)
    assert _streams(tsrv) == _streams(ctrl)
    assert set(_streams(tsrv)) == set(range(12))
    assert len(tsrv.engines) == 3
    assert [e["to"] for e in tsrv.resize_events] == [1, 3]
    assert tsrv.resize_events[0]["from"] == 2
    assert tsrv.stats_summary()["completed"] == 12
    # replica ids grow monotonically: 1 was drained, 2 and 3 spawned
    assert [e.replica for e in tsrv.engines] == [0, 2, 3]
    for eng in tsrv.engines + tsrv.retired:
        assert drains_clean(eng)


def test_resize_scale_up_shares_model_and_guards(port_lm):
    """Scale-up engines share the one model object and its parameters'
    storage, each with a pool of its own; a bare-engine server refuses
    scale-up; n < 1 is rejected; scale-down releases the pool."""
    srv = make_server(port_lm, ServeConfig(**{**FLEET, "replicas": 1}), CPU)
    srv.resize(2)
    e0, e1 = srv.engines
    assert e1.model is e0.model is port_lm
    for p0, p1 in zip(e0.model.parameters(), e1.model.parameters()):
        assert p0.data_ptr() == p1.data_ptr()
    pools = [(p["pool_k"].data_ptr(), q["pool_k"].data_ptr())
             for p, q in zip(e0.pools, e1.pools) if p is not None]
    assert pools and all(a != b for a, b in pools)
    with pytest.raises(ValueError, match=">= 1"):
        srv.resize(0)
    srv.resize(1)
    assert all(p is None for p in srv.retired[0].pools)
    assert any(p is not None for p in srv.engines[0].pools)
    bare = ReplicatedServer([
        ServeEngine(port_lm, ServeConfig(**{**FLEET, "replicas": 1}), CPU),
        ServeEngine(port_lm, ServeConfig(**{**FLEET, "replicas": 1}), CPU)])
    with pytest.raises(RuntimeError, match="factory"):
        bare.resize(3)
    bare.resize(1)  # scale-down needs no factory
    assert len(bare.engines) == 1


def _drain_fixture(eng, make_req):
    for rid in range(6):
        eng.submit(make_req(rid=rid,
                            prompt=np.arange(1, 6, dtype=np.int32) % VOCAB,
                            max_new=4, arrival=0.0))
    t = 0.0
    for _ in range(3):
        t += eng.step(t).cost
    active = sum(1 for a in eng.rows if a is not None)
    queued = len(eng.queue)
    reqs, evicted, handoff = eng.drain(t)
    return t, active, queued, [r.rid for r in reqs], evicted, handoff


def test_engine_drain_requeues_everything(serve_factory, port_lm):
    """drain(): every active request evicted (pages freed), the queue
    handed back with each request's (queued_at, evicted) handoff, the
    reference's answer."""
    cfg = {**FLEET, "replicas": 1}
    teng = ServeEngine(port_lm, ServeConfig(**cfg), CPU)
    got = _drain_fixture(teng, ServeRequest)
    want = _drain_fixture(serve_factory(JaxServeConfig(**cfg)), JaxRequest)
    assert got == want
    t, active, queued, rids, evicted, handoff = got
    assert active > 0 and evicted == active
    assert len(rids) == active + queued
    assert sum(1 for _, ev in handoff.values() if ev) == active
    for rid in rids:
        q0, was_evicted = handoff[rid]
        assert q0 == (t if was_evicted else 0.0)
    assert {f["rid"] for f in teng.finished} | set(rids) == set(range(6))
    assert drains_clean(teng)


# ---------------------------------------------------------------------------
# Kill, stall, heartbeat (tests/test_serve_chaos.py).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_ctrl(serve_factory, port_lm):
    """The unfaulted control with the heartbeat armed, both fleets: the
    stream reference of every fault run here, and the no-false-positive
    pin (a healthy fleet never drains anyone)."""
    jsrv, tsrv = _servers(serve_factory, port_lm, heartbeat=4.0)
    _run_both(jsrv, tsrv, *_workloads())
    same_fleet(jsrv, tsrv)
    assert tsrv.heartbeat_events == tsrv.fail_events == []
    return _streams(tsrv)


def _kill(at, r):
    return lambda: [(at, lambda s, clock: s.fail(r, now=clock))]


def test_fail_mid_decode_failover_bitwise(serve_factory, port_lm,
                                          fleet_ctrl):
    jsrv, tsrv = _servers(serve_factory, port_lm)
    _run_both(jsrv, tsrv, *_workloads(), events=_kill(6.0, 1))
    same_fleet(jsrv, tsrv)
    ev, = tsrv.fail_events
    assert ev["displaced_inflight"] and ev["shed_on_failover"] == 0
    assert _streams(tsrv) == fleet_ctrl
    rids = [f["rid"] for f in tsrv.finished]
    assert sorted(rids) == list(range(12))  # exactly once
    assert len(tsrv.engines) == 1
    mttrs = mttr_from_events(tsrv.fail_events, tsrv.finished)
    assert mttrs == jax_mttr_from_events(jsrv.fail_events, jsrv.finished)
    assert mttrs[0] > 0


def test_fail_salvages_finished_and_counters(serve_factory, port_lm):
    fired = {}

    def events():
        def kill(s, clock):
            fired.setdefault("salvaged", []).append(
                {f["rid"] for f in s.engines[1].finished})
            s.fail(1, now=clock)
        return [(10.0, kill)]

    jsrv, tsrv = _servers(serve_factory, port_lm)
    _run_both(jsrv, tsrv, *_workloads(), events=events)
    same_fleet(jsrv, tsrv)
    ev, = tsrv.fail_events
    salvaged = fired["salvaged"][1]
    assert fired["salvaged"][0] == salvaged
    assert ev["salvaged"] == len(salvaged) > 0
    assert not set(ev["displaced_inflight"]) & salvaged
    s = tsrv.stats_summary()
    assert s["completed"] == 12
    assert s["admitted"] >= 12 + len(ev["displaced_inflight"])
    # the killed replica holds no work and its pool is released
    dead = tsrv.retired[0]
    assert not dead.has_work() and all(p is None for p in dead.pools)


def test_fail_and_stall_guards_are_the_references(serve_factory, port_lm):
    jsrv, tsrv = _servers(serve_factory, port_lm, replicas=1)
    for call, exc in ((lambda s: s.fail(0), ValueError),
                      (lambda s: s.fail(3), IndexError),
                      (lambda s: s.stall(3, 5), IndexError),
                      (lambda s: s.stall(0, 0), ValueError)):
        with pytest.raises(exc) as got:
            call(tsrv)
        with pytest.raises(exc) as want:
            call(jsrv)
        assert str(got.value) == str(want.value)


def _stall(at, r, ticks):
    return lambda: [(at, lambda s, clock: s.stall(r, ticks, now=clock))]


def test_stall_heartbeat_drains_within_window(serve_factory, port_lm,
                                              fleet_ctrl):
    jsrv, tsrv = _servers(serve_factory, port_lm, heartbeat=4.0)
    _run_both(jsrv, tsrv, *_workloads(), events=_stall(5.0, 0, 50))
    same_fleet(jsrv, tsrv)
    assert len(tsrv.stall_events) == 1
    hb, = tsrv.heartbeat_events
    assert 4.0 < hb["stalled_for"] <= 4.0 + 8.0
    assert hb["evicted"] > 0
    assert _streams(tsrv) == fleet_ctrl
    assert len(tsrv.engines) == 1
    for eng in tsrv.engines + tsrv.retired:
        assert drains_clean(eng)


def test_stall_without_heartbeat_just_delays(serve_factory, port_lm,
                                             fleet_ctrl):
    jsrv, tsrv = _servers(serve_factory, port_lm)
    _run_both(jsrv, tsrv, *_workloads(), events=_stall(5.0, 0, 6))
    same_fleet(jsrv, tsrv)
    assert tsrv.heartbeat_events == [] and len(tsrv.engines) == 2
    assert _streams(tsrv) == fleet_ctrl


def test_all_stalled_fleet_still_costs_one(port_lm):
    srv = make_server(port_lm, ServeConfig(**FLEET), CPU)
    srv.submit(ServeRequest(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                            max_new=2, arrival=0.0))
    srv.stall(0, 2)
    srv.stall(1, 2)
    assert srv.step(0.0).cost == 1
    assert srv.engines[0]._stall_ticks == 1


class _AlwaysDrafter:
    """Drafts K copies of the last token: a drafter that always proposes,
    so a drain strikes pre-allocated speculative pages (the reference
    test's drafter)."""

    K = 3

    def propose(self, ctx, k):
        return [int(ctx[-1])] * min(k, self.K)


SPEC = dict(max_batch=2, pool_pages=17, page=4, max_len=16, prefill_chunk=4)


def _drain_mid_spec(eng, make_req, prompts):
    eng._drafter = _AlwaysDrafter()
    for rid in (0, 1):
        eng.submit(make_req(rid=rid, prompt=prompts[rid], max_new=9,
                            arrival=0.0))
    t = 0.0
    for _ in range(3):
        t += eng.step(t).cost
    drafted = eng.stats["spec_drafted"]
    reqs, evicted, handoff = eng.drain(t)
    return t, drafted, reqs, evicted, handoff


def test_drain_mid_spec_rolls_back_draft_pages_no_leak(serve_factory,
                                                       port_lm):
    """drain() with speculative draft pages in flight returns every page,
    as the reference's does, and the displaced requests replay on a
    sibling engine to the streams of plain decoding."""
    rng = np.random.default_rng(26)
    prompts = {rid: rng.integers(0, VOCAB, size=(5,)).astype(np.int32)
               for rid in (0, 1)}
    spec_cfg = ServeConfig(**SPEC, speculative="ngram:2:3")
    ctrl = ServeEngine(port_lm, ServeConfig(**SPEC), CPU)
    for rid in (0, 1):
        ctrl.submit(ServeRequest(rid=rid, prompt=prompts[rid], max_new=9,
                                 arrival=0.0))
    while ctrl.has_work():
        ctrl.step(0.0)
    eng = ServeEngine(port_lm, spec_cfg, CPU)
    t, drafted, reqs, evicted, handoff = _drain_mid_spec(
        eng, ServeRequest, prompts)
    jeng = serve_factory(JaxServeConfig(**SPEC, speculative="ngram:2:3"))
    jt, jdrafted, jreqs, jevicted, jhandoff = _drain_mid_spec(
        jeng, JaxRequest, prompts)
    assert (t, drafted, [r.rid for r in reqs], evicted, handoff) == (
        jt, jdrafted, [r.rid for r in jreqs], jevicted, jhandoff)
    assert drafted > 0 and evicted > 0
    assert eng.allocator.in_use == 0  # draft and request pages all back
    eng2 = ServeEngine(port_lm, spec_cfg, CPU)
    eng2._drafter = _AlwaysDrafter()
    for r in reqs:
        eng2.submit(r)
    while eng2.has_work():
        t += eng2.step(t).cost
    assert {**_streams(eng), **_streams(eng2)} == _streams(ctrl)


def test_resize_mid_spec_streams_bitwise(serve_factory, port_lm):
    kw = dict(SPEC, speculative="ngram:2:3", replicas=2)

    def workloads():
        w = dict(seed=11, n_requests=10, vocab=VOCAB, arrival="closed",
                 prompt_lo=2, prompt_typical=5, prompt_hi=8, out_lo=2,
                 out_typical=5, out_hi=8, max_len=16)
        return jax_workload(**w), make_workload(**w)

    ctrl = make_server(port_lm, ServeConfig(**kw), CPU)
    run_closed_loop(ctrl, workloads()[1], 5)
    jsrv = serve_factory(JaxServeConfig(**kw), server=True)
    tsrv = make_server(port_lm, ServeConfig(**kw), CPU)
    _run_both(jsrv, tsrv, *workloads(), concurrency=5, resizes=[(5.0, 1)])
    same_fleet(jsrv, tsrv)
    assert _streams(tsrv) == _streams(ctrl)
    assert set(_streams(tsrv)) == set(range(10))
    for eng in tsrv.engines + tsrv.retired:
        assert eng.allocator.in_use == 0


# ---------------------------------------------------------------------------
# Fleet snapshot and trace events.
# ---------------------------------------------------------------------------


def _snapshots(srv, reqs):
    for r in reqs:
        r.arrival = 0.0
        srv.submit(r)
    now, mid = 0.0, None
    while srv.has_work():
        now += srv.step(now).cost
        if mid is None and now >= 4.0:
            mid = srv.snapshot()
            srv.resize(3, now)
    return mid, srv.snapshot()


def test_fleet_snapshot_equals_jax(serve_factory, port_lm):
    jsrv, tsrv = _servers(serve_factory, port_lm, slo_ttft=8.0,
                          slo_itl=2.5)
    jreqs, treqs = _workloads(n=8)
    want = _snapshots(jsrv, jreqs)
    got = _snapshots(tsrv, treqs)
    assert got == want
    mid = got[0]
    assert len(mid["replicas"]) == 2 and mid["active"] > 0
    assert [s["replica"] for s in got[1]["replicas"]] == [0, 1, 2]


@pytest.fixture
def _restore_tracers():
    before = (tracer_mod.get_tracer(), jax_tracer_mod.get_tracer())
    yield
    tracer_mod.set_tracer(before[0])
    jax_tracer_mod.set_tracer(before[1])


def test_traced_fleet_events_equal_jax(serve_factory, port_lm,
                                       _restore_tracers):
    """A traced fleet run through a kill and a resize lays the reference's
    events on the reference's per-replica tracks."""
    jtr = jax_tracer_mod.set_tracer(jax_tracer_mod.Tracer()).enable()
    ttr = tracer_mod.set_tracer(tracer_mod.Tracer()).enable()
    jsrv, tsrv = _servers(serve_factory, port_lm, replicas=3, trace=True)
    _run_both(jsrv, tsrv, *_workloads(),
              events=lambda: [(4.0, lambda s, c: s.fail(2, now=c)),
                              (9.0, lambda s, c: s.resize(3, now=c))])
    same_fleet(jsrv, tsrv)
    got, want = ttr.events(), jtr.events()
    strip = lambda evs: [(p, n, t0, d, trk, a)  # noqa: E731
                         for p, n, t0, d, _, trk, a in evs]
    assert strip(got) == strip(want)
    tracks = {e[5] for e in got}
    assert {"r0", "r1", "r2", "r3"} <= {t.split("/")[0] for t in tracks}


# ---------------------------------------------------------------------------
# servebench: the fleet flags' rows and errors.
# ---------------------------------------------------------------------------

FLEET_FLAGS = {
    # tests/test_elastic.py's servebench --resize e2e, on the tiny LM
    "resize": ["--policies", "continuous", "--arrival", "closed",
               "--concurrency", "6", "--requests", "16", "--max-batch", "4",
               "--pool-pages", "24", "--page", "8", "--max-len", "32",
               "--prompt-lens", "2,6,12", "--out-lens", "2,4,8",
               "--replicas", "2", "--resize", "8:1", "--resize", "24:3",
               "--resize", "900:1"],
    # slack 6 sheds on this traffic: the fleet-wide deadline probe
    "replicas": ["--arrival", "poisson", "--rate", "2.0", "--replicas", "3",
                 "--deadline-slack", "6", "--retry", "2:2",
                 "--tier-mix", "0.3"],
    "heartbeat": ["--arrival", "closed", "--concurrency", "6",
                  "--replicas", "2", "--heartbeat", "4", "--wall-clock"],
}
_JAX_FLEET_ROWS = {}


def jax_fleet_rows(capsys, flags):
    key = tuple(flags)
    if key not in _JAX_FLEET_ROWS:
        import ddlbench_tpu.config as jconfig
        from ddlbench_tpu.tools import servebench as jax_servebench

        patched = dict(jconfig.DATASETS)
        patched["tinylm"] = TINY_LM
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched):
            assert jax_servebench.main(ROW_ARGS + flags
                                       + ["--platform", "cpu"]) == 0
        _JAX_FLEET_ROWS[key] = [json.loads(l) for l in
                                capsys.readouterr().out.splitlines()
                                if l.startswith("{")]
    return _JAX_FLEET_ROWS[key]


def port_fleet_run(port_lm, flags):
    args = servebench.build_parser().parse_args(
        ROW_ARGS + flags + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        return servebench.run(args, port_lm, CPU)


WALL = {"wall_s", "wall_tokens_per_s", "decode_step_ms",
        "prefill_chunk_ms"}


@pytest.mark.parametrize("name", sorted(FLEET_FLAGS))
def test_servebench_fleet_rows_equal_jax_rows(capsys, port_lm, name):
    jrows = jax_fleet_rows(capsys, FLEET_FLAGS[name])
    out = port_fleet_run(port_lm, FLEET_FLAGS[name])
    trows = [rec for rec, _, _ in out]
    drop = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                          if k not in WALL} for r in rows]
    assert row_mismatches(drop(trows), drop(jrows)) == []
    row = trows[0]
    if name == "resize":
        assert row["requests_lost"] == 0 and row["completed"] == 16
        assert row["final_replicas"] == 3
        assert [e["to"] for e in row["resize_events"]] == [1, 3]
        assert row["resizes_unfired"] == 1
    if name == "replicas":
        assert row["replicas"] == 3 and row["requests_lost"] == 0
        assert row["shed"] > 0 and row["retries"] > 0
    if name == "heartbeat":
        assert row["heartbeat"] == 4.0 and row["heartbeat_drains"] == 0
        assert row["wall_s"] > 0 and row["decode_step_ms"] > 0
    for _, server, _ in out:
        for eng in server.engines:
            assert drains_clean(eng)


def test_servebench_fleet_argument_errors_are_the_references(capsys):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    for extra in (["--resize", "8"], ["--resize", "-1:2"],
                  ["--resize", "4:0"], ["--autoscale", "2"],
                  ["--autoscale", "0:2"], ["--autoscale", "3:2"],
                  ["--autoscale", "1:2", "--resize", "4:2"],
                  ["--autoscale", "1:2", "--scale-window", "0"],
                  ["--autoscale", "1:2", "--scale-cooldown", "-1"],
                  ["--heartbeat", "-1"]):
        errs = []
        for main, tail in ((jax_servebench.main, ["--platform", "cpu"]),
                           (servebench.main, ["--device", "cpu"])):
            with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                    mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}), \
                    pytest.raises(SystemExit):
                main(ROW_ARGS + extra + tail)
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0] == errs[1], extra


@pytest.mark.parametrize("extra", [
    ["--disaggregate", "1"], ["--disaggregate", "0:1"],
    ["--disaggregate", "1:1"],
    ["--disaggregate", "1:1", "--policies", "continuous",
     "--replicas", "2"],
    ["--disaggregate", "1:1", "--policies", "continuous",
     "--resize", "4:2"],
    ["--scrub", "-1"]], ids=lambda e: " ".join(e))
def test_servebench_disagg_and_scrub_errors_are_the_references(capsys,
                                                               extra):
    """--disaggregate and --scrub are ported: their argument errors (a
    malformed or empty fleet, the static policy, --replicas, --resize, a
    negative scrub) are the reference's, word for word."""
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    errs = []
    for main, tail in ((jax_servebench.main, ["--platform", "cpu"]),
                       (servebench.main, ["--device", "cpu"])):
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}), \
                pytest.raises(SystemExit):
            main(ROW_ARGS + extra + tail)
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]


@pytest.mark.parametrize("flag,value,item", [
    ("--serve-tp", "2", None), ("--paged-kernel", "dots", "A.8"),
    ("--audit", "x.json", "A.8")])
def test_servebench_flags_of_later_slices_name_their_item(capsys, flag,
                                                          value, item):
    """Each flag of a later slice exits naming its ROADMAP item;
    ``--serve-tp`` (item None), once refused here, runs and is named in
    the row (tests/test_torch_serve_tp.py holds its streams)."""
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        if item is None:
            assert servebench.main(ROW_ARGS + [flag, value, "--device",
                                               "cpu"]) == 0
            row = json.loads(capsys.readouterr().out.splitlines()[-1])
            assert row["serve_tp"] == int(value)
            assert row["completed"] == row["requests"]
            return
        with pytest.raises(SystemExit):
            servebench.main(ROW_ARGS + [flag, value, "--device", "cpu"])
    err = capsys.readouterr().err
    assert f"{flag} is not ported" in err and f"ROADMAP {item}" in err
