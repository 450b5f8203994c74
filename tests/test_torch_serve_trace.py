"""The port's request-lifecycle tracing, the flight recorder and serveview
(ddlbench_tpu_torch/telemetry/{tracer,export,serveview}.py and the
engine's hooks) held against the JAX reference on the CPU — the
counterparts of tests/test_serve_trace.py for one replica.

* The tracer and exporter lay the same events on the same tracks; the
  truncation count and the loud warning hold.
* With the reference's weights carried over, the port's engine emits the
  SAME trace events as the reference's (name, phase, virtual timestamps,
  tracks and args) through queueing, chunked prefill, eviction and
  recompute, prefix hits and copy-on-write, speculative drafts, sheds and
  timeouts; the allocator's and the prefix index's hooks fire the same
  instants.
* Tracing is metrics-neutral: the finished records, the stats and
  servebench's row are the same traced or not.
* serveview's TTFT components sum exactly to each request's TTFT, and its
  reductions equal the reference's on the same trace.
* ``snapshot()`` and the flight recorder return the reference's dicts.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import unittest.mock as mock

import numpy as np
import pytest

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.allocator import PageAllocator as JaxAllocator
from ddlbench_tpu.serve.prefix import PrefixIndex as JaxPrefixIndex
from ddlbench_tpu.serve.workload import ServeRequest as JaxRequest
from ddlbench_tpu.telemetry import tracer as jax_tracer_mod
from ddlbench_tpu.telemetry.export import \
    chrome_trace_dict as jax_chrome_trace_dict
from ddlbench_tpu.telemetry.serveview import breakdown as jax_breakdown

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.engine import ServeEngine, make_server
from ddlbench_tpu_torch.serve.prefix import PrefixIndex
from ddlbench_tpu_torch.serve.workload import ServeRequest
from ddlbench_tpu_torch.telemetry import tracer as tracer_mod
from ddlbench_tpu_torch.telemetry.export import (chrome_trace_dict,
                                                 export_chrome_trace,
                                                 trace_truncation)
from ddlbench_tpu_torch.telemetry.serveview import breakdown
from ddlbench_tpu_torch.telemetry.serveview import main as serveview_main
from ddlbench_tpu_torch.telemetry.tracer import Tracer

from test_torch_serve import CPU
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import FLAGS, jax_rows, port_run, row_mismatches

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
TRACE_CFG = dict(max_batch=2, pool_pages=9, page=4, max_len=16,
                 prefill_chunk=4, token_budget=10)


@pytest.fixture(autouse=True)
def _restore_global_tracers():
    before = (tracer_mod.get_tracer(), jax_tracer_mod.get_tracer())
    yield
    tracer_mod.set_tracer(before[0])
    jax_tracer_mod.set_tracer(before[1])


def _fresh_tracers(capacity=200_000):
    """A fresh enabled tracer installed in each package."""
    return (jax_tracer_mod.set_tracer(
                jax_tracer_mod.Tracer(capacity)).enable(),
            tracer_mod.set_tracer(Tracer(capacity)).enable())


# ---------------------------------------------------------------------------
# Tracer, exporter and reducer plumbing (pure host code).
# ---------------------------------------------------------------------------


def _lay(tr):
    tr.emit("X", "queue_wait", 0, 3000, track="r0/req1", args={"rid": 1})
    tr.emit("X", "decode", 3000, 1000, track="r0/req2", args={"rid": 2})
    tr.emit("C", "queue_depth[r0]", 4000, track="r0/engine",
            args={"value": 2.0})
    tr.emit("i", "admit", 4000, track="r0/req1", args={"rid": 1})


def test_emit_and_export_equal_the_references():
    jtr, ttr = jax_tracer_mod.Tracer().enable(), Tracer().enable()
    _lay(jtr)
    _lay(ttr)
    assert ttr.events() == jtr.events()
    doc, jdoc = chrome_trace_dict(ttr), jax_chrome_trace_dict(jtr)
    assert doc["traceEvents"] == jdoc["traceEvents"]
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"r0/req1", "r0/req2", "r0/engine"}
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    # 1000 trace-ns = 1 exported µs = 1 model pass
    assert spans["queue_wait"]["dur"] == 3.0 and spans["decode"]["ts"] == 3.0
    # disabled: emit is a no-op like every other recording call
    ttr.disable()
    ttr.emit("X", "x", 0, 1)
    assert len(ttr) == 4


def test_export_metadata_capacity_and_truncation():
    tr = Tracer(capacity=4).enable()
    for i in range(9):
        tr.complete(f"e{i}", i, i + 1)
    doc = chrome_trace_dict(tr, extra_metadata={"serve": {"slo_ttft": 8.0}})
    meta = doc["metadata"]
    assert (meta["capacity"], meta["dropped_events"]) == (4, 5)
    assert meta["serve"] == {"slo_ttft": 8.0}
    assert meta["producer"] == "ddlbench_tpu_torch.telemetry"
    assert trace_truncation(doc) == trace_truncation(tr) == 5
    assert trace_truncation({"traceEvents": []}) == 0
    assert trace_truncation([]) == 0


def test_serveview_warns_loudly_on_a_truncated_trace(tmp_path, capsys):
    tr = Tracer(capacity=2).enable()
    for i in range(6):
        tr.emit("X", "decode", i * 1000, 1000, track="r0/req0",
                args={"rid": 0, "tok": i})
    path = tmp_path / "trunc.json"
    export_chrome_trace(tr, str(path))
    assert serveview_main([str(path)]) == 0
    captured = capsys.readouterr()
    assert "TRUNCATED" in captured.err and "serveview" in captured.err
    assert json.loads(captured.out)["dropped_events"] == 4
    assert breakdown(json.load(open(path)))["dropped_events"] == 4


def _hook_calls(alloc_cls, prefix_cls):
    seen = []
    al = alloc_cls(9)
    al.on_event = lambda name, **kw: seen.append((name, kw))
    slots = al.alloc(rid=1, n=2)
    idx = prefix_cls(al, page=4)
    idx.on_event = al.on_event
    prompt = np.arange(8, dtype=np.int32)
    for b, s in enumerate(slots):
        idx.register(prompt, b, s)
    idx.match(prompt)
    al.bind(2, slots[:1])
    al.alloc(rid=2, n=2)
    al.release(2, al.owned(2)[-1:])
    al.free_request(2)
    al.free_request(1)
    idx.reclaim(2)
    al.on_event = None  # hook removed: silent again (the trace-off path)
    al.alloc(rid=3, n=1)
    return seen


def test_allocator_and_prefix_hooks_fire_the_references_events():
    got = _hook_calls(PageAllocator, PrefixIndex)
    assert got == _hook_calls(JaxAllocator, JaxPrefixIndex)
    assert [n for n, _ in got] == [
        "pool_alloc", "prefix_hit", "pool_alloc", "pool_rollback",
        "pool_release", "pool_release", "prefix_reclaim"]
    assert got[-1] == ("prefix_reclaim",
                       {"asked": 2, "freed": 2, "entries": 0})


def _synthetic(tr):
    t = lambda u: int(u * 1000)  # noqa: E731 — virtual units -> trace ns

    def req_events(rid, submit, admit, chunks, ft, toks, finish):
        trk = f"r0/req{rid}"
        tr.emit("i", "submit", t(submit), track=trk, args={"rid": rid})
        tr.emit("X", "queue_wait", t(submit), t(admit) - t(submit),
                track=trk, args={"rid": rid})
        tr.emit("i", "admit", t(admit), track=trk,
                args={"rid": rid, "cached_tokens": 0})
        for c0, c1 in chunks:
            tr.emit("X", "prefill_chunk", t(c0), t(c1) - t(c0), track=trk,
                    args={"rid": rid})
        tr.emit("i", "first_token", t(ft), track=trk, args={"rid": rid})
        for k, (d0, d1) in enumerate(toks):
            tr.emit("X", "decode", t(d0), t(d1) - t(d0), track=trk,
                    args={"rid": rid, "tok": k + 1})
        tr.emit("i", "finish", t(finish), track=trk,
                args={"rid": rid, "n_tokens": 1 + len(toks)})

    # rid 0: queue 2, prefill [2,5)+[6,8) = 5, gap [5,6) = 1 -> ttft 8
    req_events(0, 0, 2, [(2, 5), (6, 8)], 8, [(9, 10)], 10)
    req_events(1, 1, 1, [(1, 2)], 2, [(2, 3), (5, 6), (6, 7)], 7)


def test_serveview_decomposition_on_synthetic_trace():
    jtr, ttr = jax_tracer_mod.Tracer().enable(), Tracer().enable()
    _synthetic(jtr)
    _synthetic(ttr)
    kw = dict(slo_ttft=8.0, slo_itl=2.5, window=8.0)
    out = breakdown(ttr, **kw)
    assert out == jax_breakdown(jtr, **kw)
    assert out == breakdown(chrome_trace_dict(ttr), **kw)
    assert out["requests"] == 2 and out["decomp_exact"]
    d = out["per_request"][0]
    assert (d["queue"], d["prefill"], d["sched_gap"], d["decode"],
            d["ttft"]) == (2.0, 5.0, 1.0, 0.0, 8.0)
    assert [b["completed"] for b in out["timeline"]] == [1, 1]


# ---------------------------------------------------------------------------
# The engine's events against the reference's.
# ---------------------------------------------------------------------------


def _mixed(make):
    # staggered prompts: chunked prefill, mixed steps, queueing
    rng = np.random.default_rng(3)
    return [make(rid=rid, prompt=rng.integers(0, VOCAB, size=(s,)).astype(
        np.int32), max_new=m, arrival=float(t))
        for rid, s, m, t in ((0, 3, 4, 0), (1, 9, 4, 0), (2, 5, 3, 4),
                             (3, 4, 2, 6))]


def _evicting(make):
    rng = np.random.default_rng(13)
    return [make(rid=rid, prompt=rng.integers(0, VOCAB, size=(9,)).astype(
        np.int32), max_new=12, arrival=0.0) for rid in range(2)]


def _prefix(make):
    head = np.random.default_rng(5).integers(0, VOCAB, size=(8,)).astype(
        np.int32)
    tail = np.concatenate([head, head[:3]])
    return [make(rid=0, prompt=head, max_new=3, arrival=0.0),
            make(rid=1, prompt=head, max_new=3, arrival=9.0),
            make(rid=2, prompt=tail, max_new=3, arrival=9.0)]


def _slo(make):
    rng = np.random.default_rng(22)
    reqs = [make(rid=rid, prompt=rng.integers(0, VOCAB, size=(5,)).astype(
        np.int32), max_new=8, arrival=0.0,
        tier="batch" if rid % 2 else "interactive",
        deadline=(None, 30.0, 4.0, 12.0, 40.0, 9.0)[rid])
        for rid in range(6)]
    return reqs


ENGINE_CASES = {
    "mixed": (TRACE_CFG, _mixed),
    "eviction": (dict(max_batch=2, pool_pages=9, page=4, max_len=24,
                      prefill_chunk=4), _evicting),
    "prefix": (dict(TRACE_CFG, pool_pages=17, prefix_cache=True), _prefix),
    "sampled_slo": (dict(TRACE_CFG, temperature=0.8, top_k=8), _slo),
    "speculative": (dict(TRACE_CFG, speculative="ngram:1:2"), _mixed),
}


def _serve(eng, reqs):
    pend = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    i, now = 0, 0.0
    while i < len(pend) or eng.has_work():
        while i < len(pend) and pend[i].arrival <= now:
            eng.submit(pend[i], now=now)
            i += 1
        if not eng.has_work():
            now = pend[i].arrival
            continue
        now += eng.step(now).cost
    return now


def traced_pair(serve_factory, port_lm, name):
    """(JAX engine, port engine, JAX tracer, port tracer) after serving
    the case traced."""
    kw, reqs = ENGINE_CASES[name]
    jtr, ttr = _fresh_tracers()
    jeng = serve_factory(JaxServeConfig(trace=True, **kw))
    teng = ServeEngine(port_lm, ServeConfig(trace=True, **kw), CPU)
    _serve(jeng, reqs(JaxRequest))
    _serve(teng, reqs(ServeRequest))
    return jeng, teng, jtr, ttr


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_trace_events_equal_the_references(serve_factory, port_lm,
                                                  name):
    jeng, teng, jtr, ttr = traced_pair(serve_factory, port_lm, name)
    assert teng.finished == jeng.finished
    assert ttr.events() == jtr.events()
    names = {e[1] for e in ttr.events()}
    assert {"submit", "queue_wait", "admit", "first_token", "decode",
            "finish", "pool_alloc", "pool_release"} <= names
    want = {"eviction": {"evict", "recompute", "prefill_chunk"},
            "prefix": {"prefix_hit"},
            "sampled_slo": {"shed", "timeout"},
            "speculative": {"draft", "verify", "accept"}}.get(
                name, {"prefill_chunk"})
    assert want <= names, want - names
    # counter tracks sampled every step
    depth = [e for e in ttr.events() if e[1] == "queue_depth[r0]"]
    assert len(depth) == teng.stats["steps"]
    # serveview's reductions of the two traces agree, and tile exactly
    bd = breakdown(ttr, slo_ttft=8.0, slo_itl=2.5, window=8.0)
    assert bd == jax_breakdown(jtr, slo_ttft=8.0, slo_itl=2.5, window=8.0)
    assert bd["decomp_exact"] and bd["requests"] == len(teng.finished)
    fin = {f["rid"]: f for f in teng.finished}
    for d in bd["per_request"]:
        assert d["queue"] + d["prefill"] + d["decode"] + d["sched_gap"] \
            == d["ttft"]
        assert d["ttft"] == fin[d["rid"]]["first_token_t"] \
            - fin[d["rid"]]["arrival"]


def test_tracing_is_metrics_neutral(port_lm):
    runs = {}
    for trace_on in (False, True):
        tr = tracer_mod.set_tracer(Tracer()).enable()
        eng = ServeEngine(port_lm, ServeConfig(trace=trace_on, **TRACE_CFG),
                          CPU)
        _serve(eng, _mixed(ServeRequest))
        runs[trace_on] = (eng, len(tr))
    (off, n_off), (on, n_on) = runs[False], runs[True]
    assert off.finished == on.finished  # tokens and virtual times
    assert off.stats == on.stats
    # a trace-off engine never touches the (enabled) tracer
    assert n_off == 0 and n_on > 0


# ---------------------------------------------------------------------------
# snapshot() and the flight recorder.
# ---------------------------------------------------------------------------


def _snapshots(eng, make):
    reqs = _mixed(make)
    for r in reqs:
        r.arrival = 0.0
        eng.submit(r)
    now, mid = 0.0, None
    while eng.has_work():
        now += eng.step(now).cost
        if mid is None and eng.queue:
            mid = eng.snapshot()
    return mid, eng.snapshot()


def test_snapshot_and_flight_recorder_equal_the_references(serve_factory,
                                                           port_lm):
    kw = dict(flight_recorder=8, slo_ttft=8.0, slo_itl=2.5, **TRACE_CFG)
    want = _snapshots(serve_factory(JaxServeConfig(**kw)), JaxRequest)
    mid, end = _snapshots(ServeEngine(port_lm, ServeConfig(**kw), CPU),
                          ServeRequest)
    assert (mid, end) == want
    assert mid["queue_depth"] > 0
    assert "queued" in {r["state"] for r in mid["requests"]}
    assert end["completed"] == 4 and end["active"] == 0
    assert 0 < len(end["recent_steps"]) <= 8
    assert end["recent_steps"][-1]["t"] == end["t"]
    # flight_recorder=0 disables the ring; snapshot() still works
    eng0 = ServeEngine(port_lm, ServeConfig(flight_recorder=0, **TRACE_CFG),
                       CPU)
    _serve(eng0, _mixed(ServeRequest)[:1])
    s = eng0.snapshot()
    assert s["recent_steps"] == [] and s["completed"] == 1


def test_server_snapshot_equals_the_references(serve_factory, port_lm):
    kw = dict(slo_ttft=8.0, slo_itl=2.5, **TRACE_CFG)
    jsrv = serve_factory(JaxServeConfig(**kw), server=True)
    tsrv = make_server(port_lm, ServeConfig(**kw), CPU)
    for srv, make in ((jsrv, JaxRequest), (tsrv, ServeRequest)):
        _serve(srv, _mixed(make))
    snap = tsrv.snapshot()
    assert snap == jsrv.snapshot()
    assert snap["completed"] == 4 and len(snap["replicas"]) == 1


# ---------------------------------------------------------------------------
# servebench --trace / --timeline and the serveview CLI.
# ---------------------------------------------------------------------------


TRACE_FLAGS = FLAGS["deadline"] + ["--tier-mix", "0.5", "--sample",
                                   "temperature:0.8,top-k:40"]


@pytest.fixture(scope="module")
def traced_rows(tmp_path_factory, port_lm):
    """The port's servebench rows untraced, traced, and traced with the
    timeline, one policy each, and their trace paths."""
    d = tmp_path_factory.mktemp("sbtrace")
    pol = ["--policies", "continuous"]
    rows = {"plain": port_run(port_lm, TRACE_FLAGS + pol)[0][0]}
    rows["traced"] = port_run(port_lm, TRACE_FLAGS + pol + [
        "--trace", str(d / "t.json")])[0][0]
    rows["timeline"] = port_run(port_lm, TRACE_FLAGS + pol + [
        "--trace", str(d / "tl.json"), "--timeline", "--window", "8"])[0][0]
    return rows, d


def test_servebench_trace_is_neutral(traced_rows):
    rows, _ = traced_rows
    assert json.dumps(rows["plain"]) == json.dumps(rows["traced"])


def test_servebench_timeline_row_and_trace_equal_jax(capsys, traced_rows,
                                                     tmp_path):
    """The --trace --timeline row equals the reference's field for field,
    and the trace file holds the reference's events."""
    rows, d = traced_rows
    flags = TRACE_FLAGS + ["--policies", "continuous", "--trace",
                           str(tmp_path / "jax.json"), "--timeline",
                           "--window", "8"]
    jrow = jax_rows(capsys, flags)[0]
    # the trace path differs, and it is not in the row
    assert row_mismatches([rows["timeline"]], [jrow]) == []
    assert rows["timeline"]["decomp_exact"] is True
    assert sum(b["tokens"] for b in rows["timeline"]["timeline"]) \
        == rows["timeline"]["output_tokens"]
    doc = json.load(open(d / "tl.json"))
    jdoc = json.load(open(tmp_path / "jax.json"))
    assert doc["traceEvents"] == jdoc["traceEvents"]
    assert doc["metadata"]["serve"] == jdoc["metadata"]["serve"]
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"shed", "timeout", "first_token", "prefill_chunk"} <= names


def test_serveview_cli_on_servebench_trace(traced_rows, capsys):
    from ddlbench_tpu.telemetry.serveview import main as jax_serveview_main

    rows, d = traced_rows
    path = str(d / "tl.json")
    assert serveview_main([path, "--window", "8", "--per-request"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert jax_serveview_main([path, "--window", "8",
                               "--per-request"]) == 0
    assert out == json.loads(capsys.readouterr().out)
    row = rows["timeline"]
    # a request that timed out after its first token decomposes too
    assert out["requests"] >= row["completed"] > 0
    assert out["decomp_exact"] is True and out["dropped_events"] == 0
    assert (out["slo_ttft"], out["slo_itl"]) == (8.0, 2.5)  # metadata
    from ddlbench_tpu_torch.tools.servebench import _round6

    assert _round6(out["timeline"]) == row["timeline"]
    for d_ in out["per_request"]:
        assert d_["queue"] + d_["prefill"] + d_["decode"] \
            + d_["sched_gap"] == d_["ttft"]
