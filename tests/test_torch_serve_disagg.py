"""The port's disaggregated serving (ddlbench_tpu_torch/serve/handoff.py,
the page shipping of serve/engine.py, the per-fleet controllers of
serve/autoscaler.py and servebench/servechaos ``--disaggregate``) held
against the JAX reference on the CPU: the counterparts of tests/
test_serve_disagg.py (its two tp cases are
tests/test_torch_serve_tp.py's) and of tests/test_autoscale.py's
per-fleet controller pin.

With the reference's weights carried over (convert.from_jax_params), a
P:D server of the port keeps the reference's records on the same traffic,
exactly: the finished, timed-out and shed records (token streams and
virtual times), the fail and resize ledgers, the ``shipped_*`` counters
and the stats summary, for float32 and int8 pools at 1:1, 1:2 and 2:1.
Virtual-time fields are exact (no tolerance). Besides:

* the streams equal the aggregated fleet's, every request ships exactly
  once, and an int8 pool ships exactly a quarter of float32's payload;
* one request's export/import round trip carries the reference's ship
  (the same pages, counters and host rows; float32 K/V rows within 1e-5
  absolute of the reference's, int8 rows and scales within one
  quantisation step, as the engines compute K/V in different frameworks)
  and finishes with the single-engine stream;
* a prefill kill mid-handoff and a decode kill that re-ships through the
  prefill fleet keep every stream bitwise, and ``fail_decode`` really
  routes through the prefill dispatcher;
* servebench's and servechaos's ``--disaggregate`` rows equal the
  reference's on every field but the provenance, and per-fleet autoscale
  decisions equal the reference's.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import contextlib
import io
import json
import unittest.mock as mock

import numpy as np
import pytest

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.autoscaler import AutoscalePolicy as JaxPolicy
from ddlbench_tpu.serve.autoscaler import \
    make_controllers as jax_make_controllers
from ddlbench_tpu.serve.handoff import \
    DisaggregatedServer as JaxDisaggregated
from ddlbench_tpu.serve.handoff import export_request as jax_export
from ddlbench_tpu.serve.workload import ServeRequest as JaxRequest
from ddlbench_tpu.serve.workload import make_workload as jax_workload
from ddlbench_tpu.tools.servebench import \
    run_closed_loop as jax_closed_loop

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.serve.autoscaler import (AutoscalePolicy,
                                                 make_controllers)
from ddlbench_tpu_torch.serve.engine import (ReplicatedServer, ServeEngine,
                                             make_server)
from ddlbench_tpu_torch.serve.handoff import (DisaggregatedServer,
                                              export_request,
                                              make_disaggregated)
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.tools import servebench, servechaos
from ddlbench_tpu_torch.tools.servebench import run_closed_loop

from test_torch_serve import _JAX_PROV, _PORT_PROV, CPU
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import TINY, drains_clean

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
N_LAYERS = 2  # tiny_transformer's attention blocks
# tests/test_serve_disagg.py's shapes
FLEET = dict(max_batch=4, pool_pages=20, page=4, max_len=16,
             prefill_chunk=4)


def _workloads(seed=3, n=12):
    wl = dict(seed=seed, n_requests=n, vocab=VOCAB, arrival="closed",
              prompt_lo=2, prompt_typical=5, prompt_hi=9, out_lo=2,
              out_typical=4, out_hi=6, max_len=16)
    return jax_workload(**wl), make_workload(**wl)


def _streams(srv):
    return {f["rid"]: f["tokens"] for f in srv.finished}


def _disagg_pair(serve_factory, port_lm, prefill, decode, **kw):
    """The reference's P:D server (its fleets from the shared serve_factory,
    as its own tests build them) and the port's."""
    cfg = {**FLEET, **kw}
    jsrv = JaxDisaggregated(
        serve_factory(JaxServeConfig(**cfg, replicas=prefill), server=True),
        serve_factory(JaxServeConfig(**cfg, replicas=decode), server=True))
    return jsrv, make_disaggregated(port_lm, ServeConfig(**cfg), CPU,
                                    prefill, decode)


def same_disagg(jsrv, tsrv):
    """Every record, ledger and counter of two disaggregated servers."""
    for key in ("finished", "timed_out", "shed_records", "fail_events",
                "resize_events", "sdc_events"):
        assert getattr(tsrv, key) == getattr(jsrv, key), key
    assert tsrv.shipped == jsrv.shipped
    assert tsrv.wire_sdc == jsrv.wire_sdc
    js, ts = jsrv.stats_summary(), tsrv.stats_summary()
    assert set(ts) == set(js)
    for k in ts:
        assert ts[k] == js[k], k
    assert len(tsrv._pending) == len(jsrv._pending) == 0


def _run_pair(jsrv, tsrv, concurrency=6, events=None, seed=3, n=12):
    """Both servers through their package's closed-loop driver on the
    same traffic; ``events`` builds the injection list for one server."""
    jreqs, treqs = _workloads(seed, n)
    jc = jax_closed_loop(jsrv, jreqs, concurrency,
                         events=events(jsrv) if events else None)
    tc = run_closed_loop(tsrv, treqs, concurrency,
                         events=events(tsrv) if events else None)
    assert tc == jc
    return tc


_RUNS = {}


def disagg_run(serve_factory, port_lm, prefill, decode, kv_dtype):
    """One reference/port pair run per layout and pool type, shared by the
    tests below."""
    key = (prefill, decode, kv_dtype)
    if key not in _RUNS:
        pair = _disagg_pair(serve_factory, port_lm, prefill, decode,
                            kv_dtype=kv_dtype)
        _run_pair(*pair)
        _RUNS[key] = pair
    return _RUNS[key]


@pytest.fixture(scope="module")
def agg_ctrl(port_lm):
    """The port's aggregated 2-replica fleet per pool type: the stream
    control of every layout (streams are pure functions of weights and
    prompt)."""
    out = {}
    for dt in ("float32", "int8"):
        srv = make_server(port_lm, ServeConfig(**FLEET, replicas=2,
                                               kv_dtype=dt), CPU)
        run_closed_loop(srv, _workloads()[1], 6)
        out[dt] = _streams(srv)
        assert set(out[dt]) == set(range(12))
    return out


# ---------------------------------------------------------------------------
# The disaggregated server against the reference's and the aggregated
# fleet.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", [(1, 1), (1, 2), (2, 1)],
                         ids=lambda pd: f"{pd[0]}:{pd[1]}")
def test_disagg_records_equal_jax(serve_factory, port_lm, agg_ctrl, layout,
                                  kv_dtype):
    jsrv, tsrv = disagg_run(serve_factory, port_lm, *layout, kv_dtype)
    same_disagg(jsrv, tsrv)
    assert _streams(tsrv) == agg_ctrl[kv_dtype]
    # exactly-once records, all on the decode fleet (a request always
    # takes its first decode pass after its ship)
    rids = [f["rid"] for f in tsrv.finished]
    assert sorted(rids) == list(range(12))
    assert tsrv.prefill.finished == []
    assert tsrv.shipped["shipped_requests"] == 12
    for eng in tsrv.engines:
        assert drains_clean(eng)


def test_disagg_streams_bitwise_vs_aggregated(serve_factory, port_lm,
                                              agg_ctrl):
    """The reference's tentpole pin on the port: 1:1 emits the aggregated
    streams, ships every request once, and leaves no page behind on the
    prefill side."""
    _, dis = disagg_run(serve_factory, port_lm, 1, 1, "float32")
    assert _streams(dis) == agg_ctrl["float32"]
    s = dis.stats_summary()
    assert s["shipped_requests"] == 12
    assert s["shipped_pages"] > 0 and s["shipped_payload_bytes"] > 0
    assert s["shipped_sidecar_bytes"] == 0  # float32: no sidecar
    assert s["shipped_checksum_bytes"] == 0  # no ledger, no words
    assert dis.snapshot()["pending_ships"] == 0
    for eng in dis.prefill.engines:
        assert eng.allocator.in_use == 0


def test_disagg_int8_ships_quarter_payload(serve_factory, port_lm):
    """int8 pages cross the wire at exactly a quarter of float32's payload
    bytes for the same pages, with the float32 sidecar (page x 4 B x k/v
    x layers per page) counted apart."""
    f32 = disagg_run(serve_factory, port_lm, 1, 1, "float32")[1].shipped
    i8 = disagg_run(serve_factory, port_lm, 1, 1, "int8")[1].shipped
    assert f32["shipped_requests"] == i8["shipped_requests"] == 12
    assert f32["shipped_pages"] == i8["shipped_pages"]
    assert i8["shipped_payload_bytes"] * 4 == f32["shipped_payload_bytes"]
    assert f32["shipped_sidecar_bytes"] == 0
    assert i8["shipped_sidecar_bytes"] == \
        i8["shipped_pages"] * FLEET["page"] * 4 * 2 * N_LAYERS


# ---------------------------------------------------------------------------
# The transfer primitive.
# ---------------------------------------------------------------------------


def _to_decode(eng, now=0.0):
    while not any(x.state == "decode" for x in eng._active()):
        assert eng.has_work(), "request finished before it reached decode"
        now += eng.step(now).cost
    return now


def _finish(eng, now):
    while eng.has_work():
        now += eng.step(now).cost
    return eng.finished[0]["tokens"]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_export_import_roundtrip_single_request(serve_factory, port_lm,
                                                kv_dtype):
    """Extract a mid-stream request from one engine, import it into
    another, finish it there: the port's ship carries the reference's
    pages and counters, the export frees every page, and the stitched
    stream equals the single-engine control and the reference's."""
    prompt = np.random.default_rng(7).integers(0, VOCAB, size=(6,)) \
        .astype(np.int32)
    kw = dict(FLEET, kv_dtype=kv_dtype)

    def run(make_req, make_engine, export):
        ctrl = make_engine()
        ctrl.submit(make_req(rid=0, prompt=prompt.copy(), max_new=6,
                             arrival=0.0))
        want = _finish(ctrl, 0.0)
        a, b = make_engine(), make_engine()
        a.submit(make_req(rid=0, prompt=prompt.copy(), max_new=6,
                          arrival=0.0))
        now = _to_decode(a)
        ship = export(a, 0)
        assert a.allocator.in_use == 0 and not a.has_work()
        assert b.import_request(ship, now)
        got = _finish(b, now)
        assert got == want
        assert b.allocator.in_use == 0
        return ship, got

    jship, jgot = run(JaxRequest,
                      lambda: serve_factory(JaxServeConfig(**kw)),
                      jax_export)
    tship, tgot = run(ServeRequest,
                      lambda: ServeEngine(port_lm, ServeConfig(**kw), CPU),
                      export_request)
    assert tgot == jgot
    for key in ("rid", "out", "token_times", "first_token_t",
                "pending_tok", "prefill_done", "n_pages", "cached_tokens",
                "payload_bytes", "sidecar_bytes", "checksum_bytes"):
        assert tship[key] == jship[key], key
    assert tship["payload_bytes"] > 0 and tship["n_pages"] > 0
    assert tship["sidecar_bytes"] == (0 if kv_dtype != "int8" else
                                      tship["n_pages"] * FLEET["page"]
                                      * 4 * 2 * N_LAYERS)
    assert sum(r is not None for r in tship["pages"]) == N_LAYERS
    for jrows, trows in zip(jship["pages"], tship["pages"]):
        assert (jrows is None) == (trows is None)
        if trows is None:
            continue
        assert sorted(trows) == sorted(jrows)
        for k in trows:
            assert trows[k].shape == jrows[k].shape, k
            assert trows[k].nbytes == jrows[k].nbytes, k
            if kv_dtype == "bfloat16" and k.startswith("pool"):
                # the port ships bfloat16 as its int16 bytes
                assert trows[k].dtype == np.int16
                got = (trows[k].view(np.uint16).astype(np.uint32)
                       << 16).view(np.float32)
                want = np.asarray(jrows[k], np.float32)
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=1e-5)
            elif kv_dtype == "int8" and k.startswith("pool"):
                diff = np.abs(trows[k].astype(np.int32)
                              - np.asarray(jrows[k]).astype(np.int32))
                assert diff.max() <= 1, k
            else:
                np.testing.assert_allclose(trows[k], np.asarray(jrows[k]),
                                           rtol=1e-5, atol=1e-5)


def test_import_is_all_or_nothing_without_room(port_lm):
    """An import that finds no free row, or too few free pages, leaves the
    engine untouched and returns False (the ship parks)."""
    prompt = np.arange(1, 7, dtype=np.int32)
    a = ServeEngine(port_lm, ServeConfig(**FLEET), CPU)
    a.submit(ServeRequest(rid=0, prompt=prompt, max_new=6, arrival=0.0))
    now = _to_decode(a)
    ship = export_request(a, 0)
    tiny = ServeEngine(port_lm, ServeConfig(**{**FLEET, "max_batch": 1}),
                       CPU)
    tiny.rows[0] = object()  # the one row is taken
    assert not tiny.import_request(ship, now)
    tiny.rows[0] = None
    tiny.allocator.alloc(99, tiny.allocator.free_pages - 1)
    assert not tiny.import_request(ship, now)
    assert tiny.table.sum() == 0 and not tiny.has_work()
    with pytest.raises(ValueError, match="not an in-flight decode"):
        export_request(a, 0)


# ---------------------------------------------------------------------------
# Chaos composes with disaggregation.
# ---------------------------------------------------------------------------


def test_prefill_kill_mid_handoff_bitwise(serve_factory, port_lm, agg_ctrl):
    """Kill a prefill replica while it holds live prefill work: the
    displaced requests re-prefill on the survivor and every stream stays
    bitwise, with the reference's fail ledger."""
    jsrv, tsrv = _disagg_pair(serve_factory, port_lm, 2, 1)
    _run_pair(jsrv, tsrv, events=lambda s: [
        (1.0, lambda srv, clock: srv.fail_prefill(0, now=clock))])
    same_disagg(jsrv, tsrv)
    ev, = tsrv.fail_events
    assert ev["fleet"] == "prefill"
    assert ev["displaced_inflight"] or ev["displaced_queued"], ev
    assert _streams(tsrv) == agg_ctrl["float32"]
    assert len(tsrv.prefill.engines) == 1


def test_decode_kill_reships_quantized_pages_bitwise(serve_factory, port_lm,
                                                     agg_ctrl, monkeypatch):
    """Kill a decode replica after handoff: its pages die with it, the
    displaced requests go back through the PREFILL fleet's dispatcher
    (``fail`` honours ``dispatch=``), re-prefill regenerates their int8
    pages byte for byte, and the handoff ships them again."""
    jsrv, tsrv = _disagg_pair(serve_factory, port_lm, 1, 2,
                              kv_dtype="int8")
    routed = []
    real = ReplicatedServer._dispatch

    def spy(self, req, now=None):
        routed.append((self is tsrv.prefill, req.rid, now))
        return real(self, req, now)

    monkeypatch.setattr(ReplicatedServer, "_dispatch", spy)
    _run_pair(jsrv, tsrv, events=lambda s: [
        (8.0, lambda srv, clock: srv.fail_decode(1, now=clock))])
    same_disagg(jsrv, tsrv)
    ev, = tsrv.fail_events
    assert ev["fleet"] == "decode" and ev["displaced_inflight"], ev
    # every displaced request re-entered through the prefill fleet (the
    # decode fleet never dispatches: its requests arrive by import)
    assert all(pre for pre, _, _ in routed)
    assert set(ev["displaced_inflight"]) <= {
        rid for _, rid, t in routed if t == ev["t"]}
    assert _streams(tsrv) == agg_ctrl["int8"]
    assert tsrv.shipped["shipped_requests"] >= 12 + len(
        ev["displaced_inflight"])
    assert len(tsrv.decode.engines) == 1


def test_fail_honours_dispatch_override(port_lm):
    """``ReplicatedServer.fail(..., dispatch=)`` sends the displaced
    requests where the override says, even off the last replica."""
    srv = make_server(port_lm, ServeConfig(**FLEET, replicas=1), CPU)
    other = make_server(port_lm, ServeConfig(**FLEET, replicas=1), CPU)
    srv.submit(ServeRequest(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                            max_new=4, arrival=0.0))
    srv.step(0.0)
    ev = srv.fail(0, 1.0, dispatch=other._dispatch)
    assert ev["displaced_inflight"] == [0] and ev["resubmitted"] == 1
    assert [r.rid for r in other.engines[0].queue] == [0]
    assert srv.engines == []


# ---------------------------------------------------------------------------
# Per-fleet autoscaling.
# ---------------------------------------------------------------------------


def test_disaggregated_per_fleet_controllers(serve_factory, port_lm):
    """A P:D server gets one controller per fleet (prefill and decode
    scale independently); their decision ledgers and replica-hours equal
    the reference's on the same run."""
    jsrv, tsrv = _disagg_pair(serve_factory, port_lm, 1, 1,
                              slo_ttft=8.0, slo_itl=2.5)
    jctl = jax_make_controllers(jsrv, JaxPolicy(lo=1, hi=2, window=4.0,
                                                cooldown_up=4.0,
                                                cooldown_down=4.0))
    tctl = make_controllers(tsrv, AutoscalePolicy(lo=1, hi=2, window=4.0,
                                                  cooldown_up=4.0,
                                                  cooldown_down=4.0))
    assert [c.name for c in tctl] == ["prefill", "decode"]
    assert tctl[0].server is tsrv.prefill and tctl[1].server is tsrv.decode
    jreqs, treqs = _workloads(n=12)
    jd = jax_closed_loop(jsrv, jreqs, 6, controllers=jctl)
    td = run_closed_loop(tsrv, treqs, 6, controllers=tctl)
    assert td == jd
    for c in jctl + tctl:
        c.advance(td)
    for j, t in zip(jctl, tctl):
        assert t.events == j.events, t.name
        assert t.replica_hours == j.replica_hours
        assert (t.scale_ups, t.scale_downs, t.repairs) == \
            (j.scale_ups, j.scale_downs, j.repairs)
    assert sum(c.scale_events for c in tctl) > 0
    same_disagg(jsrv, tsrv)
    assert len(tsrv.finished) == 12


# ---------------------------------------------------------------------------
# servebench and servechaos --disaggregate rows.
# ---------------------------------------------------------------------------

# tests/test_serve_disagg.py's tool arguments
E2E = ["-m", "transformer_t", "-b", "tinylm", "--arrival", "closed",
       "--concurrency", "4", "--requests", "10", "--max-batch", "2",
       "--pool-pages", "12", "--page", "4", "--max-len", "16",
       "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--seed", "5"]


def jax_tool_row(tool, extra):
    import importlib

    import ddlbench_tpu.config as jconfig

    mod = importlib.import_module(f"ddlbench_tpu.tools.{tool}")
    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    buf = io.StringIO()
    with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
            contextlib.redirect_stdout(buf):
        assert mod.main(E2E + extra + ["--platform", "cpu"]) == 0
    return [json.loads(l) for l in buf.getvalue().splitlines()
            if l.startswith("{")]


def mismatches(t, j):
    keys = (set(t) - _PORT_PROV) | (set(j) - _JAX_PROV)
    return [k for k in sorted(keys)
            if t.get(k, "<missing>") != j.get(k, "<missing>")]


BENCH = {
    "1:1": ["--slo-ttft", "8", "--slo-itl", "2.5", "--policies",
            "continuous", "--disaggregate", "1:1"],
    "1:1_int8": ["--policies", "continuous", "--disaggregate", "1:1",
                 "--kv-dtype", "int8"],
    "2:1_autoscale": ["--policies", "continuous", "--disaggregate", "2:1",
                      "--autoscale", "1:2", "--scale-window", "4",
                      "--scale-cooldown", "4"],
}


@pytest.mark.parametrize("name", sorted(BENCH))
def test_servebench_disaggregate_row_equals_jax(port_lm, name):
    jrow, = jax_tool_row("servebench", BENCH[name])
    args = servebench.build_parser().parse_args(
        E2E + BENCH[name] + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        (trow, server, _), = servebench.run(args, port_lm, CPU)
    assert mismatches(trow, jrow) == []
    assert isinstance(server, DisaggregatedServer)
    p, d = (int(x) for x in trow["disaggregate"].split(":"))
    assert (trow["prefill_replicas"], trow["decode_replicas"]) == (p, d)
    assert trow["shipped_requests"] == trow["completed"] == 10
    assert "scrub" not in trow and "sdc_detected" not in trow
    if name == "2:1_autoscale":
        assert trow["requests_lost"] == 0
        assert {e["fleet"] for e in trow["autoscale_events"]} <= \
            {"prefill", "decode"}


def test_servebench_plain_row_has_no_disagg_fields(port_lm):
    """The shipping fields are flag-gated: a plain row of the same traffic
    has none of them."""
    args = servebench.build_parser().parse_args(
        E2E + ["--policies", "continuous", "--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        (row, _, _), = servebench.run(args, port_lm, CPU)
    for k in ("shipped_requests", "shipped_pages", "shipped_payload_bytes",
              "shipped_sidecar_bytes", "shipped_checksum_bytes",
              "disaggregate", "prefill_replicas", "decode_replicas",
              "sdc_wire_detected", "sdc_detected", "scrub"):
        assert k not in row, k


CHAOS = {
    "prefill_kill": ["--disaggregate", "2:2", "--kill", "2:p0"],
    "both_kills": ["--disaggregate", "2:2", "--kill", "2:p0", "--kill",
                   "8:d0", "--kv-dtype", "int8"],
    "decode_kill_autoscale": ["--disaggregate", "1:2", "--kill", "6:d1",
                              "--autoscale", "1:2"],
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_servechaos_disaggregate_row_equals_jax(port_lm, name):
    jrow, = jax_tool_row("servechaos", CHAOS[name])
    args = servechaos.build_parser().parse_args(
        E2E + CHAOS[name] + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        trow, servers, _ = servechaos.run(args, port_lm, CPU)
    assert mismatches(trow, jrow) == []
    assert trow["requests_lost"] == 0 and trow["streams_match"] is True
    assert trow["streams_compared"] == trow["completed"] == 10
    assert trow["shipped_requests"] >= 10
    fleets = [ev["fleet"] for ev in trow["fail_events"]]
    assert fleets == {"prefill_kill": ["prefill"],
                      "both_kills": ["prefill", "decode"],
                      "decode_kill_autoscale": ["decode"]}[name]
    if name == "decode_kill_autoscale":
        assert trow["repairs"] == 1
        assert set(servers) == {"control", "baseline", "chaos"}
