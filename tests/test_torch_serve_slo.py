"""The port's SLO surface for one replica held against the JAX reference on
the CPU: deadlines with shedding and timeouts, SLO tiers, the driver's
retry-with-backoff, traffic shapes, the per-tier summary and servebench's
rows under each new flag.

* ``make_workload`` with ``shape``, ``deadline_slack`` and ``batch_frac``
  gives byte-identical requests (tiers and shaped arrivals come from
  streams of their own, so neither moves the prompts).
* With the reference's weights carried over, the engines shed the same
  requests (named ``shed`` records, ``submit`` False), cancel the same
  ones into the ``timeout`` terminal state with every page freed, admit
  interactive ahead of batch and evict batch first, and the closed-loop
  driver's retry accounting matches (the counterparts of
  tests/test_serve_chaos.py's deadline and tier pins, one replica).
* servebench's rows under ``--sample``, ``--deadline-slack`` +
  ``--retry``, ``--tier-mix`` and ``--shape`` equal the reference's on
  every field but the provenance, and the sampled servebench streams are
  the reference's.
* Planted faults, each caught: batch admitted first (the row check) and
  a timeout that keeps its pages (the free-list check).
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
from ddlbench_tpu.telemetry.stats import serve_summary as jax_summary

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, ServeConfig
from ddlbench_tpu_torch.serve.engine import (ServeEngine, _vns,
                                             make_server)
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.stats import serve_summary
from ddlbench_tpu_torch.tools import servebench

from test_torch_serve import _JAX_PROV, _PORT_PROV, CPU
from test_torch_serve_prefix import port_lm  # noqa: F401

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
# tests/test_serve_chaos.py's engine shapes (max_batch 2, pool 9)
ECFG = dict(max_batch=2, pool_pages=9, page=4, max_len=16,
            prefill_chunk=4, token_budget=10)
# the serve suites' eviction shapes
EVICT = dict(max_batch=2, pool_pages=9, page=4, max_len=24,
             prefill_chunk=4)


def _both(serve_factory, port_lm, kw):
    return (serve_factory(JaxServeConfig(**kw)),
            ServeEngine(port_lm, ServeConfig(**kw), CPU))


def _drain(eng, now=0.0):
    while eng.has_work():
        now += eng.step(now).cost
    return now


def _pair(rid, prompt, **kw):
    """The same request for each engine."""
    return (JaxRequest(rid=rid, prompt=prompt, **kw),
            ServeRequest(rid=rid, prompt=prompt, **kw))


def _same_records(jeng, teng):
    for key in ("finished", "timed_out", "shed", "evicted_log"):
        assert getattr(teng, key) == getattr(jeng, key), key
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for k in ts:
        assert ts[k] == js[k], k


# ---------------------------------------------------------------------------
# Workload and summary (pure host code).
# ---------------------------------------------------------------------------


WORKLOADS = [
    dict(arrival="poisson", shape="diurnal"),
    dict(arrival="poisson", shape="ramp", deadline_slack=12.0),
    dict(arrival="poisson", shape="spike", batch_frac=0.4),
    dict(arrival="bursty", deadline_slack=8.0, batch_frac=0.5),
    dict(arrival="closed", batch_frac=1.0, deadline_slack=4.0),
    dict(arrival="poisson", prefix_groups=2, prefix_len=6,
         deadline_slack=20.0, batch_frac=0.3),
]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_workload_identical_to_jax(kw):
    base = dict(seed=7, n_requests=24, vocab=VOCAB, rate=0.5, max_len=24)
    want = jax_workload(**base, **kw)
    got = make_workload(**base, **kw)
    for g, w in zip(got, want):
        assert (g.rid, g.max_new, g.arrival, g.deadline, g.tier) == (
            w.rid, w.max_new, w.arrival, w.deadline, w.tier)
        assert g.prompt.tobytes() == w.prompt.tobytes()
    # deadlines and tiers leave the prompts and lengths unchanged; a shape
    # draws its arrivals from the shape stream, so its prompts are those
    # of the closed loop (no arrival draws on the main stream)
    plain = make_workload(**base,
                          arrival="closed" if "shape" in kw
                          else kw["arrival"],
                          prefix_groups=kw.get("prefix_groups", 0),
                          prefix_len=kw.get("prefix_len", 0))
    for g, p in zip(got, plain):
        assert g.prompt.tobytes() == p.prompt.tobytes()
        assert g.max_new == p.max_new


@pytest.mark.parametrize("kw", [
    dict(shape="square"), dict(shape="ramp", arrival="bursty"),
    dict(deadline_slack=0.0), dict(batch_frac=1.5)])
def test_workload_errors_are_the_references(kw):
    base = dict(seed=1, n_requests=4, vocab=VOCAB)
    with pytest.raises(ValueError) as want:
        jax_workload(**base, **kw)
    with pytest.raises(ValueError) as got:
        make_workload(**base, **kw)
    assert str(got.value) == str(want.value)


def test_serve_summary_per_tier_equals_jax():
    rng = np.random.default_rng(3)
    recs = []
    for rid in range(9):
        t0 = float(rng.integers(0, 10))
        times = list(np.cumsum(rng.integers(1, 4, size=rid % 4 + 1))
                     .astype(float) + t0)
        recs.append({"rid": rid, "arrival": t0 if rid % 3 else None,
                     "first_token_t": times[0], "token_times": times,
                     "n_tokens": len(times), "cached_tokens": rid % 2,
                     **({"tier": ("interactive", "batch")[rid % 2]}
                        if rid != 4 else {})})
    for records, duration in ((recs, 40.0), (recs[:1], 0.0), ([], 0.0)):
        for per_tier in (False, True):
            kw = dict(duration=duration, slo_ttft=4.0, slo_itl=2.0,
                      per_tier=per_tier)
            assert serve_summary(records, **kw) == jax_summary(records, **kw)
    plain = serve_summary(recs, duration=40.0)
    tiered = serve_summary(recs, duration=40.0, per_tier=True)
    assert set(tiered) - set(plain) == {
        f"{t}_{k}" for t in ("interactive", "batch")
        for k in ("completed", "output_tokens", "ttft_p50", "ttft_p95",
                  "itl_p50", "slo_attainment", "goodput_tokens_per_unit")}
    # both tiers present, zeros for an absent one
    empty = serve_summary([], duration=0.0, per_tier=True)
    assert empty["batch_completed"] == 0
    assert empty["batch_goodput_tokens_per_unit"] == 0.0


# ---------------------------------------------------------------------------
# Engine: shedding, timeouts, tiers (counterparts of test_serve_chaos.py).
# ---------------------------------------------------------------------------


def test_deadline_shed_named_rejection(serve_factory, port_lm):
    """A request whose projected completion already misses its deadline
    is shed at submit (False + a named record); the same projections and
    verdicts as the reference's."""
    jeng, teng = _both(serve_factory, port_lm, ECFG)
    rng = np.random.default_rng(21)
    for rid in range(2):  # load the engine so the projection is nonzero
        jr, tr = _pair(rid, rng.integers(0, VOCAB, size=(5,)).astype(
            np.int32), max_new=8, arrival=0.0)
        assert jeng.submit(jr) is teng.submit(tr) is True
    p = rng.integers(0, VOCAB, size=(5,)).astype(np.int32)
    for rid, deadline, tier in ((9, 3.0, "interactive"), (10, 9.0, "batch"),
                                (11, 30.0, "batch")):
        jr, tr = _pair(rid, p, max_new=8, arrival=0.0, deadline=deadline,
                       tier=tier)
        assert teng.projected_finish(tr, 0.0) == jeng.projected_finish(
            jr, 0.0)
        assert teng.submit(tr, now=0.0) is jeng.submit(jr, now=0.0)
    assert teng.shed[0] == {"rid": 9, "t": 0.0, "deadline": 3.0,
                            "tier": "interactive"}
    assert all(r.rid != 9 for r in teng.queue)
    _drain(jeng)
    _drain(teng)
    _same_records(jeng, teng)
    assert teng.stats["shed"] >= 1
    assert teng.allocator.in_use == 0


def _timeout_run(eng, make_req, rng_seed=22):
    """tests/test_serve_chaos.py's timeout fixture: a queued request that
    expires waiting for a row, then one that expires mid-decode."""
    rng = np.random.default_rng(rng_seed)
    for rid in range(2):  # occupy both rows with long decodes
        assert eng.submit(make_req(
            rid=rid, prompt=rng.integers(0, VOCAB, size=(5,)).astype(
                np.int32), max_new=8, arrival=0.0))
    probe = make_req(rid=2, prompt=np.zeros(4, np.int32), max_new=4)
    queued = make_req(
        rid=2, prompt=rng.integers(0, VOCAB, size=(4,)).astype(np.int32),
        max_new=4, arrival=0.0,
        deadline=float(eng.projected_finish(probe, 0.0)))
    assert eng.submit(queued, now=0.0) is True
    t = _drain(eng)
    for rid in (3, 4):
        assert eng.submit(make_req(
            rid=rid, prompt=rng.integers(0, VOCAB, size=(5,)).astype(
                np.int32), max_new=8, arrival=t), now=t)
    assert eng.submit(make_req(
        rid=5, prompt=rng.integers(0, VOCAB, size=(5,)).astype(np.int32),
        max_new=8, arrival=t, deadline=t + 16.0), now=t) is True
    _drain(eng, t)
    return eng


def drains_clean(eng) -> bool:
    """The free-list check: after a drain every usable page is back on
    the free list and nothing is owned."""
    return (eng.allocator.free_pages == eng.allocator.capacity
            and eng.allocator.in_use == 0 and not eng.has_work())


def test_deadline_timeout_terminal_state_frees_pages(serve_factory,
                                                     port_lm):
    jeng, teng = _both(serve_factory, port_lm, ECFG)
    _timeout_run(jeng, JaxRequest)
    _timeout_run(teng, ServeRequest)
    _same_records(jeng, teng)
    states = {r["rid"]: r["state"] for r in teng.timed_out}
    assert states[2] == "queued" and states[5] in ("prefill", "decode")
    assert [r for r in teng.timed_out if r["rid"] == 5][0]["out_tokens"] > 0
    assert {f["rid"] for f in teng.finished} == {0, 1, 3, 4}
    assert drains_clean(teng)


def _keep_pages_on_timeout(self, now, rep):
    """Planted fault: _cancel_expired without the page free of an
    in-flight victim (its rows and table entries go, its pages stay)."""
    expired = [r for r in self.queue
               if r.deadline is not None and now >= r.deadline]
    dead = {id(r) for r in expired}
    kept = [r for r in self.queue if id(r) not in dead]
    self.queue.clear()
    self.queue.extend(kept)
    for r in expired:
        self._record_timeout(r.rid, now, r.deadline, "queued", 0, r.tier,
                             rep)
    for a in [a for a in self._active()
              if a.req.deadline is not None and now >= a.req.deadline]:
        self.table[a.row, :] = 0
        self.rows[a.row] = None
        self._record_timeout(a.req.rid, now, a.req.deadline, a.state,
                             len(a.out), a.req.tier, rep)


def test_timeout_that_keeps_its_pages_is_rejected(port_lm, monkeypatch):
    monkeypatch.setattr(ServeEngine, "_cancel_expired",
                        _keep_pages_on_timeout)
    eng = _timeout_run(ServeEngine(port_lm, ServeConfig(**ECFG), CPU),
                       ServeRequest)
    assert eng.stats["timeouts"] == 2
    assert not drains_clean(eng)


def test_driver_retry_backoff_accounting(serve_factory, port_lm):
    """The closed-loop driver's bounded retry-with-backoff: the same
    sheds, retries, rejections, timeouts and completions as the
    reference's driver, and every request reaches exactly one terminal
    state."""
    from ddlbench_tpu.tools.servebench import \
        run_closed_loop as jax_closed_loop

    wl = dict(seed=9, n_requests=14, vocab=VOCAB, arrival="closed",
              prompt_lo=4, prompt_typical=6, prompt_hi=8, out_lo=6,
              out_typical=8, out_hi=8, max_len=16)
    jsrv = serve_factory(JaxServeConfig(**ECFG), server=True)
    jst, tst = {}, {}
    jclock = jax_closed_loop(jsrv, jax_workload(**wl), 10, retry=(2, 2.0),
                             deadline_slack=10.0, driver_stats=jst)
    tsrv = make_server(port_lm, ServeConfig(**ECFG), CPU)
    tclock = servebench.run_closed_loop(
        tsrv, make_workload(**wl), 10, retry=(2, 2.0), deadline_slack=10.0,
        driver_stats=tst)
    assert (tclock, tst) == (jclock, jst)
    _same_records(jsrv.engines[0], tsrv.engines[0])
    assert tsrv.timed_out == jsrv.timed_out
    assert tsrv.shed_records == jsrv.shed_records
    eng = tsrv.engines[0]
    assert eng.stats["shed"] > 0 and tst["retries"] > 0
    assert len(tsrv.finished) + int(eng.stats["timeouts"]) \
        + tst["rejected"] == 14
    assert drains_clean(eng)


def test_tier_admission_interactive_first(serve_factory, port_lm):
    jeng, teng = _both(serve_factory, port_lm, ECFG)
    rng = np.random.default_rng(23)
    for rid, tier in enumerate(("batch", "interactive", "interactive",
                                "batch")):
        jr, tr = _pair(rid, rng.integers(0, VOCAB, size=(4,)).astype(
            np.int32), max_new=3, arrival=0.0, tier=tier)
        jeng.submit(jr)
        teng.submit(tr)
    jeng.step(0.0)
    teng.step(0.0)  # two rows: both interactive requests beat batch
    assert {a.req.rid for a in teng.rows if a is not None} == {1, 2}
    _drain(jeng, 1.0)
    _drain(teng, 1.0)
    _same_records(jeng, teng)
    assert {f["rid"]: f["tier"] for f in teng.finished} == {
        0: "batch", 1: "interactive", 2: "interactive", 3: "batch"}


def test_tier_eviction_batch_first(serve_factory, port_lm):
    """Under pool pressure the BATCH active is evicted although it is
    OLDER than the interactive one; the same ledger and streams as the
    reference's, and every interactive victim fell only with no batch
    request co-resident."""
    jeng, teng = _both(serve_factory, port_lm, EVICT)
    rng = np.random.default_rng(25)
    reqs = [_pair(rid, rng.integers(0, VOCAB, size=(6,)).astype(np.int32),
                  max_new=12, arrival=0.0 if rid < 3 else 6.0,
                  tier="batch" if rid < 3 else "interactive")
            for rid in range(6)]
    for eng, k in ((jeng, 0), (teng, 1)):
        pend, i, t = [r[k] for r in reqs], 0, 0.0
        while i < len(pend) or eng.has_work():
            while i < len(pend) and pend[i].arrival <= t:
                eng.submit(pend[i])
                i += 1
            t += eng.step(t).cost
    _same_records(jeng, teng)
    assert teng.stats["evicted"] > 0
    assert any(e["tier"] == "batch" for e in teng.evicted_log)
    for e in teng.evicted_log:
        if e["tier"] == "interactive":
            assert e["batch_active"] == 0, e


# ---------------------------------------------------------------------------
# servebench: the rows under each new flag equal the reference's.
# ---------------------------------------------------------------------------

ROW_ARGS = [
    "-m", "transformer_t", "-b", "tinylm", "--max-batch", "2",
    "--pool-pages", "9", "--page", "4", "--max-len", "16",
    "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--requests", "12",
    "--slo-ttft", "8", "--slo-itl", "2.5", "--seed", "5",
]
FLAGS = {
    "sample": ["--arrival", "closed", "--concurrency", "4",
               "--sample", "temperature:0.8,top-k:40"],
    # slack 6 sheds, retries, rejects and times out on this traffic
    "deadline": ["--arrival", "closed", "--concurrency", "8",
                 "--deadline-slack", "6", "--retry", "2:2"],
    "tier_mix": ["--arrival", "closed", "--concurrency", "8",
                 "--tier-mix", "0.5"],
    "shape": ["--arrival", "poisson", "--shape", "diurnal", "--rate", "1.0",
              "--deadline-slack", "16", "--tier-mix", "0.3"],
}
TINY = DatasetSpec("tinylm", TINY_LM.image_size, VOCAB, 1000, 100,
                   kind="tokens")
_JAX_ROWS = {}


def jax_rows(capsys, flags):
    """The reference's rows for ``flags`` (both policies), once per
    module."""
    key = tuple(flags)
    if key not in _JAX_ROWS:
        import ddlbench_tpu.config as jconfig
        from ddlbench_tpu.tools import servebench as jax_servebench

        patched = dict(jconfig.DATASETS)
        patched["tinylm"] = TINY_LM
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched):
            assert jax_servebench.main(ROW_ARGS + flags
                                       + ["--platform", "cpu"]) == 0
        _JAX_ROWS[key] = [json.loads(l) for l in
                          capsys.readouterr().out.splitlines()
                          if l.startswith("{")]
    return _JAX_ROWS[key]


def port_run(port_lm, flags):
    args = servebench.build_parser().parse_args(
        ROW_ARGS + flags + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        return servebench.run(args, port_lm, CPU)


def row_mismatches(trows, jrows):
    """Keys whose values differ between the port's and the reference's
    rows (provenance aside), policy by policy."""
    bad = []
    assert [t["policy"] for t in trows] == [j["policy"] for j in jrows]
    for t, j in zip(trows, jrows):
        keys = (set(t) - _PORT_PROV) | (set(j) - _JAX_PROV)
        bad += [(t["policy"], k) for k in sorted(keys)
                if t.get(k, "<missing>") != j.get(k, "<missing>")]
    return bad


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_servebench_rows_equal_jax_rows(capsys, port_lm, name):
    jrows = jax_rows(capsys, FLAGS[name])
    out = port_run(port_lm, FLAGS[name])
    trows = [rec for rec, _, _ in out]
    assert row_mismatches(trows, jrows) == []
    row = trows[0]
    if name == "deadline":
        assert row["shed"] > 0 and row["retries"] > 0
        assert row["rejected"] > 0 and row["timeouts"] > 0
        assert row["requests_lost"] == 0
        assert row["completed"] + row["timeouts"] + row["rejected"] \
            == row["requests"]
    if name in ("tier_mix", "shape"):
        assert row["interactive_completed"] + row["batch_completed"] \
            == row["completed"]
    if name == "shape":
        assert row["shape"] == "diurnal"
    for _, server, _ in out:
        assert drains_clean(server.engines[0])


def test_servebench_sampled_streams_are_the_references(serve_factory,
                                                       port_lm):
    """The sampled streams behind the --sample rows: the reference's
    closed-loop driver over the same workload and config."""
    from ddlbench_tpu.tools.servebench import \
        run_closed_loop as jax_closed_loop

    for rec, server, reqs in port_run(port_lm, FLAGS["sample"]):
        cfg = JaxServeConfig(max_batch=2, pool_pages=9, page=4, max_len=16,
                             prefill_chunk=4, policy=rec["policy"],
                             temperature=0.8, top_k=40, sample_seed=5)
        jsrv = serve_factory(cfg, server=True)
        jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                 for r in reqs]
        jax_closed_loop(jsrv, jreqs, 4)
        want = {f["rid"]: f["tokens"] for f in jsrv.finished}
        got = {f["rid"]: f["tokens"] for f in server.finished}
        assert got == want and len(got) == 12


def test_batch_admitted_first_is_rejected(capsys, port_lm, monkeypatch):
    """Planted fault: admission takes the first BATCH request ahead of
    interactive ones. The tier-mix row must no longer equal the
    reference's."""
    jrows = jax_rows(capsys, FLAGS["tier_mix"])

    def batch_first(self):
        for i, r in enumerate(self.queue):
            if r.tier == "batch":
                return i
        return 0

    monkeypatch.setattr(ServeEngine, "_next_admission_index", batch_first)
    trows = [rec for rec, _, _ in port_run(port_lm, FLAGS["tier_mix"])]
    assert row_mismatches(trows, jrows)


def test_servebench_argument_errors_are_the_references(capsys):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    for extra in (["--timeline"], ["--window", "0", "--trace", "x"],
                  ["--shape", "ramp", "--arrival", "closed"],
                  ["--deadline-slack", "0"], ["--retry", "2:4"],
                  ["--deadline-slack", "4", "--retry", "0:4"],
                  ["--deadline-slack", "4", "--retry", "x"],
                  ["--tier-mix", "1.5"], ["--sample", "top-k:4"],
                  ["--sample", "temperature:0.5,beam:2"],
                  ["--shared-prefix", "4"]):
        errs = []
        for main, tail in ((jax_servebench.main, ["--platform", "cpu"]),
                           (servebench.main, ["--device", "cpu"])):
            with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                    mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}), \
                    pytest.raises(SystemExit):
                main(ROW_ARGS + extra + tail)
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0] == errs[1], extra


def test_vns_is_the_references():
    from ddlbench_tpu.serve.engine import _vns as jax_vns

    for t in (0.0, 1.0, 2.5, 1e-3, 123.4567, 1e6 + 0.25):
        assert _vns(t) == jax_vns(t)
