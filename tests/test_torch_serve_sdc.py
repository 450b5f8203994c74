"""The port's SDC defence (ddlbench_tpu_torch/serve/integrity.py, the
quarantine of serve/allocator.py and serve/prefix.py, the ledger hooks of
serve/engine.py, telemetry/export.sdc_events, servebench ``--scrub`` and
servechaos ``--corrupt``/``--no-detect``/``--scrub``) held against the JAX
reference on the CPU: the counterparts of tests/test_serve_sdc.py (the
HLO pool-audit half of its trace test aside: that audit is ROADMAP A.8).

Exact on both sides, with the reference's weights carried over:

* the checksum words: ``page_checksum``/``ship_checksums`` over the same
  bytes give the reference's words for float32, bfloat16 (the port reads
  bf16 through an int16 view; the reference through ``ml_dtypes``) and
  int8 with its sidecars, and a pool's per-slot word covers its
  payload and sidecars but not the layer's ``kv_seed`` or rounding table;
* the ledger (generations, ``drop_slot``, the scrub domain), the
  allocator's quarantine and the prefix index's ``drop_slot``;
* engine runs: finished records, SDC event ledgers, stats summaries and
  the ledgers' stamp/verify counts, on clean traffic with the ledger
  armed and under payload, sidecar, shared-prefix, decode-fleet and wire
  flips, detection on and off;
* the ``sdc:*`` trace instants, servebench ``--scrub`` rows and
  servechaos ``--corrupt`` rows (every field but the provenance).

Besides: detected flips recover every stream bitwise with no request
lost, the quarantined slot never returns to use, ``--no-detect`` escapes,
an unrepairable corrupt ship re-routes through the prefill fleet, and
three planted faults are caught: an export that skips its verify (the
corrupt bytes reach the wire), a ``write_pages`` that drops the scale
sidecars (the streams fork) and a ``page_checksum`` that leaves out the
sidecar keys (a sidecar flip escapes).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import contextlib
import io
import json
import unittest.mock as mock

import ml_dtypes
import numpy as np
import pytest
import torch

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.ops import paged_decode as jax_pd
from ddlbench_tpu.serve import integrity as JI
from ddlbench_tpu.serve.allocator import PageAllocator as JaxAllocator
from ddlbench_tpu.serve.handoff import \
    DisaggregatedServer as JaxDisaggregated
from ddlbench_tpu.serve.prefix import PrefixIndex as JaxPrefix
from ddlbench_tpu.serve.workload import make_workload as jax_workload
from ddlbench_tpu.telemetry import export as jax_export
from ddlbench_tpu.telemetry import tracer as jax_tracer_mod
from ddlbench_tpu.tools.servebench import \
    run_closed_loop as jax_closed_loop

import ddlbench_tpu_torch.config as tconfig
import ddlbench_tpu_torch.serve.engine as tengine
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.ops.paged_decode import (pool_checksum_keys,
                                                 serve_pool_init)
from ddlbench_tpu_torch.serve import integrity as TI
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.engine import ServeEngine, make_server
from ddlbench_tpu_torch.serve.handoff import make_disaggregated
from ddlbench_tpu_torch.serve.prefix import PrefixIndex
from ddlbench_tpu_torch.serve.workload import make_workload
from ddlbench_tpu_torch.telemetry import export as texport
from ddlbench_tpu_torch.telemetry import tracer as tracer_mod
from ddlbench_tpu_torch.tools import servebench, servechaos
from ddlbench_tpu_torch.tools.servebench import run_closed_loop

from test_torch_serve import _JAX_PROV, _PORT_PROV, CPU
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import TINY

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
POOL = 20  # pool pages; also the whole-pool scrub budget
# tests/test_serve_sdc.py's shapes
BASE = dict(max_batch=4, pool_pages=POOL, page=4, max_len=16,
            prefill_chunk=4)


def _cfgs(**kw):
    cfg = {**BASE, **kw}
    return JaxServeConfig(**cfg), ServeConfig(**cfg)


def _armed(**kw):
    return _cfgs(**{"integrity": True, "scrub": POOL, **kw})


def _workloads(shared=False, n=12):
    wl = dict(seed=3, n_requests=n, vocab=VOCAB, arrival="closed",
              out_lo=2, out_typical=4, out_hi=6)
    if shared:
        wl.update(prompt_lo=1, prompt_typical=4, prompt_hi=8,
                  prefix_groups=2, prefix_len=8, max_len=24)
    else:
        wl.update(prompt_lo=2, prompt_typical=5, prompt_hi=9, max_len=16)
    return jax_workload(**wl), make_workload(**wl)


def _streams(srv):
    return {f["rid"]: f["tokens"] for f in srv.finished}


def _flip_event(integ, t, key=None, engine=lambda srv: srv.engines[0],
                prefer_shared=False):
    """tests/test_serve_sdc.py's injection, for either package (``integ``
    is its integrity module): at ``t`` (or the next firing with a settled
    page) flip one exponent bit of a settled stamped page. Returns
    (events, record)."""
    rec = {}

    def fire(srv, clock):
        if rec:
            return
        eng = engine(srv)
        if eng.integrity is None:
            slots = sorted({
                int(eng.table[a.row, idx])
                for a in eng._active() if a.state == "decode"
                for idx in range(a.decode_pos // eng.page)} - {0})
        else:
            slots = integ.stable_stamped_slots(eng)
        if prefer_shared:
            # a cached page that several requests hold, if there is one
            # (the index's own reference counts too, so a page with two
            # holders has refcount 3)
            cached = set(eng.prefix._slots.values())
            shared = [s for s in slots if s in cached
                      and eng.allocator.refcount(s) >= 3]
            slots = shared
        if not slots:
            return
        li = integ.pool_layers(eng)[0]
        rec.update(integ.flip_pool_bit(eng, li, slots[0], key=key,
                                       index=3, bit=6))
        rec["t"] = clock
        rec["holders"] = eng.allocator.holders(slots[0])
        eng.stats["sdc_injected"] += 1

    return [(float(ti), fire) for ti in (t, t + 1, t + 2, t + 3)], rec


def _servers(serve_factory, port_lm, jcfg, tcfg):
    return (serve_factory(jcfg, server=True),
            make_server(port_lm, tcfg, CPU))


def _run_both(jsrv, tsrv, make_events=None, shared=False, conc=6):
    """Both servers through their driver on the same traffic; returns the
    two injection records (empty without ``make_events``)."""
    jreqs, treqs = _workloads(shared)
    jev, jrec = make_events(JI) if make_events else (None, {})
    tev, trec = make_events(TI) if make_events else (None, {})
    jc = jax_closed_loop(jsrv, jreqs, conc, events=jev)
    tc = run_closed_loop(tsrv, treqs, conc, events=tev)
    assert tc == jc
    assert trec == jrec
    return trec


def same_sdc(jsrv, tsrv):
    """Records, SDC ledgers, stats, and each engine's ledger counts."""
    for key in ("finished", "timed_out", "shed_records", "fail_events",
                "sdc_events"):
        assert getattr(tsrv, key) == getattr(jsrv, key), key
    js, ts = jsrv.stats_summary(), tsrv.stats_summary()
    assert set(ts) == set(js)
    for k in ts:
        assert ts[k] == js[k], k
    for je, te in zip(jsrv.engines, tsrv.engines):
        assert (je.integrity is None) == (te.integrity is None)
        if te.integrity is not None:
            for attr in ("stamps", "verifies", "mismatches"):
                assert getattr(te.integrity, attr) == \
                    getattr(je.integrity, attr), attr
            assert te.integrity.stamped_slots() == \
                je.integrity.stamped_slots()
        assert te.allocator.quarantined == je.allocator.quarantined


@pytest.fixture(scope="module")
def ctrl(port_lm):
    """The port's unfaulted run per pool type, without the ledger: the
    stream control of every armed and faulted variant."""
    out = {}
    for dt in ("float32", "int8"):
        srv = make_server(port_lm, ServeConfig(**BASE, kv_dtype=dt), CPU)
        run_closed_loop(srv, _workloads()[1], 6)
        out[dt] = _streams(srv)
        assert set(out[dt]) == set(range(12))
    return out


# ---------------------------------------------------------------------------
# The checksum words and the ledger.
# ---------------------------------------------------------------------------


def test_checksum_covers_payload_and_sidecar():
    """page_checksum chains every key in sorted order: one corrupted byte
    in payload or sidecar moves the word; the port's word is the
    reference's."""
    rows = {"pool_k": np.arange(32, dtype=np.float32),
            "pool_v": np.arange(32, 64, dtype=np.float32),
            "scale_k": np.ones(2, dtype=np.float32)}
    base = TI.page_checksum(rows)
    assert base == JI.page_checksum(rows)
    assert base == TI.page_checksum(dict(reversed(list(rows.items()))))
    for key in rows:
        bad = {k: v.copy() for k, v in rows.items()}
        bad[key].view(np.uint8)[3] ^= 0x40
        assert TI.page_checksum(bad) == JI.page_checksum(bad) != base, key
    a, b = b"settled", b"pages"
    assert TI.checksum(b, TI.checksum(a)) != TI.checksum(a, TI.checksum(b))
    assert TI.checksum(a) == JI.checksum(a)
    assert TI.CHECKSUM_BYTES == JI.CHECKSUM_BYTES == 4
    assert (TI._crc32c is None) == (JI._crc32c is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pool_words_equal_jax_words_on_the_same_bits(dtype):
    """A pool of random bits on each side (bfloat16 as the same 16-bit
    patterns: the port's torch.bfloat16, the reference's ml_dtypes), read
    the way the engines read a slot: every per-slot word, and the words
    of a shipped set of slots, are the reference's."""
    rng = np.random.default_rng(11)
    shape = (6, 4, 2, 8)
    if dtype == "bfloat16":
        bits = rng.integers(0, 2 ** 16, size=(2,) + shape, dtype=np.uint16)
        jpool = {k: bits[i].view(ml_dtypes.bfloat16)
                 for i, k in enumerate(("pool_k", "pool_v"))}
        tpool = serve_pool_init(6, 4, 2, 8, torch.bfloat16, CPU)
        for i, k in enumerate(("pool_k", "pool_v")):
            tpool[k].view(torch.int16).copy_(
                torch.from_numpy(bits[i].view(np.int16)))
    else:
        tdt = {"float32": torch.float32, "int8": torch.int8}[dtype]
        tpool = serve_pool_init(6, 4, 2, 8, tdt, CPU)
        for k in tpool:
            raw = rng.integers(0, 256, size=tpool[k].numel()
                               * tpool[k].element_size(), dtype=np.uint8)
            tpool[k].view(-1).view(torch.uint8).copy_(torch.from_numpy(raw))
        jpool = {k: v.numpy().copy() for k, v in tpool.items()}
    # the engine's extra per-layer state never enters a word
    tpool["kv_seed"], tpool["kv_u"] = 3, torch.rand(2, 9, 2, 8)
    jpool["kv_seed"] = np.int32(3)
    keys = pool_checksum_keys(tpool)
    assert keys == jax_pd.pool_checksum_keys(jpool)
    assert keys == (("pool_k", "pool_v") if dtype != "int8" else
                    ("pool_k", "pool_v", "scale_k", "scale_v"))
    for slot in range(6):
        trows = {k: TI.host_rows(tpool[k][slot]) for k in keys}
        jrows = {k: np.asarray(jpool[k][slot]) for k in keys}
        for k in keys:
            assert trows[k].tobytes() == jrows[k].tobytes()
        assert TI.page_checksum(trows) == JI.page_checksum(jrows)
    slots = [4, 1, 3]
    tship = [None, {k: TI.host_rows(tpool[k][torch.tensor(slots)])
                    for k in keys}]
    jship = [None, {k: np.asarray(jpool[k][np.asarray(slots)])
                    for k in keys}]
    assert TI.ship_checksums(tship) == JI.ship_checksums(jship)


def test_page_ledger_generations_and_drop():
    for led in (TI.PageLedger(), JI.PageLedger()):
        assert led.verify(0, 3, 123) is None
        g1 = led.stamp(0, 3, 111)
        g2 = led.stamp(0, 3, 222)
        assert (g1, g2) == (1, 2) and led.generation(0, 3) == 2
        assert led.expected(0, 3) == 222
        assert led.verify(0, 3, 222) is True
        assert led.verify(0, 3, 111) is False
        assert (led.stamps, led.verifies, led.mismatches) == (2, 2, 1)
        led.stamp(1, 3, 333)
        led.stamp(0, 7, 444)
        assert led.stamped_slots() == [3, 7] and len(led) == 3
        assert led.drop_slot(3) == 2
        assert led.stamped_slots() == [7]
        assert led.verify(0, 3, 222) is None


def test_allocator_quarantine_equals_jax():
    """A quarantined free slot leaves the free list at once, a live one
    when its last reference drops (counted as freed, never handed out
    again); ``on_slot_free`` fires for real returns only; the
    ``pool_quarantine`` event rides ``on_event``."""
    logs = []
    for cls in (PageAllocator, JaxAllocator):
        al = cls(6)
        events, freed = [], []
        al.on_event = lambda name, **kw: events.append((name, kw))
        al.on_slot_free = freed.append
        a = al.alloc(0, 2)
        b = al.alloc(1, 1)
        al.quarantine(5)  # on the free list
        al.quarantine(a[1])  # live
        al.quarantine(a[1])  # idempotent
        al.bind(1, [a[0]])
        al.free_request(0)
        al.free_request(1)
        with pytest.raises(ValueError, match="scratch"):
            al.quarantine(0)
        got = al.alloc(2, al.free_pages)
        logs.append((a, b, al.quarantined, al.in_use, al.free_pages,
                     al.frees, got, freed, events))
    assert logs[0] == logs[1]
    a, b, q, in_use, free, frees, got, freed, events = logs[0]
    assert q == 2 and a[1] not in got and 5 not in got
    assert a[1] not in freed and ("pool_quarantine", {"slot": 5,
                                                      "free": 1}) in events


def test_prefix_drop_slot_equals_jax():
    out = []
    for alloc_cls, prefix_cls in ((PageAllocator, PrefixIndex),
                                  (JaxAllocator, JaxPrefix)):
        al = alloc_cls(8)
        ix = prefix_cls(al, 4)
        events = []
        ix.on_event = lambda name, **kw: events.append((name, kw))
        prompt = np.arange(12, dtype=np.int32)
        slots = al.alloc(0, 3)
        for b, s in enumerate(slots):
            ix.register(prompt, b, s)
        al.free_request(0)
        n1 = ix.drop_slot(slots[1])
        n0 = ix.drop_slot(99)
        out.append((n1, n0, ix.match(prompt), al.refcount(slots[1]),
                    len(ix), events))
    assert out[0] == out[1]
    assert out[0][0] == 1 and out[0][2] == [out[0][2][0]]


def test_flip_pool_bit_flips_one_device_bit(port_lm):
    """The flip changes exactly one bit of the pool tensor in place (no
    host copy written back), in the payload or the sidecar."""
    _, tcfg = _cfgs(kv_dtype="int8", integrity=True)
    eng = ServeEngine(port_lm, tcfg, CPU)
    li = TI.pool_layers(eng)[0]
    for key in (None, "scale_k"):
        name = key or "pool_k"
        ref = eng.pools[li][name]
        before = ref.clone().view(-1).view(torch.uint8).numpy()
        rec = TI.flip_pool_bit(eng, li, 3, key=key, index=3, bit=6)
        assert eng.pools[li][name] is ref  # the same tensor, changed
        after = ref.view(-1).view(torch.uint8).numpy()
        diff = np.unpackbits(before ^ after)
        assert diff.sum() == 1
        assert rec == {"layer": li, "slot": 3, "key": name, "byte": 3,
                       "bit": 6}


def test_stable_slots_empty_when_disarmed(serve_factory, port_lm):
    jcfg, tcfg = _cfgs()
    teng = ServeEngine(port_lm, tcfg, CPU)
    jeng = serve_factory(jcfg)
    assert teng.integrity is None
    assert TI.stable_stamped_slots(teng) == []
    with pytest.raises(ValueError) as got:
        TI.flip_pool_bit(teng, 0, 1)
    with pytest.raises(ValueError) as want:
        JI.flip_pool_bit(jeng, 0, 1)
    assert str(got.value) == str(want.value)
    assert TI.pool_layers(teng) == JI.pool_layers(jeng)
    assert 0 not in TI.pool_layers(teng)


@pytest.mark.parametrize("knob", [
    dict(integrity=True, scrub=POOL), dict(integrity=True, scrub=0),
    dict(integrity=True, scrub=-1), dict(integrity=False, scrub=4)],
    ids=["armed", "boundary_only", "negative_scrub", "scrub_no_ledger"])
def test_integrity_config_validation(knob):
    jcfg, tcfg = _cfgs(**knob)
    try:
        jcfg.validate()
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            tcfg.validate()
        assert str(got.value) == str(want)
        return
    tcfg.validate()


# ---------------------------------------------------------------------------
# Engine runs against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_clean_traffic_bitwise_with_ledger_armed(serve_factory, port_lm,
                                                 ctrl, kv_dtype):
    jsrv, tsrv = _servers(serve_factory, port_lm,
                          *_armed(kv_dtype=kv_dtype))
    _run_both(jsrv, tsrv)
    same_sdc(jsrv, tsrv)
    assert _streams(tsrv) == ctrl[kv_dtype]
    eng = tsrv.engines[0]
    assert eng.integrity.stamps > 0 and eng.integrity.verifies > 0
    assert eng.integrity.mismatches == 0
    st = tsrv.stats_summary()
    assert st["sdc_scrubbed"] > 0 and st["sdc_recompute_checks"] == 0
    assert st["sdc_detected"] == st["sdc_quarantined"] == 0


@pytest.mark.parametrize("kv_dtype,key", [
    ("float32", None), ("int8", None), ("int8", "scale_k")],
    ids=["f32_payload", "int8_payload", "int8_sidecar"])
def test_flip_detected_quarantined_recovered_bitwise(serve_factory, port_lm,
                                                     ctrl, kv_dtype, key):
    jsrv, tsrv = _servers(serve_factory, port_lm,
                          *_armed(kv_dtype=kv_dtype))
    rec = _run_both(jsrv, tsrv,
                    lambda integ: _flip_event(integ, 4.0, key=key))
    assert rec, "injection never found a settled stamped page"
    same_sdc(jsrv, tsrv)
    st = tsrv.stats_summary()
    assert st["sdc_injected"] == 1
    assert st["sdc_detected"] >= 1 and st["sdc_quarantined"] >= 1
    assert _streams(tsrv) == ctrl[kv_dtype]
    eng = tsrv.engines[0]
    assert eng.allocator.quarantined >= 1
    assert rec["slot"] not in eng.integrity.stamped_slots()
    # the quarantined slot never came back into use
    assert rec["slot"] not in eng.allocator._free
    assert not (eng.table == rec["slot"]).any()
    ev = [e for e in tsrv.sdc_events if e["slot"] == rec["slot"]]
    assert ev and ev[0]["t"] >= rec["t"]
    if rec["holders"]:
        assert st["sdc_recovered"] >= 1


def test_detection_off_same_flip_escapes(serve_factory, port_lm, ctrl):
    """The same flip without the ledger reaches the attention reads: a
    held stream diverges (the reference's own streams diverge the same
    way), and nothing beyond the holders is hit."""
    jsrv, tsrv = _servers(serve_factory, port_lm, *_cfgs())
    rec = _run_both(jsrv, tsrv, lambda integ: _flip_event(integ, 4.0))
    assert rec and rec["holders"]
    same_sdc(jsrv, tsrv)
    got = _streams(tsrv)
    assert set(got) == set(range(12))
    diverged = [r for r, t in ctrl["float32"].items() if got[r] != t]
    assert diverged and set(diverged) <= set(rec["holders"])


def test_shared_prefix_flip_recovers_every_holder(serve_factory, port_lm):
    """A flip in a prefix-cache page that several requests hold: the
    quarantine evicts every holder, all streams recover bitwise, and the
    slot leaves the prefix index for good."""
    jcfg, tcfg = _armed(prefix_cache=True, max_len=24)
    jclean, tclean = _servers(serve_factory, port_lm, jcfg, tcfg)
    _run_both(jclean, tclean, shared=True)
    want = _streams(tclean)
    assert set(want) == set(range(12))
    jsrv, tsrv = _servers(serve_factory, port_lm, jcfg, tcfg)
    rec = _run_both(jsrv, tsrv,
                    lambda integ: _flip_event(integ, 7.0,
                                              prefer_shared=True),
                    shared=True)
    assert rec and len(rec["holders"]) >= 2, rec
    same_sdc(jsrv, tsrv)
    assert _streams(tsrv) == want
    eng = tsrv.engines[0]
    assert eng.allocator.quarantined >= 1
    assert rec["slot"] not in set(eng.prefix._slots.values())
    ev = [e for e in tsrv.sdc_events if e["slot"] == rec["slot"]]
    assert ev and set(ev[0]["displaced"]) >= set(rec["holders"])


# ---------------------------------------------------------------------------
# The handoff wire and the decode fleet.
# ---------------------------------------------------------------------------


def _disagg_pair(serve_factory, port_lm, **kw):
    jcfg, tcfg = _armed(**kw)
    jsrv = JaxDisaggregated(serve_factory(jcfg, server=True),
                            serve_factory(jcfg, server=True))
    return jsrv, make_disaggregated(port_lm, tcfg, CPU, 1, 1)


def _wire_hook(integ, srv, hit, repairable=True):
    """A one-shot wire fault on ``srv``'s next pending ship; without
    ``repairable`` the stash is dropped, so retransmission cannot help."""

    def hook(ship):
        li = integ.pool_layers(srv.decode.engines[0])[0]
        hit.update(integ.flip_ship_bit(ship, layer=li, index=3, bit=6))
        hit["rid"] = ship["rid"]
        if not repairable:
            ship.pop("_wire_fault")
        srv.wire_fault_hook = None

    return hook


@pytest.mark.parametrize("repairable", [True, False],
                         ids=["retransmitted", "rerouted"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_corrupt_ship_rejected_and_recovered(serve_factory, port_lm, ctrl,
                                             kv_dtype, repairable):
    """A wire flip is caught before any decode-side pool write: repaired
    by retransmission (one step parked), or, with nothing intact left,
    the request re-routes through the prefill fleet. Streams stay bitwise
    and the decode pool never quarantines."""
    jsrv, tsrv = _disagg_pair(serve_factory, port_lm, kv_dtype=kv_dtype)
    jhit, thit = {}, {}
    jsrv.wire_fault_hook = _wire_hook(JI, jsrv, jhit, repairable)
    tsrv.wire_fault_hook = _wire_hook(TI, tsrv, thit, repairable)
    jreqs, treqs = _workloads()
    assert run_closed_loop(tsrv, treqs, 6) == \
        jax_closed_loop(jsrv, jreqs, 6)
    assert thit == jhit and thit
    same_sdc(jsrv, tsrv)
    assert tsrv.wire_sdc == jsrv.wire_sdc == {
        "sdc_wire_detected": 1, "sdc_wire_repaired": int(repairable)}
    assert tsrv.stats_summary()["shipped_checksum_bytes"] > 0
    assert _streams(tsrv) == ctrl[kv_dtype]
    assert all(e.allocator.quarantined == 0 for e in tsrv.decode.engines)
    wire = [e for e in tsrv.sdc_events if e["where"] == "wire"]
    assert len(wire) == 1 and wire[0]["rid"] == thit["rid"]
    assert wire[0]["repaired"] is repairable
    if not repairable:  # the request crossed the wire a second time
        assert tsrv.shipped["shipped_requests"] == 13


def test_import_rejects_a_corrupt_ship_all_or_nothing(port_lm):
    """The importer's own check: a ship whose bytes fail their words is
    refused before any allocation or pool write (counted, traced)."""
    _, tcfg = _armed()
    a = ServeEngine(port_lm, tcfg, CPU)
    b = ServeEngine(port_lm, tcfg, CPU)
    a.submit(make_workload(seed=1, n_requests=1, vocab=VOCAB,
                           arrival="closed", prompt_lo=6, prompt_typical=6,
                           prompt_hi=6, out_lo=4, out_typical=4, out_hi=4,
                           max_len=16)[0])
    now = 0.0
    while not any(x.state == "decode" for x in a._active()):
        now += a.step(now).cost
    ship = a.extract_request(a._active()[0].req.rid)
    assert ship["checksums"][0] is None and None not in ship["checksums"][1]
    TI.flip_ship_bit(ship, layer=1, index=3, bit=6)
    free0 = b.allocator.free_pages
    assert not b.import_request(ship, now)
    assert b.stats["sdc_detected"] == 1 and not b.has_work()
    assert b.allocator.free_pages == free0
    assert TI.repair_ship(ship) and b.import_request(ship, now)


def test_ship_checksum_accounting_and_repair_roundtrip(serve_factory,
                                                      port_lm):
    """Each ship carries CHECKSUM_BYTES x (pool layers x pages) of words,
    the reference's count, and repair_ship restores the flipped byte."""
    from ddlbench_tpu_torch.serve.handoff import ship_checksum_bytes

    jsrv, tsrv = _disagg_pair(serve_factory, port_lm)
    ships = []

    def spy(ship):
        if not ships:
            ships.append((ship["n_pages"], ship_checksum_bytes(ship),
                          ship["checksum_bytes"]))

    tsrv.wire_fault_hook = spy
    run_closed_loop(tsrv, _workloads()[1], 6)
    jax_closed_loop(jsrv, _workloads()[0], 6)
    n_pages, words, stamped = ships[0]
    n_layers = len(TI.pool_layers(tsrv.decode.engines[0]))
    assert words == stamped == TI.CHECKSUM_BYTES * n_layers * n_pages
    assert tsrv.stats_summary()["shipped_checksum_bytes"] == \
        jsrv.stats_summary()["shipped_checksum_bytes"]
    for integ in (TI, JI):
        ship = {"pages": [None, {"pool_k": np.arange(8, dtype=np.float32)}]}
        before = ship["pages"][1]["pool_k"].tobytes()
        integ.flip_ship_bit(ship, layer=1, index=3, bit=6)
        assert ship["pages"][1]["pool_k"].tobytes() != before
        assert integ.repair_ship(ship) is True
        assert ship["pages"][1]["pool_k"].tobytes() == before
        assert integ.repair_ship(ship) is False


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_disagg_decode_pool_flip_recovers_bitwise(serve_factory, port_lm,
                                                  ctrl, kv_dtype):
    """A flip in the DECODE fleet's pool (pages that arrived by ship) is
    caught by its scrub, the displaced request re-routes through the
    prefill fleet, and re-prefill regenerates the shipped pages."""
    jsrv, tsrv = _disagg_pair(serve_factory, port_lm, kv_dtype=kv_dtype)
    jreqs, treqs = _workloads()
    jev, jrec = _flip_event(JI, 4.0, engine=lambda s: s.decode.engines[0])
    tev, trec = _flip_event(TI, 4.0, engine=lambda s: s.decode.engines[0])
    assert run_closed_loop(tsrv, treqs, 6, events=tev) == \
        jax_closed_loop(jsrv, jreqs, 6, events=jev)
    assert trec == jrec and trec
    same_sdc(jsrv, tsrv)
    st = tsrv.stats_summary()
    assert st["sdc_detected"] >= 1 and st["sdc_quarantined"] >= 1
    assert _streams(tsrv) == ctrl[kv_dtype]
    assert tsrv.decode.engines[0].allocator.quarantined >= 1


# ---------------------------------------------------------------------------
# Telemetry: the sdc:* instants.
# ---------------------------------------------------------------------------


def test_sdc_trace_instants_equal_jax(serve_factory, port_lm):
    """The trace half of the reference's trace-and-audit pin: the port's
    sdc:* instants, read back live and from the exported trace, equal the
    reference's on the same run, and the detect instant names the flipped
    slot."""
    jcfg, tcfg = _armed(trace=True)
    got = {}
    for name, mod, srv_of, integ, driver, reqs in (
            ("jax", jax_tracer_mod, lambda: serve_factory(jcfg,
                                                          server=True),
             JI, jax_closed_loop, _workloads()[0]),
            ("port", tracer_mod, lambda: make_server(port_lm, tcfg, CPU),
             TI, run_closed_loop, _workloads()[1])):
        prev = mod.get_tracer()
        tracer = mod.set_tracer(mod.Tracer(50_000)).enable()
        try:
            events, rec = _flip_event(integ, 4.0)
            driver(srv_of(), reqs, 6, events=events)
        finally:
            mod.set_tracer(prev)
        exp = texport if name == "port" else jax_export
        live = exp.sdc_events(tracer)
        assert live == exp.sdc_events(exp.chrome_trace_dict(tracer))
        got[name] = (live, rec)
    assert got["port"] == got["jax"]
    live, rec = got["port"]
    kinds = [e["kind"] for e in live]
    assert "detect" in kinds and "quarantine" in kinds
    det = next(e for e in live if e["kind"] == "detect")
    assert det["slot"] == rec["slot"] and det["t"] >= rec["t"]


# ---------------------------------------------------------------------------
# servebench --scrub and servechaos --corrupt rows.
# ---------------------------------------------------------------------------

# tests/test_serve_sdc.py's tool arguments
E2E = ["-m", "transformer_t", "-b", "tinylm", "--arrival", "closed",
       "--concurrency", "4", "--requests", "10", "--max-batch", "2",
       "--pool-pages", "12", "--page", "4", "--max-len", "16",
       "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--seed", "5"]
# prompts long enough that a prefill-side page settles between chunks
LONG = ["--pool-pages", "20", "--max-len", "32", "--prompt-lens", "8,12,16"]
_JAX_ROWS = {}


def jax_tool_row(tool, extra):
    key = (tool, tuple(extra))
    if key not in _JAX_ROWS:
        import importlib

        import ddlbench_tpu.config as jconfig

        mod = importlib.import_module(f"ddlbench_tpu.tools.{tool}")
        patched = dict(jconfig.DATASETS)
        patched["tinylm"] = TINY_LM
        buf = io.StringIO()
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                contextlib.redirect_stdout(buf):
            assert mod.main(E2E + extra + ["--platform", "cpu"]) == 0
        _JAX_ROWS[key] = [json.loads(l) for l in buf.getvalue().splitlines()
                          if l.startswith("{")][0]
    return _JAX_ROWS[key]


def port_tool_row(port_lm, tool, extra):
    mod = {"servebench": servebench, "servechaos": servechaos}[tool]
    args = mod.build_parser().parse_args(E2E + extra + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        out = mod.run(args, port_lm, CPU)
    return out[0][0] if tool == "servebench" else out[0]


def mismatches(t, j):
    keys = (set(t) - _PORT_PROV) | (set(j) - _JAX_PROV)
    return [k for k in sorted(keys)
            if t.get(k, "<missing>") != j.get(k, "<missing>")]


SCRUB = {
    "f32": ["--policies", "continuous", "--scrub", "4"],
    "int8_boundary_only": ["--policies", "continuous", "--scrub", "0",
                           "--kv-dtype", "int8"],
    "disagg": ["--policies", "continuous", "--scrub", "4",
               "--disaggregate", "1:1"],
}


@pytest.mark.parametrize("name", sorted(SCRUB))
def test_servebench_scrub_row_equals_jax(port_lm, name):
    row = port_tool_row(port_lm, "servebench", SCRUB[name])
    assert mismatches(row, jax_tool_row("servebench", SCRUB[name])) == []
    assert row["scrub"] == (0 if "boundary" in name else 4)
    assert row["sdc_detected"] == 0 and row["sdc_quarantined"] == 0
    assert (row["sdc_scrubbed"] > 0) == (row["scrub"] > 0)
    assert row["sdc_recompute_checks"] == 0


CHAOS = {
    "f32": ["--replicas", "2", "--corrupt", "3:0:payload"],
    "int8": ["--replicas", "2", "--corrupt", "3:0:payload",
             "--kv-dtype", "int8"],
    "int8_sidecar": ["--replicas", "2", "--corrupt", "3:0:sidecar",
                     "--kv-dtype", "int8"],
    "prefix": ["--replicas", "2", "--corrupt", "5:0:prefix",
               "--prefix-cache", "--shared-prefix", "2:8",
               "--max-len", "24", "--pool-pages", "20"],
    "disagg_pool": ["--disaggregate", "1:1", "--corrupt", "6:d0:payload"],
    "disagg_ship": ["--disaggregate", "1:1", "--corrupt", "6:0:ship"],
    "disagg_export": ["--disaggregate", "1:1", "--corrupt", "1:p0:payload",
                      "--scrub", "0"] + LONG,
    # the reference's disarmed twin (3:0): on these weights the flipped
    # exponent moves no argmax, so nothing escapes (the reference's own
    # slow test asserts an escape here and fails); at 6:0 the same kind
    # of flip reaches a stream
    "no_detect": ["--replicas", "2", "--corrupt", "3:0:payload",
                  "--no-detect"],
    "no_detect_escape": ["--replicas", "2", "--corrupt", "6:0:payload",
                         "--no-detect"],
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_servechaos_corrupt_row_equals_jax(port_lm, name):
    """The reference's headline rows (f32 and int8, aggregated and
    disaggregated, the ship) and its disarmed twin, field for field; the
    armed ones lose nothing, escape nothing and keep every stream, the
    disarmed one escapes."""
    row = port_tool_row(port_lm, "servechaos", CHAOS[name])
    assert mismatches(row, jax_tool_row("servechaos", CHAOS[name])) == []
    assert row["sdc_injected"] >= 1 and row["corrupts_fired"] >= 1
    if name.startswith("no_detect"):
        assert row["sdc_detect"] is False and row["sdc_detected"] == 0
        assert row["scrub"] == 0 and row["requests_lost"] == 0
        if name == "no_detect_escape":
            assert row["sdc_escaped"] >= 1
            assert row["streams_match"] is False
        return
    assert row["sdc_detect"] is True
    assert row["requests_lost"] == 0 and row["sdc_escaped"] == 0
    assert row["streams_match"] is True
    if name == "disagg_ship":
        assert row["sdc_wire_detected"] == row["sdc_wire_repaired"] == 1
    else:
        assert row["sdc_detected"] >= 1
    if name == "disagg_export":
        # caught at the export boundary: corrupt bytes never reach the wire
        assert [e["where"] for e in row["sdc_events"]][0] == "export"
        assert row["sdc_wire_detected"] == 0


# ---------------------------------------------------------------------------
# Planted faults.
# ---------------------------------------------------------------------------

_REAL_VERIFY = ServeEngine._verify_slot
_REAL_WRITE = ServeEngine.write_pages
_REAL_CHECKSUM = TI.page_checksum


def export_skips_verify(self, slot, where, rep=None):
    """Planted fault: the export boundary trusts the pool unchecked."""
    return True if where == "export" else _REAL_VERIFY(self, slot, where,
                                                       rep)


def write_drops_sidecars(self, slots, pages):
    """Planted fault: an import that writes the payload rows only."""
    return _REAL_WRITE(self, slots, [
        None if rows is None else {k: v for k, v in rows.items()
                                   if k.startswith("pool")}
        for rows in pages])


def checksum_skips_sidecars(rows):
    """Planted fault: a page word over the payload rows only."""
    return _REAL_CHECKSUM({k: v for k, v in rows.items()
                           if not k.startswith("scale")})


def test_planted_export_without_verify_is_rejected(port_lm, monkeypatch):
    monkeypatch.setattr(ServeEngine, "_verify_slot", export_skips_verify)
    row = port_tool_row(port_lm, "servechaos", CHAOS["disagg_export"])
    assert row["sdc_wire_detected"] >= 1  # corrupt bytes reached the wire
    assert "export" not in [e["where"] for e in row["sdc_events"]]
    assert mismatches(row, jax_tool_row("servechaos",
                                        CHAOS["disagg_export"]))


def test_planted_write_without_sidecars_is_rejected(serve_factory, port_lm,
                                                    ctrl, monkeypatch):
    monkeypatch.setattr(ServeEngine, "write_pages", write_drops_sidecars)
    tsrv = make_disaggregated(port_lm, ServeConfig(**BASE, kv_dtype="int8"),
                              CPU, 1, 1)
    run_closed_loop(tsrv, _workloads()[1], 6)
    assert _streams(tsrv) != ctrl["int8"]


def test_planted_checksum_without_sidecars_is_rejected(port_lm,
                                                       monkeypatch):
    monkeypatch.setattr(tengine, "page_checksum", checksum_skips_sidecars)
    monkeypatch.setattr(TI, "page_checksum", checksum_skips_sidecars)
    row = port_tool_row(port_lm, "servechaos", CHAOS["int8_sidecar"])
    assert row["sdc_detected"] == 0  # the sidecar flip escaped the ledger
    assert mismatches(row, jax_tool_row("servechaos",
                                        CHAOS["int8_sidecar"]))
