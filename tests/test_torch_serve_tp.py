"""Tensor-parallel serving (``ServeConfig.tp`` > 1) in the port held to
the reference's and to the port's tp 1.

A tp group is one replica: the port walks its shards in one process on
its one device (serve/engine.py), each dense block split by Megatron's
slicing and each shard's heads in its slice of a pool stacked on a
leading [tp] axis. On tests/test_serve_disagg.py's workload (12 closed
requests over the tiny LM, pages of 4, serve_factory's weights; the
reference's tp 2 on two of the conftest's 8 virtual CPU devices):

* the port's tp 2 streams equal the port's tp 1 streams bitwise, and
  its finished records (streams and virtual times) equal the
  reference's tp 2 records, over float32 and int8 pools;
* the int8 shard pools: the same K/V written through each package's
  table write on every shard give the same payload and scale bytes
  (each shard rounds its own [H/tp, dh] heads with the layer's key, not
  a slice of tp 1's rounding), in the reference's layout: the page axis
  1, ``bytes_per_page`` the whole page;
* a disaggregated 1:1 server at tp 2 with the SDC ledger: its records
  and ship counters equal the reference's, its ledgers hold the same
  entries, and its words are the reference's checksums of the shipped
  rows, which carry every shard's slice;
* a bit flipped in shard 1's slice of a stamped page is caught by the
  scrubber at the same step as the reference's, the same slot
  quarantined;
* ``ServeConfig(tp=0)`` refused; a model whose width or heads do not
  split is refused.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import numpy as np
import pytest
import torch

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.handoff import \
    DisaggregatedServer as JaxDisaggregated
from ddlbench_tpu.serve.integrity import flip_pool_bit as jax_flip
from ddlbench_tpu.tools.servebench import \
    run_closed_loop as jax_closed_loop

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.ops.paged_decode import pool_checksum_keys
from ddlbench_tpu_torch.serve.engine import ServeEngine, make_server
from ddlbench_tpu_torch.serve.handoff import make_disaggregated
from ddlbench_tpu_torch.serve.integrity import flip_pool_bit, host_rows
from ddlbench_tpu_torch.tools.servebench import run_closed_loop

from test_torch_serve import CPU
from test_torch_serve_disagg import FLEET, _streams, _workloads, same_disagg
from test_torch_serve_prefix import port_lm  # noqa: F401

pytestmark = pytest.mark.torchport

_RUNS = {}


def _run(serve_factory, port_lm, kv_dtype):
    """The port's tp 1 and tp 2 servers and the reference's tp 2, one run
    each on the same traffic, shared by the tests below."""
    if kv_dtype not in _RUNS:
        jreqs, treqs = _workloads()
        jsrv = serve_factory(JaxServeConfig(**FLEET, replicas=1, tp=2,
                                            kv_dtype=kv_dtype), server=True)
        jc = jax_closed_loop(jsrv, jreqs, 6)
        out = {"jax": jsrv}
        for tp in (1, 2):
            srv = make_server(port_lm, ServeConfig(**FLEET, tp=tp,
                                                   kv_dtype=kv_dtype), CPU)
            assert run_closed_loop(srv, _workloads()[1], 6) == jc
            out[tp] = srv
        _RUNS[kv_dtype] = out
    return _RUNS[kv_dtype]


def _page_axes(srv):
    """The slot axis of every pool of the server's first engine, read from
    the pool tensors (ops/paged_decode.slot_axis)."""
    from ddlbench_tpu_torch.ops.paged_decode import slot_axis

    return {slot_axis("pool_k", p["pool_k"]) for p in srv.engines[0].pools
            if p is not None}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_tp2_streams_bitwise_vs_tp1_and_reference(serve_factory, port_lm,
                                                  kv_dtype):
    runs = _run(serve_factory, port_lm, kv_dtype)
    tp1, tp2, jsrv = runs[1], runs[2], runs["jax"]
    assert _page_axes(tp1) == {0}
    assert _page_axes(tp2) == {jsrv.engines[0]._page_axis} == {1}
    s1, s2 = _streams(tp1), _streams(tp2)
    assert set(s2) == set(range(12))
    assert s2 == s1
    assert tp2.finished == jsrv.finished
    assert tp2.stats_summary() == jsrv.stats_summary()


def test_tp2_int8_pools_bitwise_vs_reference(serve_factory, port_lm):
    """The engines' int8 shard pools, written with the same K/V chunk
    through each package's table write on every shard (what each
    shard's prefill does with its heads' K/V), hold the same bytes and
    scales; the rounding is the shard's own, not tp 1's sliced. (After a
    whole run the streams are bitwise but the pools are not: the two
    frameworks' matmuls round K/V's last bits apart, and the scales
    show it.)"""
    import jax.numpy as jnp

    from ddlbench_tpu.ops.paged_decode import \
        paged_table_chunk_write as jax_write

    from ddlbench_tpu_torch.ops.paged_decode import (paged_table_chunk_write,
                                                     pool_shard)

    runs = _run(serve_factory, port_lm, "int8")
    assert runs[2].engines[0].bytes_per_page == \
        runs["jax"].engines[0].bytes_per_page == \
        runs[1].engines[0].bytes_per_page
    cfg = dict(FLEET, replicas=1, kv_dtype="int8")
    jeng = serve_factory(JaxServeConfig(**cfg, tp=2))
    eng = ServeEngine(port_lm, ServeConfig(**cfg, tp=2), CPU)
    one = ServeEngine(port_lm, ServeConfig(**cfg), CPU)
    page, C = FLEET["page"], 8
    table = np.zeros((1, FLEET["max_len"] // page), np.int32)
    table[0, :2] = [3, 7]
    rng = np.random.default_rng(0)
    n_pools = 0
    for li, (pool, jpool) in enumerate(zip(eng.pools, jeng.pools)):
        if pool is None:
            assert jpool is None
            continue
        n_pools += 1
        assert pool["kv_seed"] == int(jpool["kv_seed"]) == li
        H, dh = one.pools[li]["pool_k"].shape[-2:]
        k, v = (rng.standard_normal((1, C, H, dh)).astype(np.float32)
                for _ in range(2))
        Hl = H // 2
        for s in range(2):
            heads = slice(s * Hl, (s + 1) * Hl)
            paged_table_chunk_write(
                {**pool_shard(pool, s), "table": torch.from_numpy(table)},
                torch.from_numpy(k[:, :, heads].copy()),
                torch.from_numpy(v[:, :, heads].copy()), 0, page)
            jshard = {key: (a[s] if key != "kv_seed" else a)
                      for key, a in jpool.items()}
            out = jax_write({**jshard, "table": jnp.asarray(table)},
                            jnp.asarray(k[:, :, heads]),
                            jnp.asarray(v[:, :, heads]), 0, page)
            for key in pool_checksum_keys(pool):
                np.testing.assert_array_equal(
                    host_rows(pool[key][s]), np.asarray(out[key]),
                    err_msg=f"layer {li} shard {s} {key}")
        whole = {**one.pools[li], "table": torch.from_numpy(table)}
        paged_table_chunk_write(whole, torch.from_numpy(k),
                                torch.from_numpy(v), 0, page)
        sliced = whole["pool_k"][[3, 7]][:, :, :Hl]
        assert not torch.equal(sliced, pool["pool_k"][0][[3, 7]])
    assert n_pools == 2


def _ledger(eng):
    return {key: gen for key, (gen, _) in eng.integrity._crc.items()}


def test_tp2_disaggregated_ship_and_ledger(serve_factory, port_lm):
    """A 1:1 disaggregated server at tp 2 with the ledger armed, both
    sides on the same traffic: the records and ship counters equal; at
    t 4 both ledgers hold the same (layer, slot) entries at the same
    generations, and the port's words are the reference's checksums of
    the port's fetched [tp, pages, ...] rows (ship_checksums over page
    axis 1, both packages' on the same bytes)."""
    from ddlbench_tpu.serve.integrity import \
        ship_checksums as jax_ship_checksums

    from ddlbench_tpu_torch.serve.integrity import ship_checksums

    cfg = dict(FLEET, tp=2, kv_dtype="int8", integrity=True, scrub=2)
    jsrv = JaxDisaggregated(
        serve_factory(JaxServeConfig(**cfg, replicas=1), server=True),
        serve_factory(JaxServeConfig(**cfg, replicas=1), server=True))
    tsrv = make_disaggregated(port_lm, ServeConfig(**cfg), CPU, 1, 1)
    seen = {}

    def at(name):
        def grab(srv, clock):
            seen[name] = [(_ledger(e), e) for e in
                          (srv.prefill.engines[0], srv.decode.engines[0])]
            if name == "port":  # the words, while the pages are live
                seen["words"] = []
                for _, e in seen[name]:
                    slots = sorted({slot for _, slot in e.integrity._crc})
                    rows = e.fetch_pages(slots)
                    want = jax_ship_checksums(rows, 1)
                    assert ship_checksums(rows) == want
                    for layer in rows:
                        assert layer is None or all(
                            a.shape[:2] == (2, len(slots))
                            for a in layer.values())
                    seen["words"].append(
                        (want, [[e.integrity.expected(li, slot)
                                 for slot in slots] if w is not None
                                else None for li, w in enumerate(want)]))
        return grab

    jreqs, treqs = _workloads()
    assert run_closed_loop(tsrv, treqs, 6, events=[(4.0, at("port"))]) == \
        jax_closed_loop(jsrv, jreqs, 6, events=[(4.0, at("jax"))])
    same_disagg(jsrv, tsrv)
    assert tsrv.shipped["shipped_requests"] == 12
    assert [led for led, _ in seen["port"]] == \
        [led for led, _ in seen["jax"]]
    assert any(led for led, _ in seen["port"])
    for want, ledger_words in seen["words"]:
        assert want == ledger_words


def test_tp2_flip_in_a_shard_is_caught(serve_factory, port_lm):
    """A bit flipped in shard 1's slice of a stamped page: the scrubber
    finds it on both sides, at the same step, and quarantines it."""
    cfg = dict(FLEET, tp=2, integrity=True, scrub=4, replicas=1)
    jeng = serve_factory(JaxServeConfig(**cfg))
    teng = ServeEngine(port_lm, ServeConfig(**cfg), CPU)
    jreqs, treqs = _workloads(n=4)
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r, now=0.0)
        eng.step(0.0)
    slot = int(teng.table[0, 0])
    assert slot == int(jeng.table[0, 0]) and slot
    per = teng.pools[1]["pool_k"][0, slot].numel() * 4  # one shard's bytes
    rec = flip_pool_bit(teng, 1, slot, index=per + 5, bit=3)
    jrec = jax_flip(jeng, 1, slot, index=per + 5, bit=3)
    assert rec == jrec
    for eng in (jeng, teng):
        t = 1.0
        while eng.has_work():
            eng.step(t)
            t += 1.0
    assert teng.sdc_events == jeng.sdc_events
    assert teng.sdc_events and teng.sdc_events[0]["slot"] == slot
    assert teng.stats["sdc_detected"] == jeng.stats["sdc_detected"] >= 1


def test_tp_config_refusals(port_lm):
    with pytest.raises(ValueError, match="positive"):
        ServeConfig(tp=0).validate()
    with pytest.raises(ValueError, match="not divisible by tp_size=3"):
        ServeEngine(port_lm, ServeConfig(**FLEET, tp=3), CPU)
    with pytest.raises(ValueError, match="n_heads=4 not divisible"):
        ServeEngine(port_lm, ServeConfig(**FLEET, tp=8), CPU)
    ServeConfig(tp=4).validate()
