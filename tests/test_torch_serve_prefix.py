"""The port's prefix cache (ddlbench_tpu_torch/serve/prefix.py, the
allocator's refcounts, the engine's binds and copy-on-write) and its
shared-prefix traffic held against the JAX reference on the CPU.

The host classes must answer the same calls with the same results and the
same state as the reference's. With the reference's weights carried over,
the port's engine must emit token streams and ``token_times`` IDENTICAL to
the JAX engine's, with an equal ``stats_summary()`` on every key, through a
partial hit, a full page-aligned hit (one copy-on-write), a multipage full
hit, concurrent full-hit siblings, and cache reclaim under pool pressure.
The helpers here also serve tests/test_torch_serve_spec.py.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import numpy as np
import pytest
import torch

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.allocator import PageAllocator as JaxAllocator
from ddlbench_tpu.serve.prefix import PrefixIndex as JaxPrefixIndex
from ddlbench_tpu.serve.workload import ServeRequest as JaxRequest
from ddlbench_tpu.serve.workload import make_workload as jax_workload

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.engine import ServeEngine
from ddlbench_tpu_torch.serve.prefix import PrefixIndex
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_lm(serve_factory):
    """The port's tiny LM carrying the session JAX LM's weights."""
    tm = build_transformer("transformer_t", TINY_LM.image_size, VOCAB)
    return from_jax_params(tm, jax.device_get(serve_factory.params))


def _serve(eng, make_req, prompts, max_new, n_seq):
    """Drain the first ``n_seq`` prompts one at a time (each request's
    pages register before the next admits), then the rest together."""
    reqs = [make_req(rid=i, prompt=np.asarray(p, np.int32), max_new=max_new,
                     arrival=0.0) for i, p in enumerate(prompts)]
    now = 0.0
    for batch in [[r] for r in reqs[:n_seq]] + [reqs[n_seq:]]:
        for r in batch:
            eng.submit(r)
        while eng.has_work():
            now += eng.step(now).cost
    return {f["rid"]: f for f in eng.finished}


def run_both(serve_factory, port_lm, kw, prompts, max_new, n_seq=0,
             drafter=None):
    """The same traffic through the JAX engine and the port's; asserts
    identical finished records and an equal ``stats_summary()``. A
    ``drafter`` factory replaces both engines' n-gram drafter. Returns
    (JAX engine, port engine)."""
    jeng = serve_factory(JaxServeConfig(**kw))
    teng = ServeEngine(port_lm, ServeConfig(**kw), CPU)
    if drafter is not None:
        jeng._drafter, teng._drafter = drafter(), drafter()
    want = _serve(jeng, JaxRequest, prompts, max_new, n_seq)
    got = _serve(teng, ServeRequest, prompts, max_new, n_seq)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid, w in want.items():
        for key in ("tokens", "token_times", "first_token_t",
                    "completed_t", "cached_tokens"):
            assert got[rid][key] == w[key], (rid, key)
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for k in ts:
        assert ts[k] == js[k], k
    assert teng.allocator.in_use == jeng.allocator.in_use
    return jeng, teng


_HEAD = np.random.default_rng(43).integers(0, VOCAB, size=(12,))
_TAIL = np.random.default_rng(44).integers(0, VOCAB, size=(3,))
_OTHER = np.random.default_rng(45).integers(0, VOCAB, size=(20,))

# name -> (config, prompts, max_new, prompts drained one at a time)
CASES = {
    # B binds A's page and prefills its tail; C (A's prompt again) is a
    # full page-aligned hit: bind + copy-on-write, straight to decode
    "partial_and_full_hit": (
        dict(max_batch=2, pool_pages=13, page=4, max_len=16,
             prefill_chunk=4),
        [_HEAD[:4], np.concatenate([_HEAD[:4], _TAIL[:2]]), _HEAD[:4]],
        2, 3),
    # a two-page prompt, then a partial hit on it; then two siblings
    # admitted together, each a full hit that binds one page and copies
    # the other into a slot of its own
    "multipage_full_hit": (
        dict(max_batch=2, pool_pages=17, page=4, max_len=24,
             prefill_chunk=4),
        [_HEAD[:8], np.concatenate([_HEAD[:8], _TAIL]), _HEAD[:8],
         _HEAD[:8]],
        3, 2),
    # 8 usable pages: the cache fills the pool with unbound prompt pages,
    # which the fourth request's allocations reclaim (newest first); the
    # last request hits what is left
    "reclaim_under_pressure": (
        dict(max_batch=2, pool_pages=9, page=4, max_len=16,
             prefill_chunk=4),
        [_HEAD[:8], _OTHER[:8], _OTHER[8:20],
         np.concatenate([_HEAD[4:12], _TAIL]), _HEAD[:8]],
        4, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefix_engine_streams_identical_to_jax(serve_factory, port_lm,
                                                name):
    kw, prompts, max_new, n_seq = CASES[name]
    _, teng = run_both(serve_factory, port_lm, dict(kw, prefix_cache=True),
                       prompts, max_new, n_seq)
    s = teng.stats_summary()
    assert s["prefix_hits"] >= 1 and s["prefix_tokens_saved"] > 0
    if name == "partial_and_full_hit":
        assert s["cow_copies"] == 1
    if name == "multipage_full_hit":
        assert s["cow_copies"] == 2 and s["shared_pages"] >= 2
    if name == "reclaim_under_pressure":
        assert teng.prefix.reclaimed > 0
    # the cache changes when work happens, never what comes out
    off = ServeEngine(port_lm, ServeConfig(**kw), CPU)
    plain = _serve(off, ServeRequest, prompts, max_new, n_seq)
    assert {r: f["tokens"] for r, f in plain.items()} == \
        {f["rid"]: f["tokens"] for f in teng.finished}


def test_int8_prefix_binds_and_copies_the_scales(serve_factory, port_lm):
    """At int8 the scale sidecars travel with bound and copied pages: the
    JAX and port engines agree, and cache-on streams equal cache-off."""
    kw, prompts, max_new, n_seq = CASES["partial_and_full_hit"]
    # the pool of test_torch_kv_quant's chunked case: one JAX compile
    kw = dict(kw, kv_dtype="int8", pool_pages=9)
    _, teng = run_both(serve_factory, port_lm, dict(kw, prefix_cache=True),
                       prompts, max_new, n_seq)
    assert teng.stats["prefix_hits"] == 2 and teng.stats["cow_copies"] == 1
    off = ServeEngine(port_lm, ServeConfig(**kw), CPU)
    plain = _serve(off, ServeRequest, prompts, max_new, n_seq)
    toks = {f["rid"]: f["tokens"] for f in teng.finished}
    assert {r: f["tokens"] for r, f in plain.items()} == toks
    assert toks[0] == toks[2]


def _allocator_script(al):
    """One call sequence over the refcount API; returns every result and
    the allocator's state after each call."""
    out = []

    def note(x):
        out.append((x, al.in_use, al.free_pages, al.shared_pages,
                    [al.refcount(s) for s in range(al.n_pages)]))

    a = al.alloc(1, 2)
    note(a)
    note(al.alloc(2, 1))
    note(al.bind(2, a))
    note(al.incref(a[0]))
    note(al.holders(a[0]))
    note(al.free_request(1))
    note(al.release(2, [a[1]]))
    note(al.decref(a[0]))
    note(al.alloc(3, 5))
    note(al.alloc(4, 1))
    note(al.free_request(2))
    note(al.free_request(3))
    note(al.alloc(5, 6))
    # slot 3 is free, slot 8 belongs to request 4, request 1 is gone
    for bad in (lambda: al.bind(9, [3]), lambda: al.incref(3),
                lambda: al.release(5, [8]), lambda: al.free_request(1),
                lambda: al.decref(3)):
        with pytest.raises(ValueError):
            bad()
    note(al.release(5, al.owned(5)))
    note(al.free_request(5))  # a fully released rid is still live
    return out


def test_allocator_refcounts_match_reference():
    assert _allocator_script(PageAllocator(9)) == \
        _allocator_script(JaxAllocator(9))


def _index_script(al, index_cls):
    ix = index_cls(al, 4)
    out = []
    head = np.arange(12, dtype=np.int32)
    other = np.concatenate([head[:4], np.full(8, 40, np.int32)])
    a = al.alloc(1, 3)
    for b in range(3):
        out.append(ix.register(head, b, a[b]))
    out.append(ix.register(head, 0, a[1]))  # already cached: keeps first
    out.append(ix.match(head))
    out.append(ix.match(head[:7]))
    out.append(ix.match(other))
    out.append(ix.match(np.arange(1, 13, dtype=np.int32)))
    b = al.alloc(2, 1)
    out.append(ix.register(other, 1, b[0]))
    al.bind(3, [a[0]])
    out.append(al.free_request(1))
    out.append(ix.reclaim(2))  # skips a[0], which request 3 binds
    out.append(ix.match(head))
    out.append((len(ix), ix.lookups, ix.hit_blocks, ix.reclaimed))
    al.free_request(3)
    al.free_request(2)
    out.append(ix.drop_all())
    out.append((len(ix), al.in_use))
    return out


def test_prefix_index_matches_reference():
    assert _index_script(PageAllocator(9), PrefixIndex) == \
        _index_script(JaxAllocator(9), JaxPrefixIndex)


@pytest.mark.parametrize("arrival", ["closed", "poisson", "bursty"])
def test_shared_prefix_workload_identical_to_jax(arrival):
    kw = dict(seed=5, n_requests=12, vocab=VOCAB, arrival=arrival,
              prompt_lo=1, prompt_typical=4, prompt_hi=12, out_lo=2,
              out_typical=4, out_hi=10, prefix_groups=3, prefix_len=6,
              max_len=24)
    want, got = jax_workload(**kw), make_workload(**kw)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g.rid, g.max_new, g.arrival) == (w.rid, w.max_new,
                                                 w.arrival)
        np.testing.assert_array_equal(g.prompt, w.prompt)
    for bad in (dict(prefix_groups=2), dict(prefix_len=4),
                dict(prefix_groups=2, prefix_len=22)):
        with pytest.raises(ValueError):
            make_workload(**{**kw, "prefix_groups": 0, "prefix_len": 0,
                             **bad})


def test_prefix_cache_config_rules():
    ServeConfig(prefix_cache=True).validate()
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(prefix_cache=True, policy="static").validate()
    with pytest.raises(ValueError, match="continuous"):
        JaxServeConfig(prefix_cache=True, policy="static").validate()
