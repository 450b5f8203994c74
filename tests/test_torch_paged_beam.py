"""The port's row-owned beam cache (ddlbench_tpu_torch/ops/paged_decode.py
``paged_cache_init``/``paged_prefill_write``/``paged_decode_write``/
``paged_reorder``) and the paged decoders of models/decode.py held against
the JAX reference on the CPU.

The mirror of the beam-cache cases of tests/test_paged_decode.py, at its
sizes (rows 4, H 2, dh 8, pages of 4, 16 positions) and its inputs (drawn
with jax.random from the same keys and handed to both sides): the writes'
round trip, chunked prefill, the out-of-bounds chunk refused, the
copy-on-write reorder against a physical gather, num_pages; and the paged
greedy and beam of seq2seq_t and the paged greedy of transformer_t with
PAGE shrunk to 4 on BOTH sides (the reference's ``small_pages``), so the
16-token stream spans four pages and every reorder copies a partial page.
Added: two beams that swap parents mid-page (a copy one row at a time
would read an overwritten source), and a decode position past the cache
refused where the reference's dynamic_update_slice clamps (ROADMAP C.2).

Tolerances: pools and tables exactly equal (the same values written);
attention rtol/atol 1e-5; tokens EQUAL and beam scores within rtol 1e-4,
atol 1e-5 in float32 (the frameworks sum in different orders). A
bfloat16 cache: tokens equal and scores within rtol 2^-7 of the
reference's bfloat16 run — both round K/V to bfloat16 alike, but the
attention then sums the rounded values in another order, and each step's
log-prob can move by a few bfloat16 ulps of the logits.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.decode as jdec
import ddlbench_tpu.models.seq2seq as js2s
import ddlbench_tpu.models.transformer as jtr
import ddlbench_tpu.ops.paged_decode as jpd
from ddlbench_tpu.models.layers import init_model

import ddlbench_tpu_torch.models.seq2seq as s2s
import ddlbench_tpu_torch.ops.paged_decode as pd
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.models.layers import DecodeLayer, LayerModel
from ddlbench_tpu_torch.models.transformer import LMHead

pytestmark = pytest.mark.torchport

ROWS, H, DH, PAGE = 4, 2, 8, 4
L = 16  # 4 pages
TINY = dict(d_model=32, n_layers=2, n_heads=4)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_RTOL = 2.0 ** -7


def _rand(key, *shape):
    """jax.random.normal at the reference test's key, as numpy."""
    return np.asarray(jax.random.normal(jax.random.key(key), shape,
                                        jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _gather_pages(cache):
    """Densify: [rows, H, npg * page, dh] of what the table exposes."""
    table = cache["table"].long()
    rows, npg = table.shape
    k = cache["pool_k"][table].reshape(rows, npg * PAGE, H, DH)
    v = cache["pool_v"][table].reshape(rows, npg * PAGE, H, DH)
    return k.transpose(1, 2), v.transpose(1, 2)


def _same_cache(got, want):
    for key in ("pool_k", "pool_v", "table"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_prefill_and_decode_writes_roundtrip():
    S = 6  # straddles a page boundary (pages of 4)
    k, v = _rand(0, ROWS, S, H, DH), _rand(1, ROWS, S, H, DH)
    cache = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    assert cache["table"].dtype == torch.int32
    pd.paged_prefill_write(cache, _t(k), _t(v), page=PAGE)
    jc = jpd.paged_cache_init(ROWS, L, H, DH, jnp.float32, page=PAGE)
    jc = jpd.paged_prefill_write(jc, jnp.asarray(k), jnp.asarray(v),
                                 page=PAGE)
    _same_cache(cache, jc)
    kd, vd = _gather_pages(cache)
    np.testing.assert_array_equal(kd[:, :, :S].numpy(), k.transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(vd[:, :, :S].numpy(), v.transpose(0, 2, 1, 3))
    for t in range(S, L):  # single-token writes continue the stream
        k1 = _rand(10 + t, ROWS, 1, H, DH)
        pd.paged_decode_write(cache, _t(k1), _t(k1 * 2.0), t, page=PAGE)
        jc = jpd.paged_decode_write(jc, jnp.asarray(k1),
                                    jnp.asarray(k1 * 2.0), t, page=PAGE)
        kd, vd = _gather_pages(cache)
        np.testing.assert_array_equal(kd[:, :, t].numpy(), k1[:, 0])
        np.testing.assert_array_equal(vd[:, :, t].numpy(), 2.0 * k1[:, 0])
    _same_cache(cache, jc)


def test_chunked_prefill_matches_whole_prompt():
    """Chunks [0, 5), [5, 11), [11, 14), page-UNALIGNED at pages of 4,
    leave the pool equal to one whole-prompt write, and to the
    reference's."""
    k, v = _rand(90, ROWS, 14, H, DH), _rand(91, ROWS, 14, H, DH)
    whole = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    pd.paged_prefill_write(whole, _t(k), _t(v), page=PAGE)
    chunked = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    jc = jpd.paged_cache_init(ROWS, L, H, DH, jnp.float32, page=PAGE)
    for lo, hi in ((0, 5), (5, 11), (11, 14)):
        pd.paged_prefill_write(chunked, _t(k[:, lo:hi]), _t(v[:, lo:hi]),
                               page=PAGE, start=lo)
        jc = jpd.paged_prefill_write(jc, jnp.asarray(k[:, lo:hi]),
                                     jnp.asarray(v[:, lo:hi]), page=PAGE,
                                     start=lo)
    for key in ("pool_k", "pool_v", "table"):
        assert torch.equal(chunked[key], whole[key]), key
    _same_cache(chunked, jc)


def test_chunked_prefill_rejects_out_of_bounds_chunk():
    # the reference's scatter would drop the positions past the pool:
    # both sides assert before writing
    cache = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    k, v = _t(_rand(0, ROWS, 6, H, DH)), _t(_rand(1, ROWS, 6, H, DH))
    with pytest.raises(AssertionError, match="capacity"):
        pd.paged_prefill_write(cache, k, v, page=PAGE, start=L - 4)
    # the last in-bounds chunk still works
    pd.paged_prefill_write(cache, k[:, :4], v[:, :4], page=PAGE, start=L - 4)


@pytest.mark.parametrize("pos", [-1, L])
def test_decode_write_outside_the_cache_refused(pos):
    """Where the reference's dynamic_update_slice clamps a position past
    the cache onto its last page (ROADMAP C.2), the port asserts."""
    cache = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    k1 = _t(_rand(3, ROWS, 1, H, DH))
    with pytest.raises(AssertionError, match="outside the paged cache"):
        pd.paged_decode_write(cache, k1, k1, pos, page=PAGE)


def test_int8_beam_cache_refused():
    with pytest.raises(ValueError, match="C.10"):
        pd.paged_cache_init(ROWS, L, H, DH, torch.int8, page=PAGE)


@pytest.mark.parametrize("pos,npl", [(3, 1), (7, 2), (10, 3), (14, 4)])
def test_paged_attention_over_the_beam_cache(pos, npl):
    """The decode attention walks the beam cache as it is: against the
    reference's plain version over the same cache."""
    kf, vf = _rand(2, ROWS, L, H, DH), _rand(3, ROWS, L, H, DH)
    q = _rand(4, ROWS, H, DH)
    cache = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    pd.paged_prefill_write(cache, _t(kf), _t(vf), page=PAGE)
    jc = jpd.paged_cache_init(ROWS, L, H, DH, jnp.float32, page=PAGE)
    jc = jpd.paged_prefill_write(jc, jnp.asarray(kf), jnp.asarray(vf),
                                 page=PAGE)
    got = pd.paged_attention(_t(q), cache, pos, npl, PAGE)
    want = jpd._paged_attention_ref(jnp.asarray(q), jc, pos, npl, page=PAGE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _dense_attention(q, kd, vd, pos):
    """Masked full-length single-query attention (the dense oracle)."""
    scores = torch.einsum("rhd,rhkd->rhk", q, kd) / math.sqrt(q.shape[-1])
    k_pos = torch.arange(kd.shape[2])
    probs = torch.softmax(scores.masked_fill(k_pos > pos, -math.inf), -1)
    return torch.einsum("rhk,rhkd->rhd", probs, vd)


def _reorder_chain(parents, S=4):
    """Prefill S positions, then for each step t a reorder along
    ``parents[t - S]`` and one write, both on the port and on a physically
    gathered dense mirror, and in the reference; after each step the
    table's view must equal the mirror, the port's pools and table the
    reference's, and attention over the live pages the dense oracle."""
    k0, v0 = _rand(8, ROWS, S, H, DH), _rand(9, ROWS, S, H, DH)
    cache = pd.paged_cache_init(ROWS, L, H, DH, torch.float32, page=PAGE)
    pd.paged_prefill_write(cache, _t(k0), _t(v0), page=PAGE)
    jc = jpd.paged_cache_init(ROWS, L, H, DH, jnp.float32, page=PAGE)
    jc = jpd.paged_prefill_write(jc, jnp.asarray(k0), jnp.asarray(v0),
                                 page=PAGE)
    kd = torch.zeros(ROWS, L, H, DH)
    vd = torch.zeros(ROWS, L, H, DH)
    kd[:, :S], vd[:, :S] = _t(k0), _t(v0)
    for t, parent in enumerate(parents, start=S):
        par = torch.as_tensor(parent, dtype=torch.int32)
        cache = pd.paged_reorder(cache, par, t, page=PAGE)
        assert cache["table"].dtype == torch.int32
        assert cache["table"].is_contiguous()
        jc = jpd.paged_reorder(jc, jnp.asarray(parent, jnp.int32), t,
                               page=PAGE)
        kd, vd = kd[par.long()], vd[par.long()]
        k1, v1 = _rand(20 + t, ROWS, 1, H, DH), _rand(40 + t, ROWS, 1, H, DH)
        pd.paged_decode_write(cache, _t(k1), _t(v1), t, page=PAGE)
        jc = jpd.paged_decode_write(jc, jnp.asarray(k1), jnp.asarray(v1), t,
                                    page=PAGE)
        kd[:, t], vd[:, t] = _t(k1[:, 0]), _t(v1[:, 0])
        kp, vp = _gather_pages(cache)
        assert torch.equal(kp[:, :, :t + 1], kd[:, :t + 1].transpose(1, 2))
        assert torch.equal(vp[:, :, :t + 1], vd[:, :t + 1].transpose(1, 2))
        _same_cache(cache, jc)
        q = _t(_rand(60 + t, ROWS, H, DH))
        out = pd.paged_attention(q, cache, t, t // PAGE + 1, PAGE)
        exp = _dense_attention(q, kd.transpose(1, 2), vd.transpose(1, 2), t)
        np.testing.assert_allclose(out.numpy(), exp.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_cow_reorder_matches_physical_gather():
    """Random beam-parent chains (the reference test's draws)."""
    rng = np.random.default_rng(0)
    _reorder_chain([rng.integers(0, ROWS, ROWS) for _ in range(4, L)])


def test_cow_reorder_beams_swapping_parents_mid_page():
    """Rows 0/1 and 2/3 swap histories at positions 5, 6 and 9 (mid-page:
    each reorder copies a partial page between the two rows of a pair, in
    both directions at once), with plain continuations and a page-aligned
    swap (position 8, pointers only) between."""
    swap, keep = [1, 0, 3, 2], [0, 1, 2, 3]
    parents = [keep, swap, swap, keep, swap, swap] + [keep] * 6
    _reorder_chain(parents)


def test_num_pages():
    assert pd.num_pages(256, 64) == 4
    assert pd.num_pages(257, 64) == 5
    assert pd.num_pages(64, 64) == 1
    assert pd.PAGE == jpd.PAGE == 64


# ---------------------------------------------------------------------------
# End to end: paged greedy / beam against the reference's, PAGE 4 on both
# sides so the 16-token stream spans four pages.
# ---------------------------------------------------------------------------


@pytest.fixture
def small_pages(monkeypatch):
    monkeypatch.setattr(jpd, "PAGE", 4)
    monkeypatch.setattr(pd, "PAGE", 4)


@pytest.fixture(scope="module", autouse=True)
def _variants():
    js2s._VARIANTS["seq2seq_t"] = TINY
    s2s._VARIANTS["seq2seq_t"] = TINY
    jtr._VARIANTS["transformer_t"] = TINY
    jtr.set_attention_backend("xla")
    yield
    jtr.set_attention_backend("auto")


@pytest.fixture(scope="module")
def mt():
    jm = js2s.build_seq2seq("seq2seq_t", (16,), 64, 8)
    params, state, _ = init_model(jm, jax.random.key(0))
    tm = s2s.build_seq2seq("seq2seq_t", (16,), 64, 8)
    from_jax_params(tm, jax.device_get(params))
    return jm, params, state, tm


def _src(key, shape):
    return np.asarray(jax.random.randint(jax.random.key(key), shape, 0, 64,
                                         jnp.int32))


def test_paged_greedy_token_identical(mt, small_pages):
    jm, params, state, tm = mt
    src = _src(4, (3, 8))
    want = jdec.greedy_decode(jm, params, state, jnp.asarray(src), 16,
                              paged=True)
    got = dec.greedy_decode(tm, _t(src).long(), 16, paged=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = dec.greedy_decode(tm, _t(src).long(), 16)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_beam_token_identical(mt, small_pages, dtype):
    jm, params, state, tm = mt
    src = _src(5, (2, 8))
    want_x, want_s = jdec.beam_search_decode(
        jm, params, state, jnp.asarray(src), 16, beam=3,
        dtype=jnp.dtype(dtype), paged=True)
    got_x, got_s = dec.beam_search_decode(tm, _t(src).long(), 16, beam=3,
                                          dtype=getattr(torch, dtype),
                                          paged=True)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    tol = TOL if dtype == "float32" else dict(rtol=BF16_RTOL, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)
    if dtype == "float32":
        dense_x, dense_s = dec.beam_search_decode(tm, _t(src).long(), 16,
                                                  beam=3)
        assert torch.equal(got_x, dense_x)
        np.testing.assert_allclose(got_s.numpy(), dense_s.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_paged_causal_lm_greedy_token_identical(small_pages):
    """Causal LMs (plain blocks) share the paged protocol."""
    jm = jtr.build_transformer("transformer_t", (16,), 64)
    params, state, _ = init_model(jm, jax.random.key(3))
    tm = ttr.build_transformer("transformer_t", (16,), 64)
    from_jax_params(tm, jax.device_get(params))
    src = _src(6, (2, 5))
    want = jdec.greedy_decode(jm, params, state, jnp.asarray(src), 16,
                              paged=True)
    got = dec.greedy_decode(tm, _t(src).long(), 16, paged=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _DenseOnly(DecodeLayer):
    """A cache-carrying layer without the paged ops."""

    cached = True

    def forward(self, x):
        return x


def test_paged_rejects_unsupported(small_pages):
    model = LayerModel("dense_only", [_DenseOnly(), LMHead(4, 8,
                       torch.Generator().manual_seed(0))], (16,), 8)
    assert dec.supports_cache(model) and not dec.supports_paged(model)
    with pytest.raises(NotImplementedError, match="paged-decode"):
        dec.greedy_decode(model, torch.zeros(1, 4), 16, paged=True)
