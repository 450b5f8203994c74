"""The port's KV-cached decoders (ddlbench_tpu_torch/models/decode.py) and
seq2seq's decode entry points held against the JAX reference on the CPU.

The mirror of tests/test_decode.py (its MoE case waits for models/moe.py,
its decodebench case is in test_torch_decode_tools.py) and of the decode
cases of tests/test_seq2seq.py, at the reference tests' sizes and seeds:
seq2seq_t / transformer_t (d 32, 2 layers, 4 heads), T 16, source 8,
vocab 64, the reference's weights carried over by convert.from_jax_params,
the prompts the reference tests draw with jax.random. Each JAX decode
loop compiles slowly, so each JAX output is computed once per module.

Tolerances (float32): tokens EQUAL; logits and beam scores within rtol
1e-4, atol 1e-5, as the two frameworks sum in different orders (the
reference's own cached-vs-full tests use 2e-5 and 1e-4). Also pinned: the
port's engine serving transformer_t greedily emits the streams of its own
greedy_decode (tests/test_serve.py's oracle), and an int8 cache is
refused (ROADMAP C.10).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.decode as jdec
import ddlbench_tpu.models.seq2seq as js2s
import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.models.layers import apply_model as jax_apply_model
from ddlbench_tpu.models.layers import init_model

import ddlbench_tpu_torch.models.seq2seq as s2s
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.serve.engine import ServeEngine
from ddlbench_tpu_torch.serve.workload import ServeRequest

pytestmark = pytest.mark.torchport

TINY = dict(d_model=32, n_layers=2, n_heads=4)
T_TOTAL, SRC, VOCAB = 16, 8, 64
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _xla_backend():
    # the reference's tests run its decoders on the xla attention; the
    # port's CPU attention is its plain path either way
    js2s._VARIANTS["seq2seq_t"] = TINY
    s2s._VARIANTS["seq2seq_t"] = TINY
    jtr._VARIANTS["transformer_t"] = TINY
    jtr.set_attention_backend("xla")
    yield
    jtr.set_attention_backend("auto")


def _src(key, shape):
    """A prompt drawn as the reference tests draw it."""
    return np.asarray(jax.random.randint(jax.random.key(key), shape, 0,
                                         VOCAB, jnp.int32))


def _t(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.fixture(scope="module")
def mt():
    """(jax model, params, state, port model), seq2seq_t from key 0."""
    jm = js2s.build_seq2seq("seq2seq_t", (T_TOTAL,), VOCAB, SRC)
    params, state, _ = init_model(jm, jax.random.key(0))
    tm = s2s.build_seq2seq("seq2seq_t", (T_TOTAL,), VOCAB, SRC)
    from_jax_params(tm, jax.device_get(params))
    return jm, params, state, tm


@pytest.fixture(scope="module")
def lm():
    """(jax model, params, state, port model), transformer_t from key 3."""
    jm = jtr.build_transformer("transformer_t", (T_TOTAL,), VOCAB)
    params, state, _ = init_model(jm, jax.random.key(3))
    tm = ttr.build_transformer("transformer_t", (T_TOTAL,), VOCAB)
    from_jax_params(tm, jax.device_get(params))
    return jm, params, state, tm


def test_supports_cache(mt, lm):
    assert dec.supports_cache(mt[3]) and dec.supports_cache(lm[3])
    assert dec.supports_paged(mt[3]) and dec.supports_paged(lm[3])
    assert not dec.supports_cache(get_model("resnet18", "mnist"))


def test_prefill_matches_jax_and_full_forward(mt):
    jm, params, state, tm = mt
    src = _src(1, (2, SRC))
    caches = jdec.init_caches(jm, params, 2, T_TOTAL, jnp.float32)
    want, _ = jdec.prefill(jm, params, state, caches, jnp.asarray(src))
    caches = dec.init_caches(tm, 2, T_TOTAL, torch.float32)
    with torch.no_grad():
        got, caches = dec.prefill(tm, caches, _t(src))
        full = tm(_t(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the blocks recorded the prompt's K/V at positions [0, SRC)
    assert caches[0] is None and caches[-1] is None
    assert caches[1]["k"][:, :, SRC:].abs().max() == 0
    assert caches[1]["k"][:, :, :SRC].abs().max() > 0


def test_decode_one_matches_jax(mt):
    """Prefill SRC tokens, then decode 3 one at a time: each step's logits
    against JAX's decode_one and against the port's full forward over the
    zero-padded prefix."""
    jm, params, state, tm = mt
    x = _src(2, (2, SRC + 3))
    jc = jdec.init_caches(jm, params, 2, T_TOTAL, jnp.float32)
    jl, jc = jdec.prefill(jm, params, state, jc, jnp.asarray(x[:, :SRC]))
    tc = dec.init_caches(tm, 2, T_TOTAL, torch.float32)
    with torch.no_grad():
        tl, tc = dec.prefill(tm, tc, _t(x[:, :SRC]))
        pad = np.zeros((2, T_TOTAL - (SRC + 3)), np.int64)
        full = tm(_t(np.concatenate([x, pad], axis=1)))
    want, got = [jl[:, -1]], [tl[:, -1]]
    for t in range(SRC, SRC + 3):
        jl, jc = jdec.decode_one(jm, params, state, jc,
                                 jnp.asarray(x[:, t:t + 1]), t)
        with torch.no_grad():
            tl, tc = dec.decode_one(tm, tc, _t(x[:, t:t + 1]), t)
        want.append(jl[:, 0])
        got.append(tl[:, 0])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(g.numpy(), full[:, SRC - 1 + i].numpy(),
                                   rtol=2e-5, atol=2e-5)


_JAX = {}


def _jax_once(key, fn):
    """Each JAX decode loop compiles slowly: run each once per module."""
    if key not in _JAX:
        _JAX[key] = jax.device_get(fn())
    return _JAX[key]


def test_cached_greedy_equals_jax(mt):
    jm, params, state, tm = mt
    src = _src(4, (3, SRC))
    want = _jax_once("greedy", lambda: js2s.greedy_decode(
        jm, params, state, jnp.asarray(src), T_TOTAL))
    for use_cache in (True, False):
        got = s2s.greedy_decode(tm, _t(src), T_TOTAL, use_cache=use_cache)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cached_beam_equals_jax(mt):
    jm, params, state, tm = mt
    src = _src(5, (2, SRC))
    want_x, want_s = _jax_once("beam", lambda: js2s.beam_search_decode(
        jm, params, state, jnp.asarray(src), T_TOTAL, beam=3))
    for use_cache in (True, False):
        got_x, got_s = s2s.beam_search_decode(tm, _t(src), T_TOTAL, beam=3,
                                              use_cache=use_cache)
        np.testing.assert_array_equal(got_x.numpy(), want_x)
        np.testing.assert_allclose(got_s.numpy(), want_s, **TOL)


def test_causal_lm_cached_greedy(lm):
    """The cached decoder also serves causal LMs (any prompt length):
    against JAX's and against a full-forward greedy."""
    jm, params, state, tm = lm
    prompt = _src(6, (2, 5))
    want = _jax_once("causal", lambda: jdec.greedy_decode(
        jm, params, state, jnp.asarray(prompt), T_TOTAL))
    got = dec.greedy_decode(tm, _t(prompt), T_TOTAL)
    assert got.shape == (2, T_TOTAL)
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.zeros(2, T_TOTAL, dtype=torch.long)
    x[:, :5] = _t(prompt)
    with torch.no_grad():
        for t in range(5, T_TOTAL):
            x[:, t] = tm(x)[:, t - 1].argmax(-1)
    np.testing.assert_array_equal(got.numpy(), x.numpy())


def test_unsupported_model_raises():
    cnn = get_model("resnet18", "mnist")
    with pytest.raises(NotImplementedError, match="without cached-decode"):
        dec.greedy_decode(cnn, torch.zeros(1, 8, dtype=torch.long), 16)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_cache_refused(mt, paged):
    """The reference's caches have no scale sidecars, so an int8 cache
    there truncates K/V (ROADMAP C.10); the port refuses it."""
    tm = mt[3]
    src = torch.zeros(1, SRC, dtype=torch.long)
    with pytest.raises(ValueError, match="C.10"):
        dec.greedy_decode(tm, src, T_TOTAL, dtype=torch.int8, paged=paged)
    with pytest.raises(ValueError, match="C.10"):
        dec.beam_search_decode(tm, src, T_TOTAL, dtype=torch.int8,
                               paged=paged)


def test_greedy_and_beam_decode(mt):
    """tests/test_seq2seq.py's decode case: the source kept, reruns
    deterministic, beam 1 equal to greedy with a finite score, and beam 4's
    length-normalised score no lower than beam 1's."""
    tm = mt[3]
    src = _t(_src(2, (2, SRC)))
    out = s2s.greedy_decode(tm, src, T_TOTAL)
    assert out.shape == (2, T_TOTAL)
    assert torch.equal(out[:, :SRC], src)
    assert torch.equal(s2s.greedy_decode(tm, src, T_TOTAL), out)
    b1, score1 = s2s.beam_search_decode(tm, src, T_TOTAL, beam=1)
    assert torch.equal(b1, out)
    assert torch.isfinite(score1).all()
    _, score4 = s2s.beam_search_decode(tm, src, T_TOTAL, beam=4)
    assert (score4 >= score1 - 1e-4).all()


def test_decode_rejects_wrong_src_width(mt, lm):
    tm = mt[3]
    bad = torch.zeros(2, SRC - 2, dtype=torch.long)
    with pytest.raises(ValueError, match="src_len"):
        s2s.greedy_decode(tm, bad, T_TOTAL)
    with pytest.raises(ValueError, match="src_len"):
        s2s.beam_search_decode(tm, bad, T_TOTAL)
    with pytest.raises(ValueError, match="src must be"):
        dec.greedy_decode(tm, bad, T_TOTAL)
    with pytest.raises(ValueError, match="not a seq2seq"):
        s2s.greedy_decode(lm[3], torch.zeros(1, 8, dtype=torch.long), 16)


@pytest.mark.parametrize("bad", [SRC, T_TOTAL + 1])
def test_decode_rejects_bad_total_len(mt, bad):
    src = torch.zeros(1, SRC, dtype=torch.long)
    with pytest.raises(ValueError, match="total_len"):
        s2s.greedy_decode(mt[3], src, bad)
    with pytest.raises(ValueError, match="total_len"):
        dec.beam_search_decode(mt[3], src, bad, paged=True)


def test_engine_streams_equal_greedy_decode():
    """The serving oracle (tests/test_serve.py): the port's engine, serving
    transformer_t greedily through chunked admission, emits for each
    request the stream of the port's own greedy_decode on its prompt."""
    spec_T = 32
    tm = ttr.build_transformer("transformer_t", (spec_T,), VOCAB, seed=0)
    eng = ServeEngine(tm, ServeConfig(max_batch=2, pool_pages=17, page=4,
                                      max_len=16, prefill_chunk=4),
                      torch.device("cpu"))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, size=(s,)).astype(np.int32)
               for s in (3, 9, 6)]
    for i, p in enumerate(prompts):
        eng.submit(ServeRequest(rid=i, prompt=p, max_new=5, arrival=0.0))
    now = 0.0
    while eng.has_work():
        now += eng.step(now).cost
    got = {f["rid"]: f["tokens"] for f in eng.finished}
    for i, p in enumerate(prompts):
        for paged in (False, True):
            want = dec.greedy_decode(tm, _t(p[None]), len(p) + 5,
                                     paged=paged)
            assert got[i] == want[0, len(p):].tolist(), (i, paged)


def test_full_forward_decode_matches_jax_logits(mt):
    """The full-forward loop's oracle: the port's forward logits over a
    decoded stream against the reference's apply."""
    jm, params, state, tm = mt
    x = _src(9, (2, T_TOTAL))
    want, _ = jax_apply_model(jm, params, state, jnp.asarray(x), False)
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
