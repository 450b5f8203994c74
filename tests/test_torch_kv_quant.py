"""The port's int8 KV pool (ddlbench_tpu_torch/ops/threefry.py and the int8
half of ops/paged_decode.py) held against the JAX reference
(ddlbench_tpu/ops/paged_decode.py) on the CPU.

Bitwise: the threefry uniforms against ``jax.random.uniform``; the int8
bytes and scale bits of ``_kv_quantize``, of the three table writes
(page-aligned and unaligned, with overflow to the scratch slot) and of the
page copy; the span write against the chunk write and single writes; the
engine's cached rounding table against the on-the-fly hash. Within rtol
and atol 1e-5: the int8 plain attention versions against the reference's
oracles and its Pallas kernels run with ``interpret=True``. With the
reference's weights carried over, the port's engine at int8 must emit token
streams and ``token_times`` IDENTICAL to the JAX engine's, with an equal
``stats_summary()``, through chunked and unchunked admission and
eviction/recompute. The CUDA kernels' int8 branches are held against these
plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve import CONFIGS
from test_torch_serve_prefix import port_lm, run_both  # noqa: F401
from tiny_models import TINY_LM

import ddlbench_tpu.ops.paged_decode as ref
import ddlbench_tpu_torch.ops.paged_decode as port
from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.ops import threefry
from ddlbench_tpu_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.torchport

H, DH, PAGE, N_PAGES = 2, 8, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
SLOT_KEYS = ("pool_k", "pool_v", "scale_k", "scale_v")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bits(x):
    """A float32 array's bits (bitwise equality that also pins -0.0)."""
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("tag", [0, 1])
def test_uniform_matches_jax_random(seed, tag):
    base = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    positions = [0, 5, 255, 1000, 70_000]
    got = threefry.uniform(
        threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), tag),
                         torch.tensor(positions)), (H, DH)).numpy()
    for i, p in enumerate(positions):
        want = jax.random.uniform(jax.random.fold_in(base, p), (H, DH),
                                  jnp.float32)
        np.testing.assert_array_equal(_bits(got[i]), _bits(want))
    # a scalar key gives the bare shape
    one = threefry.uniform(threefry.prng_key(seed), (3, 5))
    np.testing.assert_array_equal(
        _bits(one), _bits(jax.random.uniform(jax.random.PRNGKey(seed),
                                             (3, 5))))


@pytest.mark.parametrize("kv_seed,tag", [(0, 0), (1, 1), (5, 0)])
def test_kv_quantize_bytes_and_scales_match_jax(kv_seed, tag):
    x = _rand(3, 3, 5, H, DH) * 3.0
    x[1, 2] = 0.0  # an all-zero row: scale 1, bytes 0
    pos = (np.arange(15, dtype=np.int32).reshape(3, 5) * 7) % 40
    wq, ws = ref._kv_quantize(jnp.asarray(x), jnp.asarray(pos), kv_seed, tag)
    gq, gs = port._kv_quantize(torch.from_numpy(x), torch.from_numpy(pos),
                               kv_seed, tag)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    assert gs[1, 2] == 1.0 and not gq[1, 2].any()


def test_cached_rounding_table_equals_the_hash():
    """The engine's per-layer table [2, n_pos, H, dh] gives the bytes the
    per-write hash gives, bit for bit."""
    x = torch.from_numpy(_rand(4, 2, 6, H, DH))
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [17, 18, 19, 20, 21, 22]])
    table = port.kv_u_table(3, 24, H, DH, CPU)
    assert table.shape == (2, 24, H, DH)
    for tag in (0, 1):
        a = port._kv_quantize(x, pos, 3, tag)
        b = port._kv_quantize(x, pos, 3, tag, table[tag])
        for u, w in zip(a, b):
            assert torch.equal(u, w)


def _pools(seed, rows, npl, kv_seed=1, filled=True):
    """The same int8 pool on both sides (random bytes and scales, as a
    pool holds after traffic) and a table of shuffled distinct slots."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(np.arange(1, N_PAGES))[:rows * npl]
    table = slots.reshape(rows, npl).astype(np.int32)
    arrays = {
        "pool_k": rng.integers(-127, 128, (N_PAGES, PAGE, H, DH)),
        "pool_v": rng.integers(-127, 128, (N_PAGES, PAGE, H, DH)),
        "scale_k": rng.uniform(0.01, 0.05, (N_PAGES, PAGE)),
        "scale_v": rng.uniform(0.01, 0.05, (N_PAGES, PAGE)),
    }
    if not filled:
        arrays = {k: np.zeros_like(v) for k, v in arrays.items()}
    arrays = {k: v.astype(np.int8 if k.startswith("pool") else np.float32)
              for k, v in arrays.items()}
    jc = {k: jnp.asarray(v) for k, v in arrays.items()}
    jc.update(table=jnp.asarray(table), kv_seed=jnp.int32(kv_seed))
    tc = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tc.update(table=torch.from_numpy(table.copy()), kv_seed=kv_seed)
    return jc, tc


def _assert_pools_equal(tc, jc):
    for key in SLOT_KEYS:
        got, want = tc[key].numpy(), np.asarray(jc[key])
        if key.startswith("scale"):
            got, want = _bits(got), _bits(want)
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("pos", [5, (0, 7, 13)])
def test_int8_table_write_matches_jax(pos):
    jc, tc = _pools(7, 3, 4)
    k1, v1 = _rand(8, 3, 1, H, DH), _rand(9, 3, 1, H, DH)
    pos_np = np.asarray(pos, np.int32)
    want = ref.paged_table_write(jc, jnp.asarray(k1), jnp.asarray(v1),
                                 jnp.asarray(pos_np), PAGE)
    port.paged_table_write(tc, torch.from_numpy(k1), torch.from_numpy(v1),
                           torch.from_numpy(pos_np), PAGE)
    _assert_pools_equal(tc, want)


@pytest.mark.parametrize("start,C,npl", [(0, 4, 3), (4, 8, 3), (8, 8, 3)])
def test_int8_chunk_write_matches_jax(start, C, npl):
    """(8, 8, 3): the padded tail page runs past the table and lands on
    the scratch slot, quantised at its own positions."""
    jc, tc = _pools(10, 1, npl)
    k, v = _rand(11, 1, C, H, DH), _rand(12, 1, C, H, DH)
    want = ref.paged_table_chunk_write(jc, jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(start), PAGE)
    port.paged_table_chunk_write(tc, torch.from_numpy(k),
                                 torch.from_numpy(v), start, PAGE)
    _assert_pools_equal(tc, want)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("pos0,W", [
    ((0, 4), 4),  # page-aligned
    ((5, 2), 3),  # unaligned, crossing a page
    ((9, 10), 5),  # unaligned; the tail runs past the 3-page table
])
def test_span_write_matches_jax(dtype, pos0, W):
    npl = 3
    jc, tc = _pools(13, 2, npl)
    if dtype == "float32":
        jc = {"pool_k": jnp.asarray(_rand(14, N_PAGES, PAGE, H, DH)),
              "pool_v": jnp.asarray(_rand(15, N_PAGES, PAGE, H, DH)),
              "table": jc["table"]}
        tc = {"pool_k": torch.from_numpy(np.asarray(jc["pool_k"]).copy()),
              "pool_v": torch.from_numpy(np.asarray(jc["pool_v"]).copy()),
              "table": tc["table"]}
    k, v = _rand(16, 2, W, H, DH), _rand(17, 2, W, H, DH)
    p0 = np.asarray(pos0, np.int32)
    want = ref.paged_table_span_write(jc, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(p0), PAGE)
    port.paged_table_span_write(tc, torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(p0),
                                PAGE)
    for key in SLOT_KEYS:
        if key in tc:
            np.testing.assert_array_equal(
                tc[key].numpy().view(np.uint8),
                np.asarray(want[key]).view(np.uint8), err_msg=key)
    if max(pos0) + W > npl * PAGE:  # the overflow went to scratch
        assert tc["pool_k"][port.SCRATCH_SLOT].any()


def test_span_write_equals_chunk_and_single_writes():
    """Quantised bytes depend on (values, position) only: an aligned span
    write equals the chunk write, and an unaligned span [5, 8) equals
    single writes at 5, 6, 7 (the reference's pin, on the port)."""
    k = torch.from_numpy(_rand(18, 2, 3 * PAGE, H, DH))
    v = torch.from_numpy(_rand(19, 2, 3 * PAGE, H, DH))
    _, chunked = _pools(20, 2, 3, filled=False)
    _, spanned = _pools(20, 2, 3, filled=False)
    port.paged_table_chunk_write(chunked, k, v, 0, PAGE)
    port.paged_table_span_write(spanned, k, v, torch.zeros(2, dtype=torch
                                                           .int32), PAGE)
    for key in SLOT_KEYS:
        assert torch.equal(chunked[key], spanned[key]), key
    port.paged_table_span_write(spanned, k[:, 5:8], v[:, 5:8],
                                torch.full((2,), 5, dtype=torch.int32), PAGE)
    for t in range(5, 8):
        port.paged_table_write(chunked, k[:, t:t + 1], v[:, t:t + 1],
                               torch.full((2,), t, dtype=torch.int32), PAGE)
    for key in SLOT_KEYS:
        assert torch.equal(chunked[key], spanned[key]), key


def test_serve_page_copy_matches_jax():
    jc, tc = _pools(21, 2, 3)
    want = ref.serve_page_copy(jc, jnp.int32(3), jnp.int32(6))
    out = port.serve_page_copy(tc, 3, 6)
    assert out is tc and out["kv_seed"] == 1  # in place; the seed stays
    _assert_pools_equal(tc, want)
    f32 = {"pool_k": torch.from_numpy(_rand(22, 8, PAGE, H, DH)),
           "pool_v": torch.from_numpy(_rand(23, 8, PAGE, H, DH))}
    before = {k: t.clone() for k, t in f32.items()}
    port.serve_page_copy(f32, 2, 5)
    for key, t in f32.items():
        assert torch.equal(t[5], before[key][2])
        keep = [i for i in range(8) if i != 5]
        assert torch.equal(t[keep], before[key][keep])


@pytest.mark.parametrize("pos,npl", [
    (3, 1), (11, 3), ((0, 5, 9), 3), ((2, 3, 1), 1), ((4, 7, 0), 2),
])
def test_int8_paged_attention_matches_jax(pos, npl):
    jc, tc = _pools(24, 3, npl)
    q = _rand(25, 3, H, DH)
    p = np.asarray(pos, np.int32)
    want_ref = ref._paged_attention_ref(jnp.asarray(q), jc, jnp.asarray(p),
                                        npl, PAGE)
    want_kernel = ref.paged_attention(jnp.asarray(q), jc, jnp.asarray(p),
                                      npl, page=PAGE, interpret=True,
                                      use_kernel=True)
    got = port.paged_attention(torch.from_numpy(q), tc, torch.from_numpy(p),
                               npl, PAGE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)


@pytest.mark.parametrize("start,npl,C", [
    (0, 1, 4), (4, 3, 8), ((0, 4, 8), 3, 4),
    ((5, 2, 9), 3, 3),  # the verify shape: per-row unaligned starts
])
def test_int8_paged_chunk_attention_matches_jax(start, npl, C):
    jc, tc = _pools(26, 3, npl)
    q = _rand(27, 3, H, C, DH)
    s = np.asarray(start, np.int32)
    want_ref = ref._paged_chunk_attention_ref(jnp.asarray(q), jc,
                                              jnp.asarray(s), npl, PAGE)
    want_kernel = ref.paged_chunk_attention(jnp.asarray(q), jc,
                                            jnp.asarray(s), npl, page=PAGE,
                                            interpret=True, use_kernel=True)
    got = port.paged_chunk_attention(torch.from_numpy(q), tc,
                                     torch.from_numpy(s), npl, PAGE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)


def test_int8_plain_versions_read_dequantised_pages():
    """The plain versions over an int8 pool equal them over the float32
    pool that pool dequantises to (int8 * scale per position row)."""
    _, tc = _pools(28, 2, 3)
    dq = {"table": tc["table"]}
    for name in ("k", "v"):
        dq["pool_" + name] = (tc["pool_" + name].float()
                              * tc["scale_" + name][..., None, None])
    q = torch.from_numpy(_rand(29, 2, H, DH))
    pos = torch.tensor([6, 11], dtype=torch.int32)
    assert torch.equal(port._paged_attention_ref(q, tc, pos, 3, PAGE),
                       port._paged_attention_ref(q, dq, pos, 3, PAGE))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_engine_streams_identical_to_jax(serve_factory, port_lm, name):
    kw, seed, lens, max_new = CONFIGS[name]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, TINY_LM.num_classes, size=(s,)) for s in lens]
    _, teng = run_both(serve_factory, port_lm, dict(kw, kv_dtype="int8"),
                       prompts, max_new)
    s = teng.stats_summary()
    f32 = ServeEngine(port_lm, ServeConfig(**kw), CPU).stats_summary()
    assert s["pool_bytes"] * 4 == f32["pool_bytes"]
    assert s["bytes_per_page"] * 4 == f32["bytes_per_page"]
    if name == "eviction":
        assert s["evicted"] > 0
