"""The port's paged attention (ddlbench_tpu_torch/ops/paged_decode.py)
held against the JAX reference (ddlbench_tpu/ops/paged_decode.py).

On the CPU the port's wrappers take their plain versions, so these pins
hold the plain versions against the reference's jnp oracles AND against the
reference's Pallas kernels run in interpret mode (as
tests/test_paged_decode.py runs them), through shuffled serving tables, at
f32 atol 1e-5 (the two sides reduce in different orders). The table writes
must leave pools identical to the reference's, bit for bit. The hand-written
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda_kernels.py, and chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.ops.paged_decode as ref
import ddlbench_tpu_torch.ops.paged_decode as port

pytestmark = pytest.mark.torchport

H, DH, PAGE, N_PAGES = 2, 8, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _pool_and_table(seed, rows, npl, n_pages=N_PAGES, dh=DH):
    """Random pools and a table of shuffled distinct non-scratch slots —
    the free-list layout the serving engine produces."""
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((n_pages, PAGE, H, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, PAGE, H, dh)).astype(np.float32)
    slots = rng.permutation(np.arange(1, n_pages))[:rows * npl]
    table = slots.reshape(rows, npl).astype(np.int32)
    return pk, pv, table


def _jax_cache(pk, pv, table):
    return {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv),
            "table": jnp.asarray(table)}


def _torch_cache(pk, pv, table):
    return {"pool_k": torch.from_numpy(pk.copy()),
            "pool_v": torch.from_numpy(pv.copy()),
            "table": torch.from_numpy(table.copy())}


@pytest.mark.parametrize("pos,npl", [
    (3, 1), (6, 2), (11, 3),  # one position for every row
    ((0, 5, 9), 3), ((2, 3, 1), 1), ((4, 7, 0), 2),  # per-row positions
])
def test_paged_attention_matches_jax(pos, npl):
    rows = 3
    pk, pv, table = _pool_and_table(1, rows, npl)
    q = np.random.default_rng(2).standard_normal(
        (rows, H, DH)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    jc = _jax_cache(pk, pv, table)
    want_ref = ref._paged_attention_ref(jnp.asarray(q), jc,
                                        jnp.asarray(pos_np), npl, PAGE)
    want_kernel = ref.paged_attention(jnp.asarray(q), jc,
                                      jnp.asarray(pos_np), npl, page=PAGE,
                                      interpret=True, use_kernel=True)
    got = port.paged_attention(torch.from_numpy(q),
                               _torch_cache(pk, pv, table),
                               torch.from_numpy(pos_np), npl, PAGE)
    assert got.shape == (rows, H, DH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)


@pytest.mark.parametrize("start,npl,C", [
    (0, 1, 4), (4, 2, 4), (8, 3, 4), (0, 2, 8), (4, 3, 8),  # scalar start
    ((0, 4, 8), 3, 4), ((8, 0, 4), 3, 8),  # per-row starts
])
def test_paged_chunk_attention_matches_jax(start, npl, C):
    rows = 3
    pk, pv, table = _pool_and_table(3, rows, npl)
    q = np.random.default_rng(4).standard_normal(
        (rows, H, C, DH)).astype(np.float32)
    start_np = np.asarray(start, np.int32)
    jc = _jax_cache(pk, pv, table)
    want_ref = ref._paged_chunk_attention_ref(
        jnp.asarray(q), jc, jnp.asarray(start_np), npl, PAGE)
    want_kernel = ref.paged_chunk_attention(
        jnp.asarray(q), jc, jnp.asarray(start_np), npl, page=PAGE,
        interpret=True, use_kernel=True)
    got = port.paged_chunk_attention(torch.from_numpy(q),
                                     _torch_cache(pk, pv, table),
                                     torch.from_numpy(start_np), npl, PAGE)
    assert got.shape == (rows, H, C, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)


def test_inactive_rows_read_the_scratch_slot():
    """The engine routes inactive decode rows' table to slot 0 at pos 0:
    the attention must read the scratch page like any other (finite
    output equal to the reference's), never fault on it."""
    rows, npl = 2, 2
    pk, pv, table = _pool_and_table(5, rows, npl)
    table[1, :] = port.SCRATCH_SLOT
    q = np.random.default_rng(6).standard_normal(
        (rows, H, DH)).astype(np.float32)
    pos = np.array([6, 0], np.int32)
    want = ref._paged_attention_ref(jnp.asarray(q),
                                    _jax_cache(pk, pv, table),
                                    jnp.asarray(pos), npl, PAGE)
    got = port.paged_attention(torch.from_numpy(q),
                               _torch_cache(pk, pv, table),
                               torch.from_numpy(pos), npl, PAGE)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [5, (0, 7, 13)])
def test_paged_table_write_matches_jax(pos):
    rows, npl = 3, 4
    pk, pv, table = _pool_and_table(7, rows, npl)
    rng = np.random.default_rng(8)
    k1 = rng.standard_normal((rows, 1, H, DH)).astype(np.float32)
    v1 = rng.standard_normal((rows, 1, H, DH)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    want = ref.paged_table_write(_jax_cache(pk, pv, table), jnp.asarray(k1),
                                 jnp.asarray(v1), jnp.asarray(pos_np), PAGE)
    tc = _torch_cache(pk, pv, table)
    got = port.paged_table_write(tc, torch.from_numpy(k1),
                                 torch.from_numpy(v1),
                                 torch.from_numpy(pos_np), PAGE)
    assert got["pool_k"] is tc["pool_k"]  # written in place
    for name in ("pool_k", "pool_v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("start,C,npl", [
    (0, 4, 3), (4, 8, 3),
    # the chunk's padded tail page runs past the last table column: it
    # must land on the scratch slot, never clamp onto a live page (torch
    # slicing past the end would silently return fewer columns)
    (8, 8, 3),
])
def test_paged_table_chunk_write_matches_jax(start, C, npl):
    rows = 1
    pk, pv, table = _pool_and_table(9, rows, npl)
    rng = np.random.default_rng(10)
    k = rng.standard_normal((rows, C, H, DH)).astype(np.float32)
    v = rng.standard_normal((rows, C, H, DH)).astype(np.float32)
    want = ref.paged_table_chunk_write(_jax_cache(pk, pv, table),
                                       jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(start), PAGE)
    got = port.paged_table_chunk_write(_torch_cache(pk, pv, table),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), start, PAGE)
    for name in ("pool_k", "pool_v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    if start + C > npl * PAGE:  # the overflow page went to scratch
        np.testing.assert_array_equal(
            got["pool_k"][port.SCRATCH_SLOT].numpy(),
            k[0, npl * PAGE - start:].reshape(-1, PAGE, H, DH)[-1])


def test_pool_init_and_page_bytes():
    pool = port.serve_pool_init(5, PAGE, H, DH, torch.bfloat16,
                                torch.device("cpu"))
    assert pool["pool_k"].shape == (5, PAGE, H, DH)
    assert not pool["pool_v"].any()
    want = ref.pool_page_bytes(ref.serve_pool_init(5, PAGE, H, DH,
                                                   jnp.bfloat16))
    assert port.pool_page_bytes(pool) == want == 2 * PAGE * H * DH * 2
    # int8: the payload plus zeroed scale sidecars, and the payload bytes
    # only, as in the reference
    pool8 = port.serve_pool_init(5, PAGE, H, DH, torch.int8,
                                 torch.device("cpu"))
    ref8 = ref.serve_pool_init(5, PAGE, H, DH, jnp.int8)
    assert sorted(pool8) == sorted(ref8)
    for name in ref8:
        assert tuple(pool8[name].shape) == ref8[name].shape
        assert not pool8[name].any()
    assert pool8["scale_k"].dtype == torch.float32
    assert port.pool_page_bytes(pool8) == ref.pool_page_bytes(ref8) \
        == want // 2
    with pytest.raises(ValueError, match="int8"):
        port.serve_pool_init(5, PAGE, H, DH, torch.float16,
                             torch.device("cpu"))
