"""The paged chunk kernel's walk (``paged_chunk_tiled`` in
ddlbench_tpu_torch/ops/csrc/paged_attention.cu), emulated in torch on the
CPU and held against the JAX reference (ddlbench_tpu/ops/paged_decode.py):
its jnp oracle ``_paged_chunk_attention_ref`` and its Pallas kernel
``_paged_chunk_attn_kernel`` run in interpret mode.

The emulation follows the kernel's order of work, not its instructions:
16-query tiles; each tile's live pages (up to its last query's page) dealt
round-robin to 8 warps; each warp walks its pages in 16-key chunks with an
online softmax of its own (masked keys at -1e30, weighing exactly 0); the
warps' states merged in warp order (a warp with no page holds m = -1e30,
l = 0, acc = 0), the output acc / max(l, 1e-20). So it pins the tiling, the
page split, the partial chunks of pages 8 and 32 apart from 16, and the
merge, against the reference, at float32 (max abs error 1e-5: only the
order of the sums differs). The kernel itself is held against the port's
plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.ops.paged_decode as ref
import ddlbench_tpu_torch.ops.paged_decode as port

pytestmark = pytest.mark.torchport

ROWS, H, DH, N_PAGES = 3, 2, 64, 40
TABLE_COLS = 10  # the deepest case's 9 live pages, and a column past them
TILE_Q, WARPS, KEYS = 16, 8, 16  # the kernel's constants
NEG = -1e30
ATOL = 1e-5


def tiled_walk(q, cache, start, npl, page):
    """The kernel's walk over q [rows, H, C, dh] float32 -> [rows, H, C,
    dh]."""
    rows, _, C, dh = q.shape
    tbl = cache["table"][:, :npl]
    kc = port._gather(cache, "pool_k", tbl).transpose(1, 2)  # [r, H, L, dh]
    vc = port._gather(cache, "pool_v", tbl).transpose(1, 2)
    start = port._rows_vector(start, rows, q.device).long()
    out = torch.empty_like(q)
    for c0 in range(0, C, TILE_Q):
        nq = min(TILE_Q, C - c0)
        qt = q[:, :, c0:c0 + nq]
        qpos = start[:, None] + c0 + torch.arange(nq)  # [rows, nq]
        n_live = torch.clamp((start + c0 + nq - 1) // page + 1, max=npl)
        states = []
        for w in range(WARPS):
            m = torch.full((rows, H, nq), NEG)
            l = torch.zeros(rows, H, nq)
            acc = torch.zeros(rows, H, nq, dh)
            for j in range(w, npl, WARPS):
                walked = (j < n_live)[:, None, None]  # rows walking page j
                for p0 in range(0, page, KEYS):
                    keys = torch.arange(j * page + p0,
                                        j * page + min(page, p0 + KEYS))
                    s = torch.einsum("rhqd,rhkd->rhqk", qt,
                                     kc[:, :, keys]) / math.sqrt(dh)
                    vis = (keys[None, None, :] <= qpos[:, :, None])[:, None]
                    s = torch.where(vis, s, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(s - m_new[..., None]),
                                    torch.tensor(0.0))
                    l_new = alpha * l + p.sum(-1)
                    acc_new = acc * alpha[..., None] + torch.einsum(
                        "rhqk,rhkd->rhqd", p, vc[:, :, keys])
                    m = torch.where(walked, m_new, m)
                    l = torch.where(walked, l_new, l)
                    acc = torch.where(walked[..., None], acc_new, acc)
            states.append((m, l, acc))
        m_all = torch.stack([m for m, _, _ in states]).amax(0)
        l_all = torch.zeros_like(m_all)
        od = torch.zeros(rows, H, nq, dh)
        for m, l, acc in states:  # warp order
            f = torch.exp(m - m_all)
            l_all = l_all + f * l
            od = od + f[..., None] * acc
        out[:, :, c0:c0 + nq] = od / torch.clamp(l_all, min=1e-20)[..., None]
    return out


def _pools(seed, page, quant):
    """The same pools on both sides: float32 random rows, or the int8
    bytes and scales the JAX package's own quantising chunk write makes of
    them (layer seed 1), converted to torch."""
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, page, H, DH)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    if not quant:
        arrays = {"pool_k": pk, "pool_v": pv}
    else:
        pool = ref.serve_pool_init(N_PAGES, page, H, DH, jnp.int8)
        n = N_PAGES * page
        pool = ref.paged_table_chunk_write(
            {**pool, "kv_seed": jnp.int32(1),
             "table": jnp.arange(N_PAGES, dtype=jnp.int32)[None]},
            jnp.asarray(pk.reshape(1, n, H, DH)),
            jnp.asarray(pv.reshape(1, n, H, DH)), 0, page)
        arrays = {k: np.asarray(pool[k]) for k in ("pool_k", "pool_v",
                                                    "scale_k", "scale_v")}
    # each row's table drawn with replacement (rows may share slots)
    table = rng.integers(1, N_PAGES, (ROWS, TABLE_COLS)).astype(np.int32)
    jc = {k: jnp.asarray(v) for k, v in arrays.items()}
    jc["table"] = jnp.asarray(table)
    tc = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tc["table"] = torch.from_numpy(table.copy())
    return jc, tc


def _starts(seed, C, npl, page, aligned):
    """Per-row chunk starts whose span fits the live pages where it can
    (a chunk longer than the live span starts at 0: its last queries see
    every live key)."""
    rng = np.random.default_rng(seed)
    room = npl * page - C
    if room < 0:
        return np.zeros(ROWS, np.int32)
    if aligned:
        return (rng.integers(0, room // page + 1, ROWS) * page).astype(
            np.int32)
    return rng.integers(0, room + 1, ROWS).astype(np.int32)


# (C, npl, page, page-aligned starts)
CASES = [(1, 1, 16, False), (1, 9, 16, False), (1, 3, 32, True),
         (5, 3, 16, False), (5, 9, 32, False), (5, 1, 16, True),
         (16, 9, 16, True), (16, 3, 32, False), (16, 1, 16, True),
         (17, 9, 16, False), (17, 3, 16, True), (17, 1, 32, False),
         (33, 9, 16, True), (33, 3, 32, False), (33, 9, 32, True),
         (33, 1, 16, False)]


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("C,npl,page,aligned", CASES)
def test_tiled_walk_matches_jax(C, npl, page, aligned, quant):
    jc, tc = _pools(C + 10 * npl + page, page, quant)
    q = np.random.default_rng(C + npl).standard_normal(
        (ROWS, H, C, DH)).astype(np.float32)
    start = _starts(npl * page + C, C, npl, page, aligned)
    want_ref = np.asarray(ref._paged_chunk_attention_ref(
        jnp.asarray(q), jc, jnp.asarray(start), npl, page))
    want_kernel = np.asarray(ref.paged_chunk_attention(
        jnp.asarray(q), jc, jnp.asarray(start), npl, page=page,
        interpret=True, use_kernel=True))
    got = tiled_walk(torch.from_numpy(q), tc, torch.from_numpy(start), npl,
                     page).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want_ref).max() <= ATOL
    assert np.abs(got - want_kernel).max() <= ATOL


def test_warps_without_pages_add_nothing():
    """One live page: warps 1-7 walk nothing and merge as m = -1e30,
    l = 0; the result is the one page's softmax, as the plain version
    computes it."""
    jc, tc = _pools(5, 16, False)
    q = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (ROWS, H, 16, DH)).astype(np.float32))
    got = tiled_walk(q, tc, 0, 1, 16)
    want = port._paged_chunk_attention_ref(q, tc, 0, 1, 16)
    assert (got - want).abs().max().item() <= ATOL
