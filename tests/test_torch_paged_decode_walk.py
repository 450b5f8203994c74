"""The paged decode kernel's walk (``paged_decode_ring`` in
ddlbench_tpu_torch/ops/csrc/paged_attention.cu), emulated in torch on the
CPU and held against the JAX reference (ddlbench_tpu/ops/paged_decode.py):
its jnp oracle ``_paged_attention_ref`` and its Pallas kernel
``_paged_attn_kernel`` run in interpret mode.

The emulation follows the kernel's order of work, not its instructions:
one query per (row, head); the row's live pages (up to the query's page)
dealt round-robin to 8 warps; each warp walks its pages in 16-key chunks
with an online softmax of its own (masked keys at -1e30, weighing exactly
0); the warps' states merged in warp order (a warp with no page holds
m = -1e30, l = 0, acc = 0), the output acc / max(l, 1e-20). So it pins the
page split, the partial chunk of a page of 8 and the two chunks of a page
of 32, the stop at the query's page, and the merge, against the reference,
over float32, bfloat16 and int8 pools at float32 (max abs error 1e-5: only
the order of the sums differs). The kernel itself is held against the
port's plain version on the card (tests/test_torch_cuda_kernels.py,
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
WARPS, KEYS = 8, 16  # the kernel's constants
NEG = -1e30
ATOL = 1e-5


def decode_walk(q, cache, pos, npl, page):
    """The kernel's walk over q [rows, H, dh] float32 -> [rows, H, dh]."""
    rows, _, dh = q.shape
    tbl = cache["table"][:, :npl]
    kc = port._gather(cache, "pool_k", tbl).transpose(1, 2)  # [r, H, L, dh]
    vc = port._gather(cache, "pool_v", tbl).transpose(1, 2)
    pos = port._rows_vector(pos, rows, q.device).long()
    n_live = torch.clamp(pos // page + 1, max=npl)
    states = []
    for w in range(WARPS):
        m = torch.full((rows, H), NEG)
        l = torch.zeros(rows, H)
        acc = torch.zeros(rows, H, dh)
        for j in range(w, npl, WARPS):
            walked = (j < n_live)[:, None]  # rows walking page j
            for p0 in range(0, page, KEYS):
                keys = torch.arange(j * page + p0,
                                    j * page + min(page, p0 + KEYS))
                s = torch.einsum("rhd,rhkd->rhk", q,
                                 kc[:, :, keys]) / math.sqrt(dh)
                vis = (keys[None, :] <= pos[:, None])[:, None]  # [r, 1, k]
                s = torch.where(vis, s, torch.tensor(NEG))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(vis, torch.exp(s - m_new[..., None]),
                                torch.tensor(0.0))
                l_new = alpha * l + p.sum(-1)
                acc_new = acc * alpha[..., None] + torch.einsum(
                    "rhk,rhkd->rhd", p, vc[:, :, keys])
                m = torch.where(walked, m_new, m)
                l = torch.where(walked, l_new, l)
                acc = torch.where(walked[..., None], acc_new, acc)
        states.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in states]).amax(0)
    l_all = torch.zeros_like(m_all)
    od = torch.zeros(rows, H, dh)
    for m, l, acc in states:  # warp order
        f = torch.exp(m - m_all)
        l_all = l_all + f * l
        od = od + f[..., None] * acc
    return od / torch.clamp(l_all, min=1e-20)[..., None]


def _pools(seed, page, pool):
    """The same pools on both sides: float32 random rows; the same rows
    rounded to bfloat16 on each side (the same bits); or the int8 bytes
    and scales the JAX package's own quantising chunk write makes of them
    (layer seed 1), converted to torch."""
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, page, H, DH)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    if pool == "float32":
        jc = {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv)}
        tc = {"pool_k": torch.from_numpy(pk), "pool_v": torch.from_numpy(pv)}
    elif pool == "bfloat16":
        jc = {"pool_k": jnp.asarray(pk, jnp.bfloat16),
              "pool_v": jnp.asarray(pv, jnp.bfloat16)}
        tc = {"pool_k": torch.from_numpy(pk).bfloat16(),
              "pool_v": torch.from_numpy(pv).bfloat16()}
        for k in jc:
            assert np.array_equal(np.asarray(jc[k], np.float32),
                                  tc[k].float().numpy())
    else:
        init = ref.serve_pool_init(N_PAGES, page, H, DH, jnp.int8)
        n = N_PAGES * page
        init = ref.paged_table_chunk_write(
            {**init, "kv_seed": jnp.int32(1),
             "table": jnp.arange(N_PAGES, dtype=jnp.int32)[None]},
            jnp.asarray(pk.reshape(1, n, H, DH)),
            jnp.asarray(pv.reshape(1, n, H, DH)), 0, page)
        jc = {k: init[k] for k in ("pool_k", "pool_v", "scale_k", "scale_v")}
        tc = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in jc.items()}
    # each row's table drawn with replacement (rows may share slots), one
    # column past the live pages
    table = rng.integers(1, N_PAGES, (ROWS, 17)).astype(np.int32)
    jc["table"] = jnp.asarray(table)
    tc["table"] = torch.from_numpy(table.copy())
    return jc, tc


def _positions(seed, npl, page, key):
    """Row 0 on the last live page, row 1 on page 0 (warps 1-7 walk
    nothing), row 2 on a random live page; each on the page's first or
    last key."""
    pages = np.array([npl - 1, 0,
                      np.random.default_rng(seed).integers(0, npl)])
    return (pages * page + (0 if key == "first" else page - 1)).astype(
        np.int32)


@pytest.mark.parametrize("key", ["first", "last"])
@pytest.mark.parametrize("npl", [1, 9, 16])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_decode_walk_matches_jax(pool, page, npl, key):
    jc, tc = _pools(page + npl, page, pool)
    q = np.random.default_rng(npl).standard_normal(
        (ROWS, H, DH)).astype(np.float32)
    pos = _positions(page * npl, npl, page, key)
    want_ref = np.asarray(ref._paged_attention_ref(
        jnp.asarray(q), jc, jnp.asarray(pos), npl, page))
    want_kernel = np.asarray(ref.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(pos), npl, page=page,
        interpret=True, use_kernel=True))
    got = decode_walk(torch.from_numpy(q), tc, torch.from_numpy(pos), npl,
                      page).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want_ref).max() <= ATOL
    assert np.abs(got - want_kernel).max() <= ATOL


def test_warps_without_pages_add_nothing():
    """Every row on page 0 of 16 live pages: warps 1-7 walk nothing and
    merge as m = -1e30, l = 0; the result is the one page's softmax, as the
    plain version computes it."""
    _, tc = _pools(5, 16, "float32")
    q = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (ROWS, H, DH)).astype(np.float32))
    pos = torch.tensor([0, 7, 15], dtype=torch.int32)
    got = decode_walk(q, tc, pos, 16, 16)
    want = port._paged_attention_ref(q, tc, pos, 16, 16)
    assert (got - want).abs().max().item() <= ATOL
