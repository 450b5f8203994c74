"""Shared paged KV pool for the serving engine, the row-owned beam cache,
and attention over both.

The port of ``ddlbench_tpu/ops/paged_decode.py``. The beam cache
(:func:`paged_cache_init`, :func:`paged_prefill_write`,
:func:`paged_decode_write`, :func:`paged_reorder`; pages of :data:`PAGE`)
is models/decode.py's: every row owns a stripe of slots, and a beam
reorder copies table pointers plus one partial page per row. Its layout
is the serving pool's, so the decode kernel walks it as it is. The
reference's ``live_pages`` context and kernel-style switch are trace-time
devices of JAX and Pallas; here the decode loop passes each step's live
page count (``pos // page + 1``) as ``npages_live``.

The serving cache is a POOL of fixed-size pages ``[n_pages, page, H, dh]``
per layer plus one int32 page TABLE ``[rows, npg]`` shared by every layer:
row r's
positions ``[j*page, (j+1)*page)`` live in pool slot ``table[r, j]``. Slots
are handed out per request by the host free list (serve/allocator.py); slot
0 is the SCRATCH page, where inactive rows' masked writes land.

Two attention functions walk only the live pages through the table, each
with a hand-written CUDA kernel (``csrc/paged_attention.cu``) and its plain
PyTorch version beside it:

* :func:`paged_attention` — one query per row at per-row position ``pos``
  (decode), replacing the TPU kernel ``_paged_attn_kernel``;
* :func:`paged_chunk_attention` — C chunk queries per row at absolute
  positions ``start + c`` (chunked prefill), replacing
  ``_paged_chunk_attn_kernel``.

A wrapper takes the plain version when its query lies on the CPU (the
tests); on a CUDA tensor it launches the kernel or raises. Each wrapper
counts its launches, over float32 and bfloat16 pools in ``launches`` and
over int8 pools in ``launches_int8``, so a run can show that the main path
went through the kernel. The kernels take head dim 64 only
(:func:`kernel_takes`); the serving passes call :func:`paged_attention_auto`
and :func:`paged_chunk_attention_auto`, which take the plain version for a
CUDA query the kernel refuses (the reference's paged ops take any head dim)
and count those calls in the wrapper's ``plain_launches``.

An int8 pool (the reference's EQuARX-lite pages) stores ``pool_k``/
``pool_v`` as int8 plus a scale SIDECAR ``scale_k``/``scale_v`` [n_pages,
page] float32: one absmax/127 scale per written position row, so a page's
scales travel with it through :func:`serve_page_copy` and prefix binds.
Rows quantise at the write boundary with unbiased stochastic rounding whose
uniforms are the reference's own ``jax.random`` bits (ops/threefry.py),
keyed by (layer seed ``kv_seed``, k/v tag, stream position): the port
writes the reference's int8 bytes exactly, and a recomputed page equals the
evicted one. The bits do not depend on the values, so the engine computes
them once into a per-layer table ``kv_u`` [2, n_pos, H, dh] instead of
hashing at every write. The attention kernels dequantise in the page walk
(``int8 * scale`` per key and value row); the plain versions dequantise in
:func:`_gather`. ``pool_page_bytes`` counts the payload only, so an int8
pool is exactly a quarter of a float32 one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.ops import threefry

NEG_INF = -1e30
SCRATCH_SLOT = 0
# positions per page of the beam cache; module-level so tests can shrink it
# (every beam-cache entry point resolves it at call time)
PAGE = 64
BEAM_CACHE_DTYPES = (torch.float32, torch.bfloat16)

KV_QMAX = 127.0
# pool dtype codes of the C launchers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the per-slot tensors of a pool (what a page copy moves) and their rank
# on one pool: [n_pages, page, H, dh] payload, [n_pages, page] scales. A
# stacked pool (serve_pool_init's ``shards``) and rows fetched from one
# have one more, the shard axis, first
_SLOT_NDIM = {"pool_k": 4, "pool_v": 4, "scale_k": 2, "scale_v": 2}
_SLOT_KEYS = tuple(_SLOT_NDIM)
# the one head dim the kernels are built for (every transformer variant's)
KERNEL_DH = 64

Pool = Dict[str, torch.Tensor]


def pool_quantized(pool: Pool) -> bool:
    """True for an int8 serve pool (the scale sidecar is the marker)."""
    return "scale_k" in pool


def serve_pool_init(n_pages: int, page: int, n_heads: int, dh: int,
                    dtype: torch.dtype, device: torch.device,
                    shards: int = 0) -> Pool:
    """A shared K/V pool of ``n_pages`` free-list-managed slots, zeroed
    (slot 0 is the scratch page — serve/allocator.py never hands it
    out). ``dtype`` float32 or bfloat16, or int8 for the quantised layout:
    the int8 payload plus zeroed scale sidecars (an unwritten position
    dequantises to exactly 0). ``shards`` > 0 stacks that many such pools
    on a leading axis (a tensor-parallel replica's shards, each with its
    ``n_heads`` heads; :func:`pool_shard` views shard s's)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"serve pool dtype {dtype} must be float32, "
                         "bfloat16 or int8")
    lead = (shards,) if shards else ()
    shape = lead + (n_pages, page, n_heads, dh)
    pool = {"pool_k": torch.zeros(shape, dtype=dtype, device=device),
            "pool_v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("scale_k", "scale_v"):
            pool[name] = torch.zeros(lead + (n_pages, page), device=device)
    return pool


def pool_shard(pool: Pool, s: int) -> Pool:
    """Shard ``s``'s pool of a stacked one (:func:`serve_pool_init`'s
    ``shards``): a contiguous view of each per-slot tensor; the layer's
    ``kv_seed`` and rounding table are every shard's."""
    return {k: (v[s] if k in _SLOT_KEYS else v) for k, v in pool.items()}


def slot_axis(key: str, t) -> int:
    """The slot (page) axis of per-slot tensor ``key`` of a pool, or of
    rows fetched from one (torch or numpy): 0, or 1 where the tensor's
    rank shows a stacked pool's leading shard axis."""
    return t.ndim - _SLOT_NDIM[key]


def slot_index(key: str, t, idx) -> tuple:
    """``t[slot_index(key, t, idx)]`` reads or assigns slot(s) ``idx``'s
    rows of per-slot tensor ``key`` (every shard's on a stacked pool)."""
    return (slice(None),) * slot_axis(key, t) + (idx,)


def pool_page_bytes(pool: Pool) -> int:
    """K/V payload bytes per page slot of ``pool`` (the scale sidecars
    excluded, so an int8 pool is exactly a quarter of a float32 one); a
    stacked pool's shards' slices sum to the whole page."""
    return sum(pool[n].element_size() * pool[n].numel()
               // pool[n].shape[slot_axis(n, pool[n])]
               for n in ("pool_k", "pool_v"))


def pool_checksum_keys(pool: Pool) -> tuple:
    """Keys of ``pool`` covered by the SDC checksum ledger
    (serve/integrity.py): the per-slot arrays the table writes scatter,
    payload rows plus the int8 scale sidecars, in sorted order (the CRC
    chain order). The layer's ``kv_seed`` and its rounding table ``kv_u``
    are not per-slot state and stay out."""
    return tuple(sorted(k for k in _SLOT_KEYS if k in pool))


# ---------------------------------------------------------------------------
# int8 quantisation at the write boundary.
# ---------------------------------------------------------------------------


def _kv_key(kv_seed: int, tag: int):
    return threefry.fold_in(threefry.prng_key(kv_seed), tag)


def kv_u_table(kv_seed: int, n_pos: int, n_heads: int, dh: int,
               device: torch.device) -> torch.Tensor:
    """The rounding uniforms of positions [0, n_pos) for the K (tag 0)
    and V (tag 1) rows of a layer seeded ``kv_seed``: [2, n_pos, H, dh],
    the rows :func:`_kv_quantize` would draw one write at a time."""
    pos = torch.arange(n_pos, dtype=torch.int64)
    return torch.stack([
        threefry.uniform(threefry.fold_in(_kv_key(kv_seed, tag), pos),
                         (n_heads, dh))
        for tag in (0, 1)]).to(device)


def _kv_quantize(x: torch.Tensor, pos: torch.Tensor, kv_seed: int,
                 tag: int, u_table: Optional[torch.Tensor] = None):
    """Quantise K or V rows ``x`` [..., H, dh] (one leading index per
    stream position ``pos``, of x's leading shape) to (int8 of x's shape,
    float32 scale [...]), bit for bit as the reference does: per-position
    absmax scale (the largest element maps to +-127; an all-zero row gets
    scale 1), unbiased stochastic rounding with the uniforms of
    ``fold_in(fold_in(PRNGKey(kv_seed), tag), position)``. ``u_table``
    [n_pos, H, dh] holds those uniforms precomputed (:func:`kv_u_table`);
    without it they are hashed here. Every position must lie inside the
    table: the engine checks its writes against it before every pass."""
    absmax = x.float().abs().amax(dim=(-2, -1))
    scale = torch.where(absmax > 0, absmax / KV_QMAX,
                        torch.ones_like(absmax))
    v = x.float() / scale[..., None, None]
    flat = pos.reshape(-1).long()
    if u_table is None:
        u = threefry.uniform(threefry.fold_in(_kv_key(kv_seed, tag),
                                              flat.cpu()), x.shape[-2:])
        u = u.to(x.device)
    else:
        u = u_table[flat]
    u = u.reshape(x.shape)
    lo = torch.floor(v)
    q = lo + (u < (v - lo)).float()
    return q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8), scale


def _pool_write(cache: Pool, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor, write_payload, write_scale) -> Pool:
    """The write dispatch of the three table writes: ``write_payload(pool,
    x)`` scatters value rows in place, and on an int8 pool the rows are
    quantised first and ``write_scale(scales, s)`` scatters their scales.
    ``pos`` holds the absolute position of every row (k's leading
    shape)."""
    if pool_quantized(cache):
        seed = cache.get("kv_seed", 0)
        u = cache.get("kv_u")
        for tag, (name, x) in enumerate((("k", k), ("v", v))):
            qx, sx = _kv_quantize(x, pos, seed, tag,
                                  None if u is None else u[tag])
            write_payload(cache["pool_" + name], qx)
            write_scale(cache["scale_" + name], sx)
    else:
        write_payload(cache["pool_k"], k)
        write_payload(cache["pool_v"], v)
    return cache


def _rows_vector(x: Union[int, torch.Tensor], rows: int,
                 device: torch.device) -> torch.Tensor:
    """A scalar or per-row position/start as an int32 ``[rows]`` tensor."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(rows).contiguous()


# ---------------------------------------------------------------------------
# Table writes. The reference returns new pools (JAX donates the old
# buffers to the jitted program); here the pool tensors are written IN PLACE
# and the same dict is returned, which is what donation buys JAX.
# ---------------------------------------------------------------------------


def paged_table_write(cache: Pool, k1: torch.Tensor, v1: torch.Tensor,
                      pos: Union[int, torch.Tensor], page: int) -> Pool:
    """Write one token's K/V [rows, 1, H, dh] at per-row positions ``pos``
    ([rows] int32, or a scalar) through the table: row r's token lands in
    slot ``table[r, pos_r // page]`` at offset ``pos_r % page``. Rows whose
    table row points at the scratch slot write garbage there harmlessly."""
    table = cache["table"]
    pos = _rows_vector(pos, table.shape[0], table.device).long()
    slots = table.long().gather(1, (pos // page)[:, None])[:, 0]
    off = pos % page

    def write(pool, x):
        pool[slots, off] = x[:, 0].to(pool.dtype)

    def write_scale(scales, s):
        scales[slots, off] = s[:, 0]

    return _pool_write(cache, k1, v1, pos[:, None], write, write_scale)


def paged_table_chunk_write(cache: Pool, k: torch.Tensor, v: torch.Tensor,
                            start: int, page: int) -> Pool:
    """Write a prefill chunk's K/V [rows, C, H, dh] at positions
    [start, start + C) through the table. ``start`` must be page-aligned
    and C a page multiple (the engine pads the last chunk)."""
    rows, C, H, dh = k.shape
    if C % page or start % page:
        raise ValueError(
            f"chunk [{start}, {start + C}) must be page-aligned (page {page})")
    npg_c = C // page
    # scratch-extend the table before slicing: slicing past the last
    # column would silently return FEWER columns (the reference's
    # dynamic_slice would clamp onto earlier live pages instead); with the
    # pad, a padded tail page past the table resolves to the scratch slot
    tbl = F.pad(cache["table"], (0, npg_c), value=SCRATCH_SLOT)
    slots = tbl[:, start // page:start // page + npg_c].long()

    def write(pool, x):
        pool[slots] = x.reshape(rows, npg_c, page, H, dh).to(pool.dtype)

    def write_scale(scales, s):
        scales[slots] = s.reshape(rows, npg_c, page)

    pos = start + torch.arange(C, device=k.device)
    return _pool_write(cache, k, v, pos.expand(rows, C), write, write_scale)


def paged_table_span_write(cache: Pool, k: torch.Tensor, v: torch.Tensor,
                           pos0: Union[int, torch.Tensor], page: int) -> Pool:
    """Write a span of W tokens' K/V [rows, W, H, dh] at per-row positions
    [pos0_r, pos0_r + W) through the table, page-UNALIGNED (the verify
    pass: the pending token plus the drafts start mid-page). Each position
    scatters by (page, offset); a position whose page index runs past the
    table lands on the scratch slot, like the chunk write's padded
    tail."""
    table = cache["table"]
    rows, W = k.shape[:2]
    npg = table.shape[1]
    pos = (_rows_vector(pos0, rows, table.device).long()[:, None]
           + torch.arange(W, device=table.device)[None, :])  # [rows, W]
    pg, off = pos // page, pos % page
    slots = table.long().gather(1, pg.clamp(0, npg - 1))
    slots = torch.where(pg < npg, slots, torch.zeros_like(slots))

    def write(pool, x):
        pool[slots, off] = x.to(pool.dtype)

    def write_scale(scales, s):
        scales[slots, off] = s

    return _pool_write(cache, k, v, pos, write, write_scale)


def serve_page_copy(pool: Pool, src: int, dst: int) -> Pool:
    """Copy-on-write: copy pool slot ``src`` into slot ``dst`` in place,
    in every per-slot tensor — the payload and, on an int8 pool, the scale
    sidecars, so the copy dequantises bit-identically to its source; on
    every shard of a stacked pool. The layer's ``kv_seed`` and rounding
    table are not per-slot and stay."""
    for name in _SLOT_KEYS:
        if name in pool:
            t = pool[name]
            t[slot_index(name, t, dst)] = t[slot_index(name, t, src)]
    return pool


# ---------------------------------------------------------------------------
# The row-owned beam cache (models/decode.py's paged loops). Every row owns
# one slot per page index, slot r * npg + j; completed pages are immutable
# (positions only grow), so a beam reorder copies table POINTERS for them
# and physically copies only the one partial page per row. Writes land in
# place, in the row's own slots.
# ---------------------------------------------------------------------------


def num_pages(total_len: int, page: Optional[int] = None) -> int:
    page = page or PAGE
    return -(-total_len // page)


def _own_table(rows: int, npg: int, device) -> torch.Tensor:
    return (torch.arange(rows, dtype=torch.int32, device=device)[:, None]
            * npg + torch.arange(npg, dtype=torch.int32,
                                 device=device)[None, :])


def paged_cache_init(rows: int, total_len: int, n_heads: int, dh: int,
                     dtype: torch.dtype, page: Optional[int] = None,
                     device=None) -> Pool:
    """A beam cache: pool_k/pool_v [rows * npg, page, H, dh] of ``dtype``
    (float32 or bfloat16), zeroed, and the int32 table [rows, npg] with
    every row on its own slots. ``table[r, j]`` is the slot holding row
    r's positions [j * page, (j + 1) * page); :func:`paged_reorder` keeps
    the entries of the current and later pages on the row's own slots, so
    writes never collide across rows."""
    if dtype not in BEAM_CACHE_DTYPES:
        raise ValueError(
            f"beam cache dtype {dtype}: float32 or bfloat16 only. The "
            "reference's beam cache has no scale sidecars, so an int8 cache "
            "would truncate K/V to integers (ROADMAP C.10); the int8 pool "
            "is the serving engine's")
    page = page or PAGE
    npg = num_pages(total_len, page)
    shape = (rows * npg, page, n_heads, dh)
    return {"pool_k": torch.zeros(shape, dtype=dtype, device=device),
            "pool_v": torch.zeros(shape, dtype=dtype, device=device),
            "table": _own_table(rows, npg, device)}


def _own_pages(pool: torch.Tensor, rows: int) -> torch.Tensor:
    """``pool`` viewed as [rows, npg, page, H, dh]: each row's own slots."""
    n, page, H, dh = pool.shape
    return pool.view(rows, n // rows, page, H, dh)


def paged_prefill_write(cache: Pool, k: torch.Tensor, v: torch.Tensor,
                        page: Optional[int] = None, start: int = 0) -> Pool:
    """Write a prompt chunk's K/V [rows, S, H, dh] at positions
    [start, start + S) into each row's own pages, in place. A chunk past
    the cache's capacity is refused (the reference's assert: its scatter
    would drop the positions past the pool)."""
    page = page or PAGE
    start = int(start)
    table = cache["table"]
    rows, S = k.shape[:2]
    capacity = table.shape[1] * page
    assert start + S <= capacity, (
        f"prefill chunk [{start}, {start + S}) exceeds the paged cache "
        f"capacity {capacity} ({table.shape[1]} pages x {page}); allocate "
        "the cache for the full prompt before chunked prefill")
    pos = torch.arange(start, start + S, device=table.device)
    pg, off = pos // page, pos % page
    for name, x in (("pool_k", k), ("pool_v", v)):
        pool = cache[name]
        _own_pages(pool, rows)[:, pg, off] = x.to(pool.dtype)
    return cache


def paged_decode_write(cache: Pool, k1: torch.Tensor, v1: torch.Tensor,
                       pos: int, page: Optional[int] = None) -> Pool:
    """Write one token's K/V [rows, 1, H, dh] at position ``pos`` (an int)
    into each row's own slot for its page, in place. Where the reference's
    dynamic_update_slice would clamp a position past the cache, this
    raises."""
    page = page or PAGE
    pos = int(pos)
    rows, npg = cache["table"].shape
    assert 0 <= pos < npg * page, (
        f"decode position {pos} outside the paged cache's {npg * page} "
        f"positions ({npg} pages x {page})")
    for name, x in (("pool_k", k1), ("pool_v", v1)):
        pool = cache[name]
        _own_pages(pool, rows)[:, pos // page, pos % page] = (
            x[:, 0].to(pool.dtype))
    return cache


def paged_reorder(cache: Pool, parent: torch.Tensor, pos: int,
                  page: Optional[int] = None) -> Pool:
    """Copy-on-write beam reorder before decoding position ``pos``:
    ``parent[r]`` is the row whose history row r continues. Completed
    pages (< pos // page) take the parent's table entries; the current
    page, if partly filled (pos % page > 0), is copied from the parent's
    own slot into row r's. Every source block is gathered before any is
    written: two rows may swap parents, and a copy one row at a time would
    overwrite a source before it is read. Returns the cache with the new
    table (a contiguous int32 [rows, npg]); the pools change in place."""
    page = page or PAGE
    pos = int(pos)
    table = cache["table"]
    rows, npg = table.shape
    p, off = pos // page, pos % page
    parent = parent.to(table.device, torch.long)
    page_idx = torch.arange(npg, device=table.device)[None, :]
    new = torch.where(page_idx >= p, _own_table(rows, npg, table.device),
                      table[parent]).contiguous()
    if off > 0:
        src = table[parent, p].long()  # a parent owns its partial page
        for name in ("pool_k", "pool_v"):
            pool = cache[name]
            blocks = pool[src]  # gathered: a new tensor
            _own_pages(pool, rows)[:, p] = blocks
    return {**cache, "table": new}


# ---------------------------------------------------------------------------
# Plain versions: gather the live pages, mask, softmax — in float32, with
# the result cast to the query's dtype (for float32 inputs exactly the
# reference's jnp oracles). The CPU path, and what chip_smoke.py holds the
# kernels against.
# ---------------------------------------------------------------------------


def _gather(cache: Pool, name: str, tbl: torch.Tensor) -> torch.Tensor:
    """The live pages of ``name`` through ``tbl`` [rows, np], as float32
    [rows, np * page, H, dh]; an int8 pool dequantised with its sidecar
    (``int8 * scale`` per position row, the kernels' arithmetic)."""
    pages = cache[name][tbl.long()].float()  # [rows, np, page, H, dh]
    if pool_quantized(cache):
        scale = cache["scale_" + name[-1]][tbl.long()]  # [rows, np, page]
        pages = pages * scale[..., None, None]
    rows, n, page, H, dh = pages.shape
    return pages.reshape(rows, n * page, H, dh)


def _paged_attention_ref(q: torch.Tensor, cache: Pool,
                         pos: Union[int, torch.Tensor], npages_live: int,
                         page: int) -> torch.Tensor:
    """Plain version of :func:`paged_attention`: [rows, H, dh]."""
    rows, H, dh = q.shape
    tbl = cache["table"][:, :npages_live]
    kc = _gather(cache, "pool_k", tbl)
    vc = _gather(cache, "pool_v", tbl)
    scores = torch.einsum("rhd,rkhd->rhk", q.float(), kc) / math.sqrt(dh)
    k_pos = torch.arange(npages_live * page, device=q.device)
    posv = _rows_vector(pos, rows, q.device)
    ok = k_pos[None, None, :] <= posv[:, None, None]
    probs = torch.softmax(scores.masked_fill(~ok, -math.inf), -1)
    return torch.einsum("rhk,rkhd->rhd", probs, vc).to(q.dtype)


def _paged_chunk_attention_ref(q: torch.Tensor, cache: Pool,
                               start: Union[int, torch.Tensor],
                               npages_live: int, page: int) -> torch.Tensor:
    """Plain version of :func:`paged_chunk_attention`: [rows, H, C, dh]."""
    rows, H, C, dh = q.shape
    tbl = cache["table"][:, :npages_live]
    kc = _gather(cache, "pool_k", tbl).transpose(1, 2)  # [rows, H, L, dh]
    vc = _gather(cache, "pool_v", tbl).transpose(1, 2)
    scores = torch.einsum("rhqd,rhkd->rhqk", q.float(), kc) / math.sqrt(dh)
    q_pos = (_rows_vector(start, rows, q.device)[:, None]
             + torch.arange(C, device=q.device)[None, :])  # [rows, C]
    k_pos = torch.arange(npages_live * page, device=q.device)
    ok = k_pos[None, None, None, :] <= q_pos[:, None, :, None]
    probs = torch.softmax(scores.masked_fill(~ok, -math.inf), -1)
    return torch.einsum("rhqk,rhkd->rhqd", probs, vc).to(q.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the CUDA kernel otherwise.
# ---------------------------------------------------------------------------


def _check_kernel_args(q: torch.Tensor, cache: Pool, npages_live: int,
                       page: int, what: str) -> None:
    pk, pv, table = cache["pool_k"], cache["pool_v"], cache["table"]
    for name, t in (("q", q), ("pool_k", pk), ("pool_v", pv),
                    ("table", table)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned "
                             "(the kernel's vector loads)")
    if q.dtype != torch.float32:
        raise ValueError(f"{what}: q {q.dtype} must be float32 (the "
                         "serving model's dtype)")
    if pk.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: pool {pk.dtype} must be float32, "
                         "bfloat16 or int8")
    if pv.dtype != pk.dtype or pv.shape != pk.shape:
        raise ValueError(f"{what}: pool_k and pool_v differ")
    if (pk.dtype == torch.int8) != pool_quantized(cache):
        raise ValueError(f"{what}: an int8 pool needs its scale sidecars, "
                         "and only an int8 pool has them")
    if pool_quantized(cache):
        for name in ("scale_k", "scale_v"):
            t = cache[name]
            if (t.device != q.device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.data_ptr() % 4
                    or tuple(t.shape) != tuple(pk.shape[:2])):
                raise ValueError(
                    f"{what}: {name} must be a contiguous float32 "
                    f"[n_pages, page] = {tuple(pk.shape[:2])} tensor on "
                    f"{q.device}")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError(f"{what}: table must be int32 [rows, npg]")
    _, pg, H, dh = pk.shape
    if pg != page or q.shape[1] != H or q.shape[-1] != dh:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match the "
                         f"pool {tuple(pk.shape)} at page {page}")
    if dh != KERNEL_DH:
        raise ValueError(f"{what}: head dim {dh} must be {KERNEL_DH}")
    if not 1 <= npages_live <= table.shape[1]:
        raise ValueError(f"{what}: npages_live {npages_live} outside "
                         f"[1, {table.shape[1]}]")
    if table.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: table has {table.shape[0]} rows, q "
                         f"{q.shape[0]}")


def kernel_takes(q: torch.Tensor, cache: Pool) -> bool:
    """Whether the paged kernels take query ``q`` over ``cache``: both on
    one CUDA device, a float32 query of head dim KERNEL_DH, a float32,
    bfloat16 or int8 pool. It looks at shapes, devices and dtypes only,
    never at whether a kernel builds or launches."""
    pk = cache["pool_k"]
    return (q.device.type == "cuda" and pk.device == q.device
            and q.dtype == torch.float32 and q.shape[-1] == KERNEL_DH
            and pk.dtype in _DTYPE_CODE and pk.shape[-1] == KERNEL_DH)


def _scale_ptrs(cache: Pool):
    """The sidecar pointers of an int8 pool (NULL for the others)."""
    if pool_quantized(cache):
        return cache["scale_k"].data_ptr(), cache["scale_v"].data_ptr()
    return None, None


def _count(fn, cache: Pool) -> None:
    if pool_quantized(cache):
        fn.launches_int8 += 1
    else:
        fn.launches += 1


def paged_attention(q: torch.Tensor, cache: Pool,
                    pos: Union[int, torch.Tensor], npages_live: int,
                    page: int) -> torch.Tensor:
    """Single-query attention of q [rows, H, dh] against the first
    ``npages_live`` table pages of each row, masked to key positions
    <= ``pos`` (a scalar or a per-row [rows] vector) -> [rows, H, dh]."""
    if q.device.type == "cpu":
        return _paged_attention_ref(q, cache, pos, npages_live, page)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args(q, cache, npages_live, page, "paged_attention")
    rows, H, dh = q.shape
    posv = _rows_vector(pos, rows, q.device)
    out = torch.empty_like(q)
    table = cache["table"]
    lib = _build.library("paged_attention")
    with torch.cuda.device(q.device):  # the operands' card
        code = lib.ddl_paged_decode(
            q.data_ptr(), cache["pool_k"].data_ptr(),
            cache["pool_v"].data_ptr(),
            *_scale_ptrs(cache), table.data_ptr(), posv.data_ptr(),
            out.data_ptr(), rows, H, dh, page, npages_live, table.shape[1],
            1.0 / math.sqrt(dh), _DTYPE_CODE[cache["pool_k"].dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_attention")
    _count(paged_attention, cache)
    return out


def paged_chunk_attention(q: torch.Tensor, cache: Pool,
                          start: Union[int, torch.Tensor], npages_live: int,
                          page: int) -> torch.Tensor:
    """Causal attention of chunk queries q [rows, H, C, dh] at absolute
    positions ``start + [0, C)`` (``start`` a scalar or per-row [rows])
    against the live pages, which must already hold the chunk's own K/V
    (write first, then attend) -> [rows, H, C, dh]."""
    if q.device.type == "cpu":
        return _paged_chunk_attention_ref(q, cache, start, npages_live, page)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args(q, cache, npages_live, page, "paged_chunk_attention")
    rows, H, C, dh = q.shape
    startv = _rows_vector(start, rows, q.device)
    out = torch.empty_like(q)
    table = cache["table"]
    lib = _build.library("paged_attention")
    with torch.cuda.device(q.device):  # the operands' card
        code = lib.ddl_paged_chunk(
            q.data_ptr(), cache["pool_k"].data_ptr(),
            cache["pool_v"].data_ptr(),
            *_scale_ptrs(cache), table.data_ptr(), startv.data_ptr(),
            out.data_ptr(), rows, H, C, dh, page, npages_live, table.shape[1],
            1.0 / math.sqrt(dh), _DTYPE_CODE[cache["pool_k"].dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_chunk_attention")
    _count(paged_chunk_attention, cache)
    return out


def _auto(fn, plain, q, cache, where, npages_live, page):
    if q.device.type == "cuda" and not kernel_takes(q, cache):
        fn.plain_launches += 1
        return plain(q, cache, where, npages_live, page)
    return fn(q, cache, where, npages_live, page)


def paged_attention_auto(q: torch.Tensor, cache: Pool,
                         pos: Union[int, torch.Tensor], npages_live: int,
                         page: int) -> torch.Tensor:
    """:func:`paged_attention`, or on a CUDA query its kernel refuses
    (:func:`kernel_takes`) the plain version, counted in
    ``paged_attention.plain_launches``."""
    return _auto(paged_attention, _paged_attention_ref, q, cache, pos,
                 npages_live, page)


def paged_chunk_attention_auto(q: torch.Tensor, cache: Pool,
                               start: Union[int, torch.Tensor],
                               npages_live: int, page: int) -> torch.Tensor:
    """:func:`paged_chunk_attention`, or on a CUDA query its kernel refuses
    the plain version, counted in ``paged_chunk_attention.plain_launches``."""
    return _auto(paged_chunk_attention, _paged_chunk_attention_ref, q, cache,
                 start, npages_live, page)


# kernel launches over float32/bfloat16 pools, and over int8 pools; calls
# on CUDA queries the kernels refuse, which took the plain versions
paged_attention.launches = 0
paged_attention.launches_int8 = 0
paged_attention.plain_launches = 0
paged_chunk_attention.launches = 0
paged_chunk_attention.launches_int8 = 0
paged_chunk_attention.plain_launches = 0
