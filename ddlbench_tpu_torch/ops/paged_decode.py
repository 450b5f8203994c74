"""Shared paged KV pool for the serving engine, and attention over it.

The port of the serving half of ``ddlbench_tpu/ops/paged_decode.py``. The
cache is a POOL of fixed-size pages ``[n_pages, page, H, dh]`` per layer
plus one int32 page TABLE ``[rows, npg]`` shared by every layer: row r's
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
counts its launches in ``launches``, so a run can show that the main path
went through the kernel.

The int8 pool and its fused dequant are not ported yet
(``ServeConfig.validate`` refuses ``kv_dtype='int8'``).
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30
SCRATCH_SLOT = 0

# pool dtype codes of the C launchers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the one head dim the kernels are built for (every transformer variant's)
KERNEL_DH = 64

Pool = Dict[str, torch.Tensor]


def serve_pool_init(n_pages: int, page: int, n_heads: int, dh: int,
                    dtype: torch.dtype, device: torch.device) -> Pool:
    """A shared K/V pool of ``n_pages`` free-list-managed slots, zeroed
    (slot 0 is the scratch page — serve/allocator.py never hands it
    out). ``dtype`` is float32 or bfloat16."""
    if dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"serve pool dtype {dtype} (float32 and bfloat16 are ported)")
    shape = (n_pages, page, n_heads, dh)
    return {"pool_k": torch.zeros(shape, dtype=dtype, device=device),
            "pool_v": torch.zeros(shape, dtype=dtype, device=device)}


def pool_page_bytes(pool: Pool) -> int:
    """K/V payload bytes per page slot of ``pool``."""
    return sum(pool[n].element_size() * pool[n][0].numel()
               for n in ("pool_k", "pool_v"))


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
    for name, x in (("pool_k", k1), ("pool_v", v1)):
        pool = cache[name]
        pool[slots, off] = x[:, 0].to(pool.dtype)
    return cache


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
    for name, x in (("pool_k", k), ("pool_v", v)):
        pool = cache[name]
        pool[slots] = x.reshape(rows, npg_c, page, H, dh).to(pool.dtype)
    return cache


# ---------------------------------------------------------------------------
# Plain versions: gather the live pages, mask, softmax — in float32, with
# the result cast to the query's dtype (for float32 inputs exactly the
# reference's jnp oracles). The CPU path, and what chip_smoke.py holds the
# kernels against.
# ---------------------------------------------------------------------------


def _gather(cache: Pool, name: str, tbl: torch.Tensor) -> torch.Tensor:
    """The live pages of ``name`` through ``tbl`` [rows, np], as float32
    [rows, np * page, H, dh]."""
    pages = cache[name][tbl.long()]  # [rows, np, page, H, dh]
    rows, n, page, H, dh = pages.shape
    return pages.reshape(rows, n * page, H, dh).float()


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
        raise ValueError(f"{what}: pool {pk.dtype} must be float32 or "
                         "bfloat16")
    if pv.dtype != pk.dtype or pv.shape != pk.shape:
        raise ValueError(f"{what}: pool_k and pool_v differ")
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
    code = lib.ddl_paged_decode(
        q.data_ptr(), cache["pool_k"].data_ptr(), cache["pool_v"].data_ptr(),
        table.data_ptr(), posv.data_ptr(), out.data_ptr(), rows, H, dh, page,
        npages_live, table.shape[1], 1.0 / math.sqrt(dh),
        _DTYPE_CODE[cache["pool_k"].dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_attention")
    paged_attention.launches += 1
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
    code = lib.ddl_paged_chunk(
        q.data_ptr(), cache["pool_k"].data_ptr(), cache["pool_v"].data_ptr(),
        table.data_ptr(), startv.data_ptr(), out.data_ptr(), rows, H, C, dh,
        page, npages_live, table.shape[1], 1.0 / math.sqrt(dh),
        _DTYPE_CODE[cache["pool_k"].dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_chunk_attention")
    paged_chunk_attention.launches += 1
    return out


paged_attention.launches = 0
paged_chunk_attention.launches = 0
