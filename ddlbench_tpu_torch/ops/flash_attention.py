"""Causal / prefix-LM flash attention with hand-written CUDA kernels.

The port of ``ddlbench_tpu/ops/flash_attention.py``. Three kernels in
``csrc/flash_attention.cu`` replace the three Pallas TPU kernels:

* :func:`flash_fwd` — O and the row logsumexp (``_flash_fwd_impl``);
* :func:`flash_dq` — dQ, recomputing P from the saved lse (the first
  ``pallas_call`` of ``_flash_bwd_core``);
* :func:`flash_dkv` — dK and dV over the query-side sweep (its second).

:func:`flash_attention` ties them into a ``torch.autograd.Function``: the
forward saves ``(q, k, v, o, lse)``; the backward computes
``delta = rowsum(dO * O)`` in float32 with torch ops (outside the kernels,
as in the reference) and launches the dQ and the dK/dV kernels.
:func:`flash_attention_lse` returns the lse too, differentiable: its
cotangent shifts delta, and the same three kernels run (ring attention's
building block, models/transformer.py).

Semantics are the reference's: scale 1/sqrt(dh), float32 accumulation,
mask value -1e30, the key at absolute position ``k_offset + j`` visible to
the query at ``q_offset + i`` when ``q_pos >= k_pos`` or
``k_pos < prefix_len``; a fully masked row gives 0 output and finite
gradients. Any Tq and Tk; head dim 64 only on the card:
:func:`kernel_takes` says whether the kernels take a set of operands, and
the model's ``"auto"`` dispatch (models/transformer.py) takes the plain
path for operands they refuse, counted in ``flash_attention.plain_launches``.

On the card, the bfloat16 forward, dQ and dK/dV run on Hopper's wgmma with
TMA loads through mbarrier rings (``csrc/hopper.cuh``); the float32 builds
are CUDA-core kernels.

Each wrapper takes its plain PyTorch version (``_flash_*_ref``, float32
math, beside it) when its query lies on the CPU — the tests' route — and on
a CUDA tensor launches its kernel or raises; it counts its launches in
``launches``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30
# the one head dim the kernels are built for (every transformer variant's)
KERNEL_DH = 64
# dtype codes of the C launchers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mask(Tq: int, Tk: int, q_offset: int, k_offset: int, prefix_len: int,
          device: torch.device) -> torch.Tensor:
    """[Tq, Tk] bool: which keys each query sees (absolute positions)."""
    q_pos = q_offset + torch.arange(Tq, device=device)[:, None]
    k_pos = k_offset + torch.arange(Tk, device=device)[None, :]
    ok = q_pos >= k_pos
    if prefix_len:
        ok = ok | (k_pos < prefix_len)
    return ok


# ---------------------------------------------------------------------------
# Plain versions: float32 math on the kernels' residuals. The CPU path, and
# what the tests and chip_smoke.py hold the kernels against.
# ---------------------------------------------------------------------------


def _flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int = 0, k_offset: int = 0,
                   prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`: (o [B, H, Tq, dh] in q's dtype,
    lse [B, H, Tq] float32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _mask(q.shape[2], k.shape[2], q_offset, k_offset, prefix_len,
               q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * ok
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, q_offset, k_offset, prefix_len):
    """(p, ds) [B, H, Tq, Tk] float32, recomputed from the residuals: the
    mask selects before anything multiplies (a fully masked row's lse is
    ~-1e30, and exp(s - lse) would overflow)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _mask(q.shape[2], k.shape[2], q_offset, k_offset, prefix_len,
               q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _flash_dq_ref(q, k, v, do, lse, delta, q_offset: int = 0,
                  k_offset: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_dq`: dq [B, H, Tq, dh] in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, q_offset, k_offset,
                          prefix_len)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def _flash_dkv_ref(q, k, v, do, lse, delta, q_offset: int = 0,
                   k_offset: int = 0, prefix_len: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_dkv`: (dk, dv) [B, H, Tk, dh] in k's
    and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, q_offset, k_offset,
                          prefix_len)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the CUDA kernel otherwise.
# ---------------------------------------------------------------------------


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernels take these operands: all on one CUDA device,
    [B, H, T, KERNEL_DH] with k and v alike, one dtype, float32 or
    bfloat16. It looks at shapes, devices and dtypes only, never at whether
    a kernel builds or launches."""
    return (q.device.type == "cuda" and k.device == v.device == q.device
            and q.dim() == 4 and k.dim() == 4 and v.shape == k.shape
            and q.shape[-1] == k.shape[-1] == KERNEL_DH
            and q.shape[:2] == k.shape[:2]
            and q.dtype in _DTYPE_CODE and k.dtype == v.dtype == q.dtype)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_args(what: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *rest: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [B, H, T, dh] with k "
                         "and v alike")
    B, H, _, dh = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != dh:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or dh")
    if dh != KERNEL_DH:
        raise ValueError(f"{what}: head dim {dh} must be {KERNEL_DH} (the "
                         "kernels' build)")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {q.dtype} must be float32 or "
                         "bfloat16")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{q.device}")
    for t in (k, v) + rest[:1]:  # dO, where given, is in q's type too
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: mixed dtypes {q.dtype}, {t.dtype}")
    if B * H > 65535:
        raise ValueError(f"{what}: batch*heads {B * H} exceeds the grid's "
                         "65535")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: int = 0, k_offset: int = 0, prefix_len: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o [B, H, Tq, dh] in q's dtype, lse [B, H, Tq]
    float32) for q [B, H, Tq, dh] against k/v [B, H, Tk, dh]."""
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, q_offset, k_offset, prefix_len)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args("flash_fwd", q, k, v)
    q, k, v = map(_kernel_operand, (q, k, v))
    B, H, Tq, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):  # the operands' card
        code = lib.ddl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, Tq, k.shape[2], dh, q_offset, k_offset,
            prefix_len, 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta):
    q, k, v, do = map(_kernel_operand, (q, k, v, do))
    lse = _kernel_operand(lse.float())
    delta = _kernel_operand(delta.float())
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} must be [B, H, Tq]")
    return q, k, v, do, lse, delta


def flash_dq(q, k, v, do, lse, delta, q_offset: int = 0, k_offset: int = 0,
             prefix_len: int = 0) -> torch.Tensor:
    """dQ kernel: dq [B, H, Tq, dh] from the forward's residuals, the
    output gradient ``do`` and ``delta`` = rowsum(do * o) [B, H, Tq]."""
    if q.device.type == "cpu":
        return _flash_dq_ref(q, k, v, do, lse, delta, q_offset, k_offset,
                             prefix_len)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args("flash_dq", q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    B, H, Tq, dh = q.shape
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):  # the operands' card
        code = lib.ddl_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, Tq,
            k.shape[2], dh, q_offset, k_offset, prefix_len,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, q_offset: int = 0, k_offset: int = 0,
              prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: (dk, dv) [B, H, Tk, dh] from the same inputs as
    :func:`flash_dq`."""
    if q.device.type == "cpu":
        return _flash_dkv_ref(q, k, v, do, lse, delta, q_offset, k_offset,
                              prefix_len)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args("flash_dkv", q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    B, H, Tq, dh = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):  # the operands' card
        code = lib.ddl_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, Tq, k.shape[2], dh, q_offset, k_offset, prefix_len,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(o, lse), both differentiable. The lse's cotangent g enters the
    backward as a shift of delta: d lse_i / d s_ij = p_ij, so
    ds = p * (dp - (delta - g)), and the dQ and dK/dV kernels (or their
    plain versions, with ``plain``) run unchanged on the shifted delta;
    where the lse is not used (:func:`flash_attention`) there is no
    shift."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, prefix_len, plain):
        fwd = _flash_fwd_ref if plain else flash_fwd
        o, lse = fwd(q, k, v, q_offset, k_offset, prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offsets = (q_offset, k_offset, prefix_len)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:  # only the lse was used
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq_fn, dkv_fn = ((_flash_dq_ref, _flash_dkv_ref) if ctx.plain
                         else (flash_dq, flash_dkv))
        dq = dq_fn(q, k, v, do, lse, delta, *ctx.offsets)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, *ctx.offsets)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, k_offset: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """Causal / prefix-LM attention, q [B, H, Tq, dh] against k/v
    [B, H, Tk, dh] -> [B, H, Tq, dh], differentiable in q, k and v.
    Offsets give each block's absolute position; key positions below
    ``prefix_len`` are visible to every query."""
    return _FlashAttention.apply(q, k, v, q_offset, k_offset, prefix_len,
                                 False)[0]


# attention calls on CUDA tensors the kernels refuse, which the model's
# "auto" dispatch sends down the plain path instead
flash_attention.plain_launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, k_offset: int = 0,
                        prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the row logsumexp: (o
    [B, H, Tq, dh] in q's dtype, lse [B, H, Tq] float32), both
    differentiable (the reference's ``flash_attention_lse``). Partial
    results against different key blocks combine exactly through their
    lse (ring attention, models/transformer.py). The kernels B1-B3 on a
    CUDA query, their plain versions on a CPU one."""
    return _FlashAttention.apply(q, k, v, q_offset, k_offset, prefix_len,
                                 False)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_offset: int = 0,
                              k_offset: int = 0, prefix_len: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_lse` on any device:
    ``_flash_fwd_ref`` and the plain backward with the same delta shift
    (what chip_smoke.py holds the kernels' lse path against)."""
    return _FlashAttention.apply(q, k, v, q_offset, k_offset, prefix_len,
                                 True)
