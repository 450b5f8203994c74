"""Fused LM-head loss: projection + softmax cross-entropy without the
[N, V] logits, with hand-written CUDA kernels.

The port of ``ddlbench_tpu/ops/fused_xent.py``. Three kernels in
``csrc/fused_xent.cu`` replace the three Pallas TPU kernels:

* :func:`fxent_fwd` — per row (lse, gold logit, zsum, argmax) of
  z = h @ W, swept over vocab tiles (``_fxent_fwd_pallas``);
* :func:`fxent_dh` — dh = dz @ W^T, recomputing z from the saved lse (the
  first ``pallas_call`` of ``_fxent_bwd_pallas``);
* :func:`fxent_dw` — dW = h^T @ dz over the rows (its second).

:func:`fused_linear_xent` ties them into a ``torch.autograd.Function``
returning ``(objective_sum, ce_sum, correct)`` over the valid rows (label
>= 0); the three sums are torch reductions over the forward kernel's
per-row outputs, as the reference does them in XLA outside its kernel.
Label smoothing is GNMT-style: objective = lse - (1-s) gold - s zsum / V.
The backward forms dz = c_p p - c_oh onehot - c_sm with
(c_p, c_oh, c_sm) = (go + gce, go (1-s) + gce, go s / V) from the two
cotangents, zero on masked rows, rounded to h's dtype before both
products; dh comes back in h's dtype and dW in w's.

:func:`fused_linear_xent_eval` is the reference's chunked eval scan, plain
torch (no kernel in the reference either).

Each wrapper takes its plain PyTorch version (``_fxent_*_ref``, float32
math chunked over rows, beside it) when ``h`` lies on the CPU — the tests'
route — and on a CUDA tensor launches its kernel or raises; it counts its
launches in ``launches``. The TPU's dispatch and VMEM budgeting
(``_use_pallas``, ``_budget_v_block``, row padding) have no counterpart:
the kernels mask ragged rows and vocab tiles themselves.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the widest head dim the kernels' shared memory holds (csrc kMaxD)
KERNEL_MAX_D = 768
ROW_CHUNK = 512  # rows per step of the plain versions (bounded memory)
# dtype codes of the C launchers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions: float32 math, chunked over rows. The CPU path, and what
# the tests and chip_smoke.py hold the kernels against.
# ---------------------------------------------------------------------------


def _logits(h_c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 z of a row chunk: exact products of the inputs' values,
    float32 sums (the reference's preferred_element_type=float32)."""
    return h_c.float() @ w.float()


def _fxent_fwd_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                   row_chunk: int = ROW_CHUNK
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`fxent_fwd`: (lse, gold, zsum) float32 [N]
    and argmax int32 [N] (the first index of the maximum). gold is 0 on a
    masked row (no column matches label -1)."""
    outs = []
    for i in range(0, h.shape[0], row_chunk):
        z = _logits(h[i:i + row_chunk], w)
        lab = labels[i:i + row_chunk].long()
        m = z.amax(-1)
        lse = m + torch.log(torch.exp(z - m[:, None]).sum(-1).clamp(min=1e-20))
        gold = torch.where(lab >= 0,
                           z.gather(-1, lab.clamp(min=0)[:, None])[:, 0], 0.0)
        outs.append((lse, gold, z.sum(-1), z.argmax(-1).int()))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _dz(z, lab, lse_c, coef, dtype):
    """dz of a row chunk in ``dtype``: c_p p - c_oh onehot - c_sm, selected
    to 0 on masked rows before anything multiplies."""
    p = torch.exp(z - lse_c[:, None])
    onehot = torch.zeros_like(z).scatter_(1, lab.clamp(min=0)[:, None], 1.0)
    dz = coef[0] * p - coef[1] * onehot - coef[2]
    return torch.where((lab >= 0)[:, None], dz, 0.0).to(dtype)


def _fxent_dh_ref(h, w, labels, lse, coef,
                  row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Plain version of :func:`fxent_dh`: dh [N, D] in h's dtype."""
    wf = w.float()
    parts = []
    for i in range(0, h.shape[0], row_chunk):
        z = _logits(h[i:i + row_chunk], w)
        dz = _dz(z, labels[i:i + row_chunk].long(), lse[i:i + row_chunk],
                 coef.float(), h.dtype)
        parts.append((dz.float() @ wf.T).to(h.dtype))
    return torch.cat(parts)


def _fxent_dw_ref(h, w, labels, lse, coef,
                  row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Plain version of :func:`fxent_dw`: dW [D, V] summed over all rows in
    float32, in w's dtype."""
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i in range(0, h.shape[0], row_chunk):
        h_c = h[i:i + row_chunk]
        dz = _dz(_logits(h_c, w), labels[i:i + row_chunk].long(),
                 lse[i:i + row_chunk], coef.float(), h.dtype)
        dw += h_c.float().T @ dz.float()
    return dw.to(w.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the CUDA kernel otherwise.
# ---------------------------------------------------------------------------


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_args(what: str, h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, *rest: torch.Tensor) -> None:
    if h.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"{what}: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)} must be [N, D], "
                         "[D, V] and [N]")
    N, D = h.shape
    if w.shape[0] != D or labels.shape[0] != N or N < 1 or w.shape[1] < 1:
        raise ValueError(f"{what}: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)} do not agree")
    if D % 16 or D > KERNEL_MAX_D:
        raise ValueError(f"{what}: head dim {D} must be a multiple of 16 and "
                         f"at most KERNEL_MAX_D = {KERNEL_MAX_D} (the "
                         "kernels' shared memory)")
    if h.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {h.dtype} must be float32 or "
                         "bfloat16")
    if w.dtype != h.dtype:
        raise ValueError(f"{what}: mixed dtypes {h.dtype}, {w.dtype}")
    if h.dtype == torch.bfloat16 and w.shape[1] % 8:
        raise ValueError(f"{what}: vocabulary {w.shape[1]} must be a multiple "
                         "of 8 in bfloat16 (the kernels copy W's rows in "
                         "16-byte pieces)")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.dtype == torch.bool:
        raise ValueError(f"{what}: labels must be integer, got "
                         f"{labels.dtype}")
    for t in (w, labels, *rest):
        if t.device != h.device:
            raise ValueError(f"{what}: mixed devices {h.device}, {t.device}")
    if any(n >= 2 ** 31 for n in (N, w.shape[1], N * D, w.numel())):
        raise ValueError(f"{what}: sizes past the kernels' int32 indices")


def _operands(h, w, labels):
    return (_kernel_operand(h), _kernel_operand(w),
            _kernel_operand(labels.to(torch.int32)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fxent_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """Forward kernel: (lse, gold, zsum) float32 [N] and argmax int32 [N]
    of z = h [N, D] @ w [D, V] (gold 0 on masked rows)."""
    if h.device.type == "cpu":
        return _fxent_fwd_ref(h, w, labels)
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args("fxent_fwd", h, w, labels)
    h, w, lab = _operands(h, w, labels)
    N, D = h.shape
    f32 = dict(dtype=torch.float32, device=h.device)
    lse, gold, zsum = (torch.empty(N, **f32) for _ in range(3))
    amax = torch.empty(N, dtype=torch.int32, device=h.device)
    lib = _build.library("fused_xent")
    with torch.cuda.device(h.device):  # the operands' card
        code = lib.ddl_fxent_fwd(
            h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            gold.data_ptr(), zsum.data_ptr(), amax.data_ptr(), N, D,
            w.shape[1], _DTYPE_CODE[h.dtype], _stream(h))
    _build.check(lib, code, "fxent_fwd")
    fxent_fwd.launches += 1
    return lse, gold, zsum, amax


def _bwd(name: str, h, w, labels, lse, coef, out_like):
    from ddlbench_tpu_torch.ops import _build

    _check_kernel_args(name, h, w, labels, lse, coef)
    h, w, lab = _operands(h, w, labels)
    lse = _kernel_operand(lse.float())
    coef = _kernel_operand(coef.float())
    if lse.shape != (h.shape[0],) or coef.shape != (3,):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} must be [N] and "
                         f"coef {tuple(coef.shape)} [3]")
    out = torch.empty_like(out_like, memory_format=torch.contiguous_format)
    lib = _build.library("fused_xent")
    with torch.cuda.device(h.device):  # the operands' card
        code = getattr(lib, f"ddl_{name}")(
            h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            coef.data_ptr(), out.data_ptr(), h.shape[0], h.shape[1],
            w.shape[1], _DTYPE_CODE[h.dtype], _stream(h))
    _build.check(lib, code, name)
    return out


def fxent_dh(h, w, labels, lse, coef) -> torch.Tensor:
    """dh kernel: dh [N, D] in h's dtype from the forward's lse and
    ``coef`` = (c_p, c_oh, c_sm), a float32 [3] tensor on h's device."""
    if h.device.type == "cpu":
        return _fxent_dh_ref(h, w, labels, lse, coef)
    dh = _bwd("fxent_dh", h, w, labels, lse, coef, h)
    fxent_dh.launches += 1
    return dh


def fxent_dw(h, w, labels, lse, coef) -> torch.Tensor:
    """dW kernel: dW [D, V] in w's dtype, from the same inputs as
    :func:`fxent_dh`."""
    if h.device.type == "cpu":
        return _fxent_dw_ref(h, w, labels, lse, coef)
    dw = _bwd("fxent_dw", h, w, labels, lse, coef, w)
    fxent_dw.launches += 1
    return dw


fxent_fwd.launches = 0
fxent_dh.launches = 0
fxent_dw.launches = 0


def loss_sums(lse, gold, zsum, amax, labels, smoothing: float, V: int):
    """(objective_sum, ce_sum, correct) over the valid rows from the
    forward's per-row outputs (the reference's XLA epilogue, :467-475)."""
    mask = labels >= 0
    nll = lse - gold
    if smoothing:
        obj = lse - (1.0 - smoothing) * gold - smoothing * (zsum / V)
    else:
        obj = nll
    return (torch.where(mask, obj, 0.0).sum(),
            torch.where(mask, nll, 0.0).sum(),
            ((amax.long() == labels.long()) & mask).sum())


class _FusedLinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, smoothing):
        lse, gold, zsum, amax = fxent_fwd(h, w, labels)
        obj_s, ce_s, correct = loss_sums(lse, gold, zsum, amax, labels,
                                         smoothing, w.shape[1])
        ctx.save_for_backward(h, w, labels, lse)
        ctx.smoothing = smoothing
        ctx.mark_non_differentiable(correct)
        return obj_s, ce_s, correct

    @staticmethod
    def backward(ctx, go, gce, _):
        h, w, labels, lse = ctx.saved_tensors
        s, V = ctx.smoothing, w.shape[1]
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        go = zero if go is None else go.float()
        gce = zero if gce is None else gce.float()
        coef = torch.stack([go + gce, go * (1.0 - s) + gce, go * (s / V)])
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = fxent_dh(h, w, labels, lse, coef)
        if ctx.needs_input_grad[1]:
            dw = fxent_dw(h, w, labels, lse, coef)
        return dh, dw, None, None


def fused_linear_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      smoothing: float = 0.0):
    """(objective_sum, ce_sum, correct) over valid rows of the loss of
    z = h [N, D] @ w [D, V] against ``labels`` [N] (-1 = masked), without
    the [N, V] logits. Both sums are differentiable in h and w; ``correct``
    is not. (The reference's ``row_chunk``, ``backend`` and ``interpret``
    choose among its XLA and Pallas paths; here the device of h does.)"""
    return _FusedLinearXent.apply(h, w, labels, float(smoothing))


@torch.no_grad()
def fused_linear_xent_eval(h: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor, k: int = 5,
                           row_chunk: int = ROW_CHUNK):
    """(ce_sum, correct, correct_topk, valid) over valid rows, one
    [row_chunk, V] float32 logit block at a time (the reference's chunked
    eval scan; plain torch there and here). Top-k ties follow torch.topk's
    order: the label ranks after every strictly greater logit and after
    equal logits at smaller class indices."""
    V = w.shape[1]
    k = min(k, V)
    dev = h.device
    ce = torch.zeros((), dtype=torch.float32, device=dev)
    corr, corrk, cnt = (torch.zeros((), dtype=torch.int64, device=dev)
                        for _ in range(3))
    idx = torch.arange(V, device=dev)
    for i in range(0, h.shape[0], row_chunk):
        z = _logits(h[i:i + row_chunk], w)
        lab = labels[i:i + row_chunk].long()
        mask = lab >= 0
        safe = lab.clamp(min=0)
        m = z.amax(-1)
        lse = m + torch.log(torch.exp(z - m[:, None]).sum(-1))
        gold = z.gather(-1, safe[:, None])
        ce = ce + torch.where(mask, lse - gold[:, 0], 0.0).sum()
        corr = corr + ((z.argmax(-1) == lab) & mask).sum()
        higher = (z > gold).sum(-1)
        tie_before = ((z == gold) & (idx < safe[:, None])).sum(-1)
        corrk = corrk + ((higher + tie_before < k) & mask).sum()
        cnt = cnt + mask.sum()
    return ce, corr, corrk, cnt
