#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (ddlbench_tpu_torch/) on the card, in phases, each printing
one JSON line; any failure raises and exits non-zero:

1. build   — compiles the hand-written CUDA kernels from the sources in the
             checkout (ops/csrc/*.cu: paged_attention and flash_attention,
             one nvcc each, started together, for sm_90a) and reports the
             time.
2. kernels — holds each kernel against its plain PyTorch version at the
             serving slice's shapes (rows 8, H 8, dh 64, page 16, a 64-page
             pool, scattered random tables, per-row positions with partial
             pages, npl 1/3/16; the chunk kernel at C 16 and 256; float32
             queries over float32 and bfloat16 pools) within 1e-4 max abs
             error. Then times the kernel, its plain version and one
             PyTorch library call computing the same function
             (scaled_dot_product_attention over the pre-gathered pages — a
             yardstick, never used by the port) with CUDA events, the L2
             cache flushed before every launch, at the deepest shapes the
             main path's pool can hold (decode: 8 rows over all 63 usable
             slots, npl 16; chunk: the C-16 chunk that ends a 16-page
             stream; float32, and besides bfloat16 and the 256-query
             unchunked chunk), beside the least time the card could take
             (bound_ms: the larger of the bytes over 3.35 TB/s and the
             operations over the peak rate for their type).
3. serve   — zeroes the kernels' launch counters, runs servebench's main
             path (transformer_s on synthtext at full width and depth,
             random weights from seed 0, continuous policy, closed loop, 16
             requests) on the card, and requires every request completed,
             both kernels launched, and two requests' emitted tokens to be
             the greedy choice of the plain full-forward model (the "xla"
             einsum attention, no kernel) run on prompt + emitted tokens
             (each emitted token's logit within 1e-3 of its position's max
             logit).

4. profile — the same path (8 requests, warm) under torch.profiler: the
             device's busy share and the device time by kernel.
5. flash_kernels — holds each flash kernel (forward, dQ, dK/dV) against
             its plain version: H 8, dh 64, float32 and bfloat16; causal at
             lmbench's own shape (B 16, T 1024), at B 2, T 1024 and T 1000
             (tail tiles), a query block at an offset, a key offset that
             leaves rows fully masked, and prefix_len 100. Tolerance:
             float32 1e-4 max abs error; bfloat16 1e-4 max abs on the lse
             and, on every output, each row's (one query's or key's dh
             values) L2 error within 2^-6 of that row's L2 norm: four
             bfloat16 unit roundoffs (the output's rounding, and the
             kernels' rounding of P and dS before the products they feed,
             which the plain versions keep in float32). A row far smaller
             than the others is measured against 1e-3 of the mean row
             norm. The check must reject the plain versions with a planted
             tail fault at T 1000: the last 8 keys dropped (forward, dQ)
             or the last 8 queries (dK/dV). Then longctx32k: the forward
             at T 32768, B 1, its last 256 rows against the plain version
             of those queries (q_offset T - 256 over the full K/V), and
             the backward kernels on that query block against theirs. The
             kernels table carries each kernel's worst bfloat16 max abs
             error (the training path's type).
6. flash_times — each flash kernel, its plain version and a PyTorch
             library call (scaled_dot_product_attention, is_causal; for
             dQ and dK/dV the backward of that call through
             torch.autograd.grad, which computes the pair, so both rows
             carry the pair's time) with CUDA events, the L2 flushed, at
             lmbench's main-path shape (B 16, H 8, T 1024, dh 64, bf16,
             causal) and, for the record, at B 2, T 8192, beside bound_ms:
             the larger of the bytes over 3.35 TB/s and the flops over
             989 TFLOP/s (4, 6 and 8 x dh flops per visible (query, key)
             pair for the forward, dQ and dK/dV).
7. train   — zeroes the flash counters and trains lmbench's main path on
             the card: transformer_s on synthtext (B 16, T 1024, full
             width and depth), bf16, flash+logits, random weights from
             seed 0, 2 warm-up and 10 timed steps through make_strategy /
             train_step / timed_steps. Requires every step's loss finite
             and each flash kernel launched 8 times a step (once per
             layer). Then one step's loss and gradients from the same
             weights and batch under "flash" and under "xla" must agree:
             the loss within 1e-2 absolute, each gradient leaf within 5e-2
             relative L2 (both run bf16 activations; the xla path also
             rounds its scores and probabilities to bf16). Then prints the
             port lmbench rows for flash+logits and xla+logits.
8. train_profile — 3 warm flash+logits steps under torch.profiler: the
             device's busy share and the top device kernels.

Then it prints the kernels table (one JSON object, the paged and the flash
kernels), the card's name and power limit as nvidia-smi reports them, and,
last, the device record.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per type
ROWS, H, DH, PAGE, POOL_PAGES, NPG = 8, 8, 64, 16, 64, 16
TOL = 1e-4  # max abs error, float32 queries over either pool dtype
# live pages of the 8 decode rows in the timed case: the 63 usable slots of
# the 64-page pool (slot 0 is scratch), one row at the 16-page max_len
DECODE_LIVE = (16, 9, 8, 8, 8, 6, 4, 4)
SOURCE = "ddlbench_tpu_torch/ops/csrc/paged_attention.cu"
KERNELS = {
    "paged_attention": "ddlbench_tpu/ops/paged_decode.py:318",
    "paged_chunk_attention": "ddlbench_tpu/ops/paged_decode.py:703",
}
FLASH_SOURCE = "ddlbench_tpu_torch/ops/csrc/flash_attention.cu"
# each flash kernel -> the pallas_call it replaces
FLASH_KERNELS = {
    "flash_fwd": "ddlbench_tpu/ops/flash_attention.py:465",
    "flash_dq": "ddlbench_tpu/ops/flash_attention.py:549",
    "flash_dkv": "ddlbench_tpu/ops/flash_attention.py:597",
}
FLASH_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
FLASH_TOL = 1e-4  # max abs error in float32, and of the lse in bfloat16
BF16_ROW_RTOL = 2.0 ** -6  # bfloat16: each row's L2 error over its L2 norm
# (B, H, Tq, Tk, q_offset, k_offset, prefix_len) of the flash checks
FLASH_CASES = (
    (16, 8, 1024, 1024, 0, 0, 0),  # lmbench's main-path shape
    (2, 8, 1024, 1024, 0, 0, 0),
    (2, 8, 1000, 1000, 0, 0, 0),
    (2, 8, 512, 1000, 488, 0, 0),
    (2, 8, 1000, 1000, 0, 100, 0),
    (2, 8, 1000, 1000, 0, 0, 100),
)
LONG_T, LONG_Q = 32_768, 256
TRAIN_ARGS = ["-m", "transformer_s", "-b", "synthtext", "--steps", "10",
              "--warmup", "2"]
LAYERS = 8  # transformer_s: one launch of each flash kernel per layer


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def make_case(torch, dtype, npl, C, gen, dev):
    """Pools, a scattered table drawn with replacement, a float32 query
    and per-row positions (decode, C None) or page-aligned chunk starts."""
    pk = torch.randn(POOL_PAGES, PAGE, H, DH, generator=gen).to(dev, dtype)
    pv = torch.randn(POOL_PAGES, PAGE, H, DH, generator=gen).to(dev, dtype)
    table = torch.randint(1, POOL_PAGES, (ROWS, NPG), generator=gen)
    cache = {"pool_k": pk, "pool_v": pv,
             "table": table.to(dev, torch.int32)}
    if C is None:
        q = torch.randn(ROWS, H, DH, generator=gen).to(dev)
        pos = torch.randint(0, npl * PAGE, (ROWS,), generator=gen)
    else:
        q = torch.randn(ROWS, H, C, DH, generator=gen).to(dev)
        pos = torch.randint(0, (npl * PAGE - C) // PAGE + 1, (ROWS,),
                            generator=gen) * PAGE
    return q, cache, pos.to(dev, torch.int32)


def run_kernel(pd, q, cache, pos, npl, C):
    if C is None:
        return pd.paged_attention(q, cache, pos, npl, PAGE)
    return pd.paged_chunk_attention(q, cache, pos, npl, PAGE)


def run_plain(pd, q, cache, pos, npl, C):
    if C is None:
        return pd._paged_attention_ref(q, cache, pos, npl, PAGE)
    return pd._paged_chunk_attention_ref(q, cache, pos, npl, PAGE)


def library_call(torch, q, cache, pos, npl, C):
    """scaled_dot_product_attention over the pages gathered beforehand,
    with the same absolute causal mask: returns the timed closure."""
    import torch.nn.functional as F

    tbl = cache["table"][:, :npl].long()
    L = npl * PAGE
    rows = q.shape[0]
    k = cache["pool_k"][tbl].reshape(rows, L, H, DH).transpose(1, 2)
    v = cache["pool_v"][tbl].reshape(rows, L, H, DH).transpose(1, 2)
    qq = q[:, :, None] if C is None else q
    k, v = k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
    cq = 1 if C is None else C
    qpos = pos[:, None] + torch.arange(cq, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def time_ms(torch, fn, flush, iters=20, warmup=5) -> float:
    """Mean device time of fn() over ``iters`` launches: CUDA events
    around each launch, the L2 flushed (64 MiB written) before each. A
    device-side sleep holds the stream while the host enqueues every
    launch, so the events time the device's work, not the host's Python
    between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 5e-3 * iters))  # ~5 ms a launch at 2 GHz
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound(q, cache, pos, npl, C):
    """(bound_ms, bound_by) for one call on these inputs: bytes each input
    read once (the live table entries, and each distinct pool slot they
    name once — a slot two rows share is one read) and the output written
    once, over the memory rate; the QK and PV products over the visible
    (query, key) pairs, over the peak rate for float32 (the query's type;
    the kernel computes in float32 over either pool)."""
    elt = cache["pool_k"].element_size()
    cq = 1 if C is None else C
    nbytes = 2 * q.numel() * q.element_size()  # q read + out written
    nbytes += pos.numel() * 4
    pairs, slots = 0, set()
    for r, p0 in enumerate(pos.tolist()):
        last = min(p0 + cq - 1, npl * PAGE - 1)
        live = last // PAGE + 1
        nbytes += live * 4  # table entries
        slots.update(cache["table"][r, :live].tolist())
        pairs += sum(min(p0 + c, npl * PAGE - 1) + 1 for c in range(cq))
    nbytes += len(slots) * 2 * PAGE * H * DH * elt  # K, V of each slot
    flops = 4 * pairs * H * DH
    dt = "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, pd, dev):
    gen = torch.Generator().manual_seed(0)
    worst = {name: 0.0 for name in KERNELS}
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for C, npls in ((None, (1, 3, 16)), (16, (1, 3, 16)), (256, (16,))):
            name = "paged_attention" if C is None else "paged_chunk_attention"
            for npl in npls:
                q, cache, pos = make_case(torch, dtype, npl, C, gen, dev)
                got = run_kernel(pd, q, cache, pos, npl, C)
                want = run_plain(pd, q, cache, pos, npl, C)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = math.isfinite(err) and err <= TOL
                checks.append({"kernel": name, "pool": dname, "npl": npl,
                               "C": C, "max_abs_err": err, "tol": TOL,
                               "ok": ok})
                if not ok:
                    raise AssertionError(f"{name} {dname} pool npl={npl} "
                                         f"C={C}: max abs err {err} > "
                                         f"{TOL}")
                if dtype == torch.float32:
                    worst[name] = max(worst[name], err)
    emit({"phase": "kernels", "checks": checks})

    # timing at the deepest shapes the main path's pool can hold, float32
    # pool (the slice's) — these are the kernels table's. Decode: the 8
    # rows hold all 63 usable slots, each slot in one row only, every row
    # at the last position of its last page, one row at the 16-page
    # max_len (npl 16). Prefill chunk: 1 row, C 16, the chunk that ends a
    # 16-page stream over 16 distinct slots. Then, for the record, the same
    # over a bfloat16 pool and the unchunked admission's one 256-query
    # chunk. Table columns past a row's live pages name the scratch slot.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    perm = (torch.randperm(POOL_PAGES - 1, generator=gen) + 1).tolist()
    table = torch.zeros(ROWS, NPG, dtype=torch.int32)
    for r, live in enumerate(DECODE_LIVE):
        table[r, :live] = torch.tensor(perm[:live])
        perm = perm[live:]
    decode_pos = torch.tensor([live * PAGE - 1 for live in DECODE_LIVE],
                              dtype=torch.int32)
    timed, more = {}, []
    for name, C, rows, dtype in (
            ("paged_attention", None, ROWS, torch.float32),
            ("paged_chunk_attention", 16, 1, torch.float32),
            ("paged_attention", None, ROWS, torch.bfloat16),
            ("paged_chunk_attention", 16, 1, torch.bfloat16),
            ("paged_chunk_attention", 256, 1, torch.float32)):
        pk = torch.randn(POOL_PAGES, PAGE, H, DH, generator=gen)
        pv = torch.randn(POOL_PAGES, PAGE, H, DH, generator=gen)
        cache = {"pool_k": pk.to(dev, dtype), "pool_v": pv.to(dev, dtype),
                 "table": table[:rows].to(dev)}
        shape = (rows, H, DH) if C is None else (rows, H, C, DH)
        q = torch.randn(*shape, generator=gen).to(dev)
        if C is None:
            pos = decode_pos.to(dev)
        else:  # row 0 holds 16 pages: the chunk ending its stream
            pos = torch.full((rows,), NPG * PAGE - C, dtype=torch.int32,
                             device=dev)
        b_ms, b_by = bound(q, cache, pos, NPG, C)
        if not timed:  # a process's first timed call reads high: discard it
            time_ms(torch, lambda: run_kernel(pd, q, cache, pos, NPG, C),
                    flush)
        rec = {
            "ms": time_ms(torch, lambda: run_kernel(pd, q, cache, pos, NPG,
                                                    C), flush),
            "plain_ms": time_ms(torch, lambda: run_plain(pd, q, cache, pos,
                                                         NPG, C), flush),
            "library_ms": time_ms(torch, library_call(torch, q, cache, pos,
                                                      NPG, C), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"rows": rows, "H": H, "dh": DH, "C": C, "page": PAGE,
                      "npl": NPG, "pool": str(dtype).split(".")[-1],
                      "live_pages": (list(DECODE_LIVE) if C is None
                                     else [NPG])},
        }
        if name in timed:
            more.append({"kernel": name, **rec})
        else:
            timed[name] = rec
    emit({"phase": "kernel_times", "times": timed, "more": more})
    return worst, timed


def teacher_forced_check(torch, model, server, reqs, dev, n_check=2):
    """Each emitted token of ``n_check`` finished requests must be the
    greedy choice (within 1e-3 of the max logit) of the plain full-forward
    model on prompt + emitted tokens: the "xla" attention backend, so no
    kernel under test computes the reference."""
    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    by_rid = {f["rid"]: f for f in server.finished}
    worst = 0.0
    set_attention_backend("xla")
    try:
        for rid in sorted(by_rid)[:n_check]:
            f = by_rid[rid]
            prompt = reqs[rid].prompt.tolist()
            toks = prompt + f["tokens"]
            with torch.no_grad():
                logits = model(torch.tensor([toks], device=dev))[0].float()
            S = len(prompt)
            for i, tok in enumerate(f["tokens"]):
                row = logits[S - 1 + i]
                gap = (row.max() - row[tok]).item()
                worst = max(worst, gap)
                if not math.isfinite(gap) or gap > 1e-3:
                    raise AssertionError(
                        f"request {rid} token {i}: emitted {tok} is {gap} "
                        "below the plain model's max logit")
    finally:
        set_attention_backend("auto")
    return worst


def phase_serve(torch, dev):
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.ops import paged_decode as pd
    from ddlbench_tpu_torch.tools import servebench

    args = servebench.build_parser().parse_args([
        "-m", "transformer_s", "-b", "synthtext", "--policies", "continuous",
        "--arrival", "closed", "--requests", "16", "--seed", "0",
        "--wall-clock"])
    model = get_model(args.model, args.benchmark, seed=args.seed).to(dev)
    pd.paged_attention.launches = 0
    pd.paged_chunk_attention.launches = 0
    (rec, server, reqs), = servebench.run(args, model, dev)
    launches = {"paged_attention": pd.paged_attention.launches,
                "paged_chunk_attention": pd.paged_chunk_attention.launches}
    if rec["completed"] != args.requests:
        raise AssertionError(f"completed {rec['completed']} of "
                             f"{args.requests} requests")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    gap = teacher_forced_check(torch, model, server, reqs, dev)
    emit({"phase": "serve", "launches": launches,
          "teacher_forced_max_gap": gap, "row": rec})
    return launches


def phase_profile(torch, dev):
    """Where a serving run's time goes: the same main path (warm kernels,
    8 requests) under torch.profiler — device time by kernel name, and
    the device's busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import servebench

    args = servebench.build_parser().parse_args([
        "-m", "transformer_s", "-b", "synthtext", "--policies", "continuous",
        "--arrival", "closed", "--requests", "8", "--seed", "1",
        "--wall-clock"])
    model = get_model(args.model, args.benchmark, seed=args.seed).to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (rec, server, _), = servebench.run(args, model, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    st = server.engines[0].stats
    emit({"phase": "profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "decode_calls": st["decode_calls"],
          "prefill_calls": st["prefill_calls"],
          "kernel_launches": sum(e.count for e in kern),
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top]})


def row_rel_err(got, want) -> float:
    """Worst row's L2 error over its L2 norm (a row: one query's or key's
    dh values). A row whose norm is under 1e-3 of the mean row norm is
    measured against that floor: a fully masked query, or a key no query
    sees, is 0 in both."""
    d = (got.float() - want.float()).norm(dim=-1)
    r = want.float().norm(dim=-1)
    floor = max(1e-3 * r.mean().item(), 1e-30)
    return (d / r.clamp(min=floor)).max().item()


def flash_errs(torch, outs, lse_err=None):
    """{max_abs_err, row_rel_err, ok} of a kernel's outputs against their
    plain versions, ``outs`` a tuple of (got, want) pairs; the lse error,
    where given, counts in the max abs error."""
    errs = [] if lse_err is None else [lse_err]
    rel = 0.0
    for got, want in outs:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{got.dtype} {tuple(got.shape)} vs "
                                 f"{want.dtype} {tuple(want.shape)}")
        errs.append((got.float() - want.float()).abs().max().item())
        rel = max(rel, row_rel_err(got, want))
    abs_err = max(errs)
    if outs[0][0].dtype == torch.float32:
        ok = abs_err <= FLASH_TOL
    else:
        ok = (rel <= BF16_ROW_RTOL
              and (lse_err is None or lse_err <= FLASH_TOL))
    finite = math.isfinite(abs_err) and math.isfinite(rel)
    return {"max_abs_err": abs_err if finite else math.inf,
            "row_rel_err": rel if finite else math.inf, "ok": ok and finite}


def flash_inputs(torch, gen, dev, dtype, B, H, Tq, Tk):
    q, do = (torch.randn(B, H, Tq, DH, generator=gen).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Tk, DH, generator=gen).to(dev, dtype)
            for _ in range(2))
    return q, k, v, do


def flash_compare(torch, fa, q, k, v, do, qo, ko, pre, fwd=None):
    """{kernel: flash_errs(...)} of the three kernels against their plain
    versions on (q, k, v, do); the backward pair runs on the plain
    forward's lse and delta. ``fwd`` is the kernel forward's (o, lse) when
    the caller ran it already (the longctx check). Also returns the
    kernels' outputs and the plain lse and delta."""
    o_ref, lse_ref = fa._flash_fwd_ref(q, k, v, qo, ko, pre)
    o, lse = fwd or fa.flash_fwd(q, k, v, qo, ko, pre)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dq_ref = fa._flash_dq_ref(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dk_ref, dv_ref = fa._flash_dkv_ref(q, k, v, do, lse_ref, delta, qo, ko,
                                       pre)
    torch.cuda.synchronize()
    seen = lse_ref > -1e29  # rows that see at least one key
    if not bool((lse[~seen] < -1e29).all()):
        raise AssertionError("flash_fwd: a fully masked row's lse is not "
                             "~-1e30")
    lse_err = (lse - lse_ref)[seen].abs().max().item() if seen.any() else 0.
    out = {"flash_fwd": flash_errs(torch, ((o, o_ref),), lse_err),
           "flash_dq": flash_errs(torch, ((dq, dq_ref),)),
           "flash_dkv": flash_errs(torch, ((dk, dk_ref), (dv, dv_ref)))}
    return out, (o, dq, dk, dv), (lse_ref, delta)


def planted_faults(torch, fa, q, k, v, do, outs, lse_ref, delta, n=8):
    """The bfloat16 check must reject the kernels' causal outputs held
    against plain versions with a tail fault: the last ``n`` keys dropped
    (forward, dQ; the last queries' rows change) or the last ``n`` queries
    (dK/dV). Returns what the check says of each, and what a bound scaled
    by the tensor's largest value says (2e-2 x max(1, max |plain|) on the
    max abs error), which a fault confined to a few rows can pass."""
    o, dq, dk, dv = outs
    k_cut, v_cut = k[:, :, :-n], v[:, :, :-n]
    o_bad, _ = fa._flash_fwd_ref(q, k_cut, v_cut)
    dq_bad = fa._flash_dq_ref(q, k_cut, v_cut, do, lse_ref, delta)
    dk_bad, dv_bad = fa._flash_dkv_ref(q[:, :, :-n], k, v, do[:, :, :-n],
                                       lse_ref[..., :-n], delta[..., :-n])
    verdicts = {}
    for name, pairs in (("flash_fwd", ((o, o_bad),)),
                        ("flash_dq", ((dq, dq_bad),)),
                        ("flash_dkv", ((dk, dk_bad), (dv, dv_bad)))):
        e = flash_errs(torch, pairs)
        scaled = all((g.float() - w.float()).abs().max().item()
                     <= 2e-2 * max(1.0, w.float().abs().max().item())
                     for g, w in pairs)
        verdicts[name] = {"row_rel_err": e["row_rel_err"],
                          "rejected": not e["ok"],
                          "max_scaled_bound_accepts": scaled}
        if e["ok"]:
            raise AssertionError(f"{name}: the bfloat16 check accepts a "
                                 f"planted tail fault ({e})")
    return verdicts


def phase_flash_kernels(torch, fa, dev):
    gen = torch.Generator().manual_seed(1)
    worst = {name: 0.0 for name in FLASH_KERNELS}
    checks, faults = [], None

    def record(case, dtype, errs):
        for name, e in errs.items():
            checks.append({"kernel": name, "case": case,
                           "dtype": str(dtype).split(".")[-1], **e})
            if not e["ok"]:
                raise AssertionError(f"{name} {case} {dtype}: {e} (float32 "
                                     f"max abs {FLASH_TOL}; bfloat16 row "
                                     f"{BF16_ROW_RTOL}, lse {FLASH_TOL})")
            if dtype == torch.bfloat16:
                worst[name] = max(worst[name], e["max_abs_err"])

    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            B, Hh, Tq, Tk, qo, ko, pre = case
            q, k, v, do = flash_inputs(torch, gen, dev, dtype, B, Hh, Tq, Tk)
            errs, outs, (lse_ref, delta) = flash_compare(
                torch, fa, q, k, v, do, qo, ko, pre)
            record(list(case), dtype, errs)
            if dtype == torch.bfloat16 and case == (2, 8, 1000, 1000, 0, 0,
                                                    0):
                faults = planted_faults(torch, fa, q, k, v, do, outs,
                                        lse_ref, delta)
            del q, k, v, do, outs, lse_ref, delta
    torch.cuda.empty_cache()
    # longctx32k: the kernel forward over the whole sequence, its last
    # LONG_Q rows held against the plain version of those queries; the
    # backward kernels on that query block (the plain path cannot hold a
    # 32k x 32k score tensor)
    dtype = torch.bfloat16
    q, k, v, do = flash_inputs(torch, gen, dev, dtype, 1, H, LONG_T, LONG_T)
    o, lse = fa.flash_fwd(q, k, v)
    qo = LONG_T - LONG_Q
    tail = (o[:, :, qo:], lse[:, :, qo:])
    errs, _, _ = flash_compare(torch, fa, q[:, :, qo:].contiguous(), k, v,
                               do[:, :, qo:].contiguous(), qo, 0, 0,
                               fwd=tail)
    record(["longctx32k", 1, H, LONG_T, LONG_T, qo, 0, 0], dtype, errs)
    emit({"phase": "flash_kernels", "float32_max_abs_tol": FLASH_TOL,
          "bfloat16_row_rel_tol": BF16_ROW_RTOL, "checks": checks,
          "planted_faults": faults})
    return worst


def flash_bound(name, B, Hh, T, dtype_bytes):
    """(bound_ms, bound_by) of one causal call at [B, H, T, 64]: each
    input read once and each output written once over the memory rate;
    the flops of the visible (query, key) pairs over the bf16 peak."""
    pairs = B * Hh * T * (T + 1) // 2
    tile = B * Hh * T * DH * dtype_bytes  # one [B, H, T, dh] tensor
    rows = B * Hh * T * 4  # one float32 [B, H, T] tensor (lse, delta)
    nbytes = {"flash_fwd": 3 * tile + tile + rows,
              "flash_dq": 4 * tile + 2 * rows + tile,
              "flash_dkv": 4 * tile + 2 * rows + 2 * tile}[name]
    flops = FLASH_FLOPS_PER_PAIR[name] * DH * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash_times(torch, fa, dev):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator().manual_seed(2)
    times = {}
    for B, T in ((16, 1024), (2, 8192)):
        q, k, v, do = flash_inputs(torch, gen, dev, torch.bfloat16, B, H, T,
                                   T)
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), flush)
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                          lambda: fa._flash_fwd_ref(q, k, v),
                          time_ms(torch, lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=True), flush)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                         lambda: fa._flash_dq_ref(q, k, v, do, lse, delta),
                         lib_bwd),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                          lambda: fa._flash_dkv_ref(q, k, v, do, lse, delta),
                          lib_bwd),
        }
        for name, (kern, plain, lib_ms) in runs.items():
            b_ms, b_by = flash_bound(name, B, H, T, 2)
            times.setdefault(name, []).append({
                "B": B, "H": H, "T": T, "dh": DH, "dtype": "bfloat16",
                "ms": time_ms(torch, kern, flush),
                "plain_ms": time_ms(torch, plain, flush, iters=5, warmup=1),
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        del out, qg, kg, vg
        torch.cuda.empty_cache()
    emit({"phase": "flash_times", "times": times,
          "library_note": "library_ms of flash_dq and flash_dkv is the "
                          "backward of scaled_dot_product_attention, which "
                          "computes dQ, dK and dV together"})
    return {name: rows[0] for name, rows in times.items()}


def phase_train(torch, fa, dev):
    """lmbench's main path on the card (flash+logits), with the flash
    launch counters zeroed just before it and read just after."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.transformer import set_attention_backend
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.parallel.common import loss_and_grads
    from ddlbench_tpu_torch.tools import lmbench
    from ddlbench_tpu_torch.tools.timing import timed_steps

    args = lmbench.build_parser().parse_args(TRAIN_ARGS)
    cfg = RunConfig(benchmark=args.benchmark, arch=args.model,
                    batch_size=args.batch_size, compute_dtype=args.dtype,
                    attention_backend="flash", steps_per_epoch=args.steps,
                    seed=0)
    counters = {name: getattr(fa, name) for name in FLASH_KERNELS}
    for fn in counters.values():
        fn.launches = 0
    strategy = make_strategy(cfg, dev)
    B, T = cfg.global_batch(), cfg.dataset().seq_len
    data = make_synthetic(cfg.dataset(), B, dev, seed=0,
                          steps_per_epoch=args.steps)
    lr, losses = cfg.resolved_lr(), []

    def run_step(x, y):
        m = strategy.train_step(x, y, lr)
        losses.append(m["loss"])
        return m

    dt = timed_steps(run_step, data.batch, args.steps, args.warmup)
    launches = {name: fn.launches for name, fn in counters.items()}
    steps_run = len(losses)
    loss_vals = torch.stack(losses).float().tolist()
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    for name, n in launches.items():
        if n != LAYERS * steps_run:
            raise AssertionError(f"{name} launched {n} times in {steps_run} "
                                 f"steps, not {LAYERS} a step")

    # one step's loss and gradients, same weights and batch, both backends
    x, y = data.batch(2, 0)
    got = {}
    for backend in ("flash", "xla"):
        set_attention_backend(backend)
        ce, _, grads = loss_and_grads(strategy.model, cfg, x, y,
                                      torch.bfloat16, 0.0)
        got[backend] = (ce.item(), [g.float().clone() for g in grads])
    set_attention_backend("auto")
    strategy.model.zero_grad(set_to_none=True)
    loss_gap = abs(got["flash"][0] - got["xla"][0])
    grad_rel = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                   for a, b in zip(got["flash"][1], got["xla"][1]))
    agree = {"loss_flash": got["flash"][0], "loss_xla": got["xla"][0],
             "loss_abs_diff": loss_gap, "loss_tol": 1e-2,
             "worst_grad_rel_l2": grad_rel, "grad_tol": 5e-2}
    if not (loss_gap <= 1e-2 and grad_rel <= 5e-2):
        raise AssertionError(f"flash and xla disagree on one step: {agree}")
    emit({"phase": "train", "model": args.model, "benchmark": args.benchmark,
          "batch": B, "seq_len": T, "dtype": args.dtype,
          "config": "flash+logits", "steps": steps_run,
          "launches": launches, "launches_per_step": LAYERS,
          "losses": loss_vals,
          "timed_tokens_per_sec": args.steps * B * T / dt,
          "timed_ms_per_step": 1e3 * dt / args.steps,
          "flash_vs_xla": agree})
    del got, grads
    torch.cuda.empty_cache()
    # the port's lmbench rows for the two configurations of the slice
    rc = lmbench.main(TRAIN_ARGS + ["--configs", "flash+logits,xla+logits"])
    if rc != 0:
        raise AssertionError(f"lmbench exited {rc}")
    return launches, strategy, data


def phase_train_profile(torch, strategy, data):
    """Where a flash+logits training step's device time goes."""
    from torch.profiler import ProfilerActivity, profile

    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    set_attention_backend("flash")
    lr = strategy.cfg.resolved_lr()
    x, y = data.batch(3, 0)
    strategy.train_step(x, y, lr)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            m = strategy.train_step(*data.batch(3, i + 1), lr)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    set_attention_backend("auto")
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "train_profile", "steps": steps, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share_of_busy": (e.self_device_time_total / 1e3
                                             / busy_ms)}
                          for e in top]})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    try:
        from ddlbench_tpu_torch.device import resolve_device
        from ddlbench_tpu_torch.ops import _build
        from ddlbench_tpu_torch.ops import flash_attention as fa
        from ddlbench_tpu_torch.ops import paged_decode as pd
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built})
    for name in built:
        log = _build._target(name).with_suffix(".log")
        print(log.read_text(), file=sys.stderr)

    worst, timed = phase_kernels(torch, pd, dev)
    launches = phase_serve(torch, dev)
    phase_profile(torch, dev)
    flash_worst = phase_flash_kernels(torch, fa, dev)
    flash_timed = phase_flash_times(torch, fa, dev)
    flash_launches, strategy, data = phase_train(torch, fa, dev)
    phase_train_profile(torch, strategy, data)

    def row(name, source, replaces, n, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    emit({"kernels": [
        row(name, SOURCE, KERNELS[name], launches[name], worst[name],
            timed[name]) for name in KERNELS] + [
        row(name, FLASH_SOURCE, FLASH_KERNELS[name], flash_launches[name],
            flash_worst[name], flash_timed[name]) for name in FLASH_KERNELS]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
