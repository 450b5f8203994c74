#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (ddlbench_tpu_torch/) on the card, in phases, each printing
one JSON line; any failure raises and exits non-zero:

1. build   — compiles the hand-written CUDA kernels from the sources in the
             checkout (ops/csrc/*.cu, nvcc for sm_90a) and reports the time.
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
             the greedy choice of the plain full-forward model run on
             prompt + emitted tokens (each emitted token's logit within 1e-3
             of its position's max logit).

4. profile — the same path (8 requests, warm) under torch.profiler: the
             device's busy share and the device time by kernel.

Then it prints the kernels table (one JSON object), the card's name and
power limit as nvidia-smi reports them, and, last, the device record.
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
    model on prompt + emitted tokens."""
    by_rid = {f["rid"]: f for f in server.finished}
    worst = 0.0
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
                    f"request {rid} token {i}: emitted {tok} is {gap} below "
                    "the plain model's max logit")
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
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": timed[name]["ms"],
         "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"],
         "bound_by": timed[name]["bound_by"],
         "library_ms": timed[name]["library_ms"]}
        for name in KERNELS]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
