#!/usr/bin/env python3
"""Time the port's bfloat16 flash, fused LM-head or paged kernels of several
checkouts on one card.

    python3 scripts/kernel_times.py flash|fxent|paged ROOT [ROOT ...]

ROOT is the root of a checkout (the repository itself, or a parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
ROOT runs in a fresh process, in the order given, so list them in turns
(``A B B A``) to compare versions within one call. Each process builds that
checkout's kernels into its own ``build/``, discards one timed call (a
process's first reads high), times the family's kernels with that
checkout's ``chip_smoke.time_ms`` (CUDA events, the L2 flushed before
every launch), and prints one JSON line: the family, the root, the card's
name and power limit, and the times in ms.

* ``flash``: ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at lmbench's
  shape (B 16, H 8, T 1024, dh 64, causal) and at B 2, T 8192;
* ``fxent``: ``fxent_fwd``, ``fxent_dh`` and ``fxent_dw`` at lmbench's head
  (N 16 384 = B 16 x T 1 024, D 512, V 32 768) and at D 768 (transformer_m's
  width);
* ``paged``: ``paged_chunk_attention`` at chip_smoke's timed shapes (its
  ``make_pools`` pools, page 16, H 8, dh 64, one table row holding 16
  distinct slots): the C-16 chunk that ends a 16-page stream over float32,
  bfloat16 and int8 pools, the 256-query unchunked chunk over float32, and
  the verify pass (8 rows over the 63 usable slots, C 5, unaligned starts)
  over float32 and int8; ``paged_attention`` (decode) at chip_smoke's
  decode shape (the same 8 rows, each at the last position of its last
  page) over float32, bfloat16 and int8 pools, and the chunk kernel at
  C 1 on that shape (``q[:, :, None]``, start = pos) over float32 and
  int8; and, as a yardstick, chip_smoke's ``library_call``
  (scaled_dot_product_attention over the gathered pages) at C 256; and
  ``floor_memset``, a one-element memset timed the same way: the
  harness's floor (launch and event overhead).
"""

import json
import subprocess
import sys

FXENT_SHAPES = ((16_384, 512, 32_768), (16_384, 768, 32_768))


def flash_times(torch, cs, dev, flush):
    from ddlbench_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(2)
    q, k, v, _ = cs.flash_inputs(torch, gen, dev, torch.bfloat16, 2, 8, 512,
                                 512)
    cs.time_ms(torch, lambda: fa.flash_fwd(q, k, v), flush)
    times = {}
    for B, T in ((16, 1024), (2, 8192)):
        q, k, v, do = cs.flash_inputs(torch, gen, dev, torch.bfloat16, B,
                                      cs.H, T, T)
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        times[f"flash_fwd_B{B}_T{T}"] = cs.time_ms(
            torch, lambda: fa.flash_fwd(q, k, v), flush)
        times[f"flash_dq_B{B}_T{T}"] = cs.time_ms(
            torch, lambda: fa.flash_dq(q, k, v, do, lse, delta), flush)
        times[f"flash_dkv_B{B}_T{T}"] = cs.time_ms(
            torch, lambda: fa.flash_dkv(q, k, v, do, lse, delta), flush)
    return times


def fxent_times(torch, cs, dev, flush):
    from ddlbench_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator().manual_seed(4)
    times = {}
    for i, (N, D, V) in enumerate(FXENT_SHAPES):
        h, w, labels = cs.fx_inputs(torch, gen, dev, torch.bfloat16, N, D, V,
                                    "none")
        coef = cs.fx_coef(torch, 0.0, V, dev)
        lse = fx.fxent_fwd(h, w, labels)[0]
        runs = {"fxent_fwd": lambda: fx.fxent_fwd(h, w, labels),
                "fxent_dh": lambda: fx.fxent_dh(h, w, labels, lse, coef),
                "fxent_dw": lambda: fx.fxent_dw(h, w, labels, lse, coef)}
        if i == 0:
            cs.time_ms(torch, runs["fxent_dh"], flush, iters=3, warmup=1)
        for name, fn in runs.items():
            times[f"{name}_D{D}"] = cs.time_ms(torch, fn, flush, iters=10)
        del h, w, labels, lse
    return times


def paged_times(torch, cs, dev, flush):
    from ddlbench_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator().manual_seed(3)
    # chip_smoke's timing table: each row's live pages distinct slots, row
    # 0 at the 16-page max_len, columns past a row's pages the scratch slot
    perm = (torch.randperm(cs.POOL_PAGES - 1, generator=gen) + 1).tolist()
    table = torch.zeros(cs.ROWS, cs.NPG, dtype=torch.int32)
    for r, live in enumerate(cs.DECODE_LIVE):
        table[r, :live] = torch.tensor(perm[:live])
        perm = perm[live:]
    verify_pos = torch.tensor([live * cs.PAGE - cs.VERIFY_C - r % 3
                               for r, live in enumerate(cs.DECODE_LIVE)],
                              dtype=torch.int32, device=dev)
    decode_pos = torch.tensor([live * cs.PAGE - 1 for live in cs.DECODE_LIVE],
                              dtype=torch.int32, device=dev)
    tiny = torch.zeros(1, device=dev)
    cs.time_ms(torch, tiny.zero_, flush)  # a first timed call reads high
    times = {"floor_memset": cs.time_ms(torch, tiny.zero_, flush)}
    for name, C, rows, dtype in (
            ("chunk16_float32", 16, 1, torch.float32),
            ("chunk16_bfloat16", 16, 1, torch.bfloat16),
            ("chunk16_int8", 16, 1, torch.int8),
            ("chunk256_float32", 256, 1, torch.float32),
            ("verify_float32", cs.VERIFY_C, cs.ROWS, torch.float32),
            ("verify_int8", cs.VERIFY_C, cs.ROWS, torch.int8),
            ("decode_float32", None, cs.ROWS, torch.float32),
            ("decode_bfloat16", None, cs.ROWS, torch.bfloat16),
            ("decode_int8", None, cs.ROWS, torch.int8),
            ("decode_chunk1_float32", 1, cs.ROWS, torch.float32),
            ("decode_chunk1_int8", 1, cs.ROWS, torch.int8)):
        cache = cs.make_pools(torch, pd, dtype, gen, dev)
        cache["table"] = table[:rows].to(dev)
        q = torch.randn(rows, cs.H, C or 1, cs.DH, generator=gen).to(dev)
        pos = (verify_pos if C == cs.VERIFY_C else
               decode_pos if name.startswith("decode") else
               torch.full((rows,), cs.NPG * cs.PAGE - C, dtype=torch.int32,
                          device=dev))
        if C is None:
            q = q[:, :, 0].contiguous()

        def run():
            if C is None:
                return pd.paged_attention(q, cache, pos, cs.NPG, cs.PAGE)
            return pd.paged_chunk_attention(q, cache, pos, cs.NPG, cs.PAGE)

        if len(times) == 1:
            cs.time_ms(torch, run, flush)
        times[name] = cs.time_ms(torch, run, flush)
        if C == 256:
            times["library_" + name] = cs.time_ms(
                torch, cs.library_call(torch, q, cache, pos, cs.NPG, C),
                flush)
    return times


FAMILIES = {"flash": flash_times, "fxent": fxent_times, "paged": paged_times}


def one(family: str, root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = FAMILIES[family](torch, cs, dev, flush)
    print(json.dumps({"family": family, "root": root, "card": cs.card_line(),
                      "ms": times}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 3 or sys.argv[1] not in FAMILIES:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[2:]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              sys.argv[1], root], timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
