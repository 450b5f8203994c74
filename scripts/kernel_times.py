#!/usr/bin/env python3
"""Time the port's bfloat16 flash or fused LM-head kernels of several
checkouts on one card.

    python3 scripts/kernel_times.py flash|fxent ROOT [ROOT ...]

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
  width).
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


FAMILIES = {"flash": flash_times, "fxent": fxent_times}


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
