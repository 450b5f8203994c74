#!/usr/bin/env python3
"""Time the port's bfloat16 flash kernels of several checkouts on one card.

    python3 scripts/flash_kernel_times.py ROOT [ROOT ...]

ROOT is the root of a checkout (the repository itself, or a parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
ROOT runs in a fresh process, in the order given, so list them in turns
(``A B B A``) to compare versions within one call. Each process builds that
checkout's kernels into its own ``build/``, discards one timed call (a
process's first reads high), then times ``flash_fwd`` and ``flash_dkv`` at
lmbench's shape (B 16, H 8, T 1024, dh 64, causal) and at B 2, T 8192 with
that checkout's ``chip_smoke.time_ms`` (CUDA events, the L2 flushed before
every launch), and prints one JSON line: the root, the card's name and
power limit, and the times in ms.
"""

import json
import subprocess
import sys


def one(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ddlbench_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
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
        times[f"flash_dkv_B{B}_T{T}"] = cs.time_ms(
            torch, lambda: fa.flash_dkv(q, k, v, do, lse, delta), flush)
    print(json.dumps({"root": root, "card": cs.card_line(), "ms": times}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
