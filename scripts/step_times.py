#!/usr/bin/env python3
"""Time single's training step on one card for several checkouts: the
token path (lmbench's ``flash+fused`` row: transformer_s / synthtext, B 16
x T 1 024, bfloat16 on float32 masters, SGD) and the image headline
(tools/bench's record: resnet50 / imagenet, B 128, bfloat16,
channels_last, SGD).

    python3 scripts/step_times.py ROOT [ROOT ...]

ROOT is the root of a checkout (the repository itself, or a parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
ROOT runs lmbench and then bench, each in a fresh process from that root,
in the order given, so list them in turns (``A B B A``) to compare versions
within one call; a root's first process builds its kernels into its own
``build/``. Prints one JSON line per ROOT: the root, the card's name and
power limit, lmbench's ``ms_per_step`` and ``tokens_per_sec``, and bench's
``value`` (images/s) and step p50/p95.
"""

import json
import subprocess
import sys

LMBENCH = ["-m", "ddlbench_tpu_torch.tools.lmbench", "--configs",
           "flash+fused", "--steps", "20", "--warmup", "3"]
BENCH = ["-m", "ddlbench_tpu_torch.tools.bench", "--repeats", "3"]


def last_record(root, argv, key):
    """The last JSON line holding ``key`` that ``python argv`` printed,
    run from ``root``."""
    out = subprocess.run([sys.executable] + argv, cwd=root, check=True,
                         capture_output=True, text=True).stdout
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    return [r for r in rows if key in r][-1]


def main(roots):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for root in roots:
        lm = last_record(root, LMBENCH, "ms_per_step")
        img = last_record(root, BENCH, "value")
        print(json.dumps({
            "root": root, "card": card,
            "token_ms_per_step": lm["ms_per_step"],
            "token_tokens_per_sec": lm["tokens_per_sec"],
            "image_images_per_sec": img["value"],
            "image_step_p50_ms": img["step_time_p50_ms"],
            "image_step_p95_ms": img["step_time_p95_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
