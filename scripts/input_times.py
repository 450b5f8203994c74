#!/usr/bin/env python3
"""Time the on-disk image path on one card: what a batch costs the input
pipeline's producer alone, and the training CLI's epoch at several
prefetch depths, in turns, in one process.

    python3 scripts/input_times.py [--rounds 3] [--depths 2,0]
        [--arch resnet50] [--steps 20] [--batch-size 128]

Writes a synthetic imagenet store of ``--steps`` x B train and 2 x B test
images with the port's ``generate_dataset`` to a temporary directory
(removed after) and prints one JSON line for the producer's costs
(chip_smoke's ``producer_costs``: the host ms a batch of the copy out of
the loader's ring and of queueing its upload, augmentation and
normalisation, and the device ms of that work), then runs one inline
epoch to warm the process, then for each round one epoch of ``python -m
ddlbench_tpu_torch.cli -b imagenet -m ARCH -s ... --dtype bfloat16`` at
each depth in the order given (0 is ``--no-prefetch``), one JSON line
each: images/s, the input stall, its share of the epoch and step
p50/p95; last, the card's name and power limit.
"""

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path


def epoch(cli, root: Path, args, depth: int) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["-b", "imagenet", "-f", "single", "-m", args.arch, "-s",
                  "-e", "1", "--steps-per-epoch", str(args.steps),
                  "--batch-size", str(args.batch_size), "--dtype",
                  "bfloat16", "-p", str(args.steps), "--data-dir",
                  str(root), "--prefetch-depth", str(depth)])
    r = json.loads(out.getvalue().splitlines()[-1][len("result: "):])
    return {"images_per_sec": r["samples_per_sec"],
            "input_stall_ms": r["input_stall_ms_per_epoch"],
            "stall_frac": r["input_stall_ms_per_epoch"]
            / (1e3 * r["sec_per_epoch"]),
            "step_ms_p50": r["step_time_p50_ms"],
            "step_ms_p95": r["step_time_p95_ms"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--depths", default="2,0")
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=128)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    import chip_smoke as cs
    from ddlbench_tpu_torch import cli
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.data.native_loader import generate_dataset

    if not torch.cuda.is_available():
        print("input_times: no CUDA device", file=sys.stderr)
        return 2
    cs.REAL_B, cs.REAL_STEPS = args.batch_size, args.steps
    torch.backends.cudnn.benchmark = True
    spec = DATASETS["imagenet"]
    with tempfile.TemporaryDirectory(prefix="input_times_") as tmp:
        root = Path(tmp)
        for split, n in (("train", args.steps), ("test", 2)):
            generate_dataset(str(root), spec, split,
                             count=n * args.batch_size, seed=1)
        print(json.dumps({"producer_ms_per_batch": cs.producer_costs(
            torch, root, spec)}), flush=True)
        epoch(cli, root, args, 0)
        for rnd in range(args.rounds):
            for depth in (int(d) for d in args.depths.split(",")):
                print(json.dumps({"round": rnd, "prefetch_depth": depth,
                                  "arch": args.arch,
                                  "batch": args.batch_size,
                                  **epoch(cli, root, args, depth)}),
                      flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
