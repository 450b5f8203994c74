"""Headline benchmark of the port: image-training throughput on one card
(``bench.py``'s counterpart).

    python -m ddlbench_tpu_torch.tools.bench [--arch resnet50]
        [--benchmark imagenet] [--batch-size 128] [--steps 30]
        [--warmup 5] [--repeats 3] [--dtype bfloat16] [--prefetch-depth 2]
        [--quick] [--device cpu]

prints one JSON line with ``bench.py``'s record fields:

    {"metric": "resnet50_imagenet_images_per_sec_per_chip", "value": N,
     "unit": "images/sec", "vs_baseline": N / 200, ...}

``vs_baseline`` divides by 200 images/sec, the figure bench.py takes for
the reference's GTX 1080 Ti. The value is the median of ``--repeats``
timed loops of one epoch of ``--steps`` chained train steps
(tools/timing.py ``timed_steps_prefetched``), each after ``--warmup``
steps outside the clock, and the record keeps that loop's own input
stall (the time it waited for batches), stall fraction and device
step-time p50/p95. The synthetic batches are made on the device by the
input pipeline (data/prefetch.py), ``--prefetch-depth`` batches ahead on
a producer thread and a side CUDA stream (2, as bench.py; 0 makes each
inline in the timed loop). The step trains bfloat16 activations on
float32 master weights (the default ``--dtype``), channels_last on the
card, with ``cudnn.benchmark`` on there (the record says so). ``--quick``
is batch 32, 5 steps, 2 warm-up. Without a card the tool raises unless
``--device cpu`` is given. The reference's flags the port lacks (``-g``,
the dp engine's, ``--probe-timeout-s``, ``--audit``) are refused by
name.
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys

import torch

from ddlbench_tpu_torch.cli import _NotPorted
from ddlbench_tpu_torch.config import DATASETS, RunConfig
from ddlbench_tpu_torch.data.prefetch import Prefetcher
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.telemetry.stats import percentile
from ddlbench_tpu_torch.tools.timing import timed_steps_prefetched

REFERENCE_1080TI_RESNET50_IPS = 200.0
NOT_PORTED_FLAGS = (("-g", "--devices"), ("--dp-shard-update",),
                    ("--allreduce-dtype",), ("--comm-buckets",),
                    ("--probe-timeout-s",),
                    ("--audit",))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--benchmark", default="imagenet")
    p.add_argument("-f", "--framework", default="single",
                   choices=("single", "dp"), help="only single is ported")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches made ahead of the step (data/prefetch.py)"
                        "; 0 = inline")
    p.add_argument("--quick", action="store_true",
                   help="batch 32, 5 steps, 2 warm-up")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card the tool "
                        "raises unless cpu is asked for")
    for flags in NOT_PORTED_FLAGS:
        p.add_argument(*flags, nargs="*", action=_NotPorted,
                       default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    return p


def run(args: argparse.Namespace, device: torch.device) -> dict:
    """Time the step and return the record."""
    cfg = RunConfig(benchmark=args.benchmark, strategy=args.framework,
                    arch=args.arch, batch_size=args.batch_size,
                    compute_dtype=args.dtype, steps_per_epoch=args.steps)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True
    strategy = make_strategy(cfg, device)
    B = cfg.global_batch()
    data = make_synthetic(cfg.dataset(), B, device, seed=cfg.seed,
                          steps_per_epoch=args.steps)
    lr = cfg.resolved_lr()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prefetcher = Prefetcher(data, depth=args.prefetch_depth)
    runs = sorted((timed_steps_prefetched(
        lambda x, y: strategy.train_step(x, y, lr), prefetcher, args.warmup)
        for _ in range(max(1, args.repeats))), key=lambda r: r[0])
    # the median run, with its own stall and step times
    dt, stall_s, steps, step_s = runs[len(runs) // 2]
    ips = steps * B / dt
    step_ms = [t * 1e3 for t in step_s]
    return {
        "metric": f"{args.arch}_{args.benchmark}_images_per_sec_per_chip",
        "value": ips,
        "unit": "images/sec",
        "vs_baseline": ips / REFERENCE_1080TI_RESNET50_IPS,
        "input_stall_ms_per_epoch": stall_s * 1e3,
        "step_time_p50_ms": percentile(step_ms, 50),
        "step_time_p95_ms": percentile(step_ms, 95),
        "stall_frac": stall_s / dt if dt else 0.0,
        "prefetch_depth": args.prefetch_depth,
        "strategy": args.framework,
        "devices": 1,
        "batch": B,
        "steps": steps,
        "warmup": args.warmup,
        "repeats": len(runs),
        "run_seconds": [r[0] for r in runs],
        "dtype": args.dtype,
        "channels_last": on_card,
        "cudnn_benchmark": torch.backends.cudnn.benchmark if on_card
        else None,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if on_card else None),
        **provenance(device),
        "measured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.quick:
        args.batch_size, args.steps, args.warmup = 32, 5, 2
    if (args.benchmark not in DATASETS
            or DATASETS[args.benchmark].kind != "image"):
        image = sorted(n for n, s in DATASETS.items() if s.kind == "image")
        p.error(f"--benchmark {args.benchmark!r} is not an image workload "
                f"(pick one of {image})")
    print(json.dumps(run(args, resolve_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
