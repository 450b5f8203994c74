"""LM-workload single-card microbenchmark: tokens/sec across the attention
backend and the LM-head loss.

The port of ``ddlbench_tpu/tools/lmbench.py``. It times the training step
of a token workload (``single`` strategy) per configuration and prints one
JSON line each:

    {"config": "flash+logits", "tokens_per_sec": N, "ms_per_step": N, ...}

Configurations: ``flash+logits`` (the hand-written flash kernels,
ops/flash_attention.py) and ``xla+logits`` (the plain einsum attention),
both through the materialised logits; ``auto`` (the kernels on the card,
the plain path on the CPU) on request. ``flash+fused`` and ``xla+fused``
need the fused LM-head kernels B4-B6, which are not ported yet, and are
refused.

Same flags and row keys as the reference, except ``--device`` (cuda by
default; with no card the tool raises unless ``--device cpu`` is given) in
place of ``--platform``, and ``device.provenance()`` in place of the JAX
backend record. A configuration that runs out of device memory prints an
``"error": "hbm-oom"`` row and is retried with per-layer remat.

Usage:
    python -m ddlbench_tpu_torch.tools.lmbench [-m transformer_s]
        [-b synthtext] [--batch-size 16] [--steps 20] [--dtype bfloat16]
        [--configs flash+logits,xla+logits] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ddlbench_tpu_torch.config import DATASETS, RunConfig
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models.transformer import set_attention_backend
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.tools.timing import timed_steps

# config -> (attention backend, fused head loss)
CONFIGS = {
    "flash+fused": ("flash", True),
    "flash+logits": ("flash", False),
    "xla+fused": ("xla", True),
    "xla+logits": ("xla", False),
    # the dispatch a default run gets; through the logits, the port's
    # default until B4-B6 land (the reference's auto cell is fused)
    "auto": ("auto", False),
}
DEFAULT_SWEEP = ("flash+logits", "xla+logits")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="transformer_s")
    p.add_argument("-b", "--benchmark", default="synthtext")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--label-smoothing", type=float, default=None)
    p.add_argument("--configs", default=None,
                   help="comma list among flash+logits,xla+logits,auto "
                        "(default: flash+logits,xla+logits; the fused "
                        "configs need kernels B4-B6, not ported yet)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card the tool "
                        "raises unless cpu is asked for")
    return p


def run_config(args: argparse.Namespace, name: str, remat: bool,
               device: torch.device) -> dict:
    """Time ``args.steps`` training steps of configuration ``name`` and
    return its row."""
    attn, fused = CONFIGS[name]
    cfg = RunConfig(
        benchmark=args.benchmark,
        strategy="single",
        arch=args.model,
        batch_size=args.batch_size,
        compute_dtype=args.dtype,
        attention_backend=attn,
        fused_head_loss=fused,
        remat_layers=remat,
        label_smoothing=args.label_smoothing,
        steps_per_epoch=args.steps,
    )
    strategy = make_strategy(cfg, device)
    spec = cfg.dataset()
    B = cfg.global_batch()
    data = make_synthetic(spec, B, device, steps_per_epoch=args.steps)
    lr = cfg.resolved_lr()
    dt = timed_steps(lambda x, y: strategy.train_step(x, y, lr), data.batch,
                     args.steps, args.warmup)
    tokens = args.steps * B * spec.seq_len
    return {
        "config": name,
        "model": args.model,
        "benchmark": args.benchmark,
        "batch": B,
        "seq_len": spec.seq_len,
        "remat": remat,
        "tokens_per_sec": round(tokens / dt, 1),
        "ms_per_step": round(1000 * dt / args.steps, 2),
        **provenance(device),
    }


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    token_benchmarks = sorted(n for n, s in DATASETS.items()
                              if s.kind == "tokens")
    if (args.benchmark not in DATASETS
            or DATASETS[args.benchmark].kind != "tokens"):
        p.error(f"-b {args.benchmark!r} is not a token workload; lmbench "
                f"sweeps token workloads (pick one of {token_benchmarks})")
    if args.configs:
        names = [c.strip() for c in args.configs.split(",") if c.strip()]
        unknown = [c for c in names if c not in CONFIGS]
        if unknown:
            p.error(f"unknown --configs {unknown}; choose from "
                    f"{sorted(CONFIGS)}")
        fused = [c for c in names if CONFIGS[c][1]]
        if fused:
            p.error(f"--configs {fused}: the fused LM-head loss runs kernels "
                    "B4-B6 (ops/fused_xent.py), which are not ported to "
                    "the PyTorch path yet; use flash+logits or xla+logits")
    else:
        names = list(DEFAULT_SWEEP)
    device = resolve_device(args.device)

    ok = 0
    for name in names:
        # An OOM in one configuration must not lose the others' rows:
        # record it, then retry the cell with per-layer remat, which caps
        # live activations at one layer. MoE archs are refused by
        # RunConfig.validate, so every cell may retry.
        for remat in (False, True):
            try:
                print(json.dumps(run_config(args, name, remat, device)),
                      flush=True)
                ok += 1
                break
            except torch.cuda.OutOfMemoryError as e:
                print(json.dumps({
                    "config": name, "model": args.model,
                    "benchmark": args.benchmark, "remat": remat,
                    "error": "hbm-oom",
                    "detail": str(e).splitlines()[0][:200],
                    **provenance(device),
                }), flush=True)
            finally:
                set_attention_backend("auto")
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
