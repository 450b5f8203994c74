"""LM-workload single-card microbenchmark: tokens/sec across the attention
backend and the LM-head loss.

The port of ``ddlbench_tpu/tools/lmbench.py``. It times the training step
of a token workload (``single`` strategy) per configuration and prints one
JSON line each:

    {"config": "flash+logits", "tokens_per_sec": N, "ms_per_step": N, ...}

Configurations, attention backend x LM-head loss: ``flash`` (the
hand-written flash kernels, ops/flash_attention.py) or ``xla`` (the plain
einsum attention), each with ``fused`` (the fused projection + CE kernels,
ops/fused_xent.py, no [B*T, V] logits) or ``logits`` (the materialised
logits). The default sweep is the four forced cells; ``auto`` (the
dispatch a default run gets: the kernels for CUDA tensors, the plain
versions for CPU tensors, and the fused head) on request. Token (synthtext,
longctx, longctx32k) and seq2seq (synthmt) benchmarks.

Same flags and row keys as the reference, except ``--device`` (cuda by
default; with no card the tool raises unless ``--device cpu`` is given) in
place of ``--platform``, and ``device.provenance()`` in place of the JAX
backend record. A configuration that runs out of device memory prints an
``"error": "hbm-oom"`` row and is retried with per-layer remat. Each row
also carries ``plain_launches``: the attention calls of the run that took
the plain path on CUDA tensors the flash kernels refuse (``auto`` with a
head dim they do not take; 0 on the CPU).

Usage:
    python -m ddlbench_tpu_torch.tools.lmbench [-m transformer_s]
        [-b synthtext] [--batch-size 16] [--steps 20] [--dtype bfloat16]
        [--configs flash+fused,flash+logits] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ddlbench_tpu_torch.config import DATASETS, STREAM_KINDS, RunConfig
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models.transformer import set_attention_backend
from ddlbench_tpu_torch.ops.flash_attention import flash_attention
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.tools.timing import timed_steps

# config -> (attention backend, fused head loss)
CONFIGS = {
    "flash+fused": ("flash", True),
    "flash+logits": ("flash", False),
    "xla+fused": ("xla", True),
    "xla+logits": ("xla", False),
    # the dispatch a default run gets, with the fused head (not in the
    # default sweep: it duplicates one of the forced cells)
    "auto": ("auto", True),
}
DEFAULT_SWEEP = ("flash+fused", "flash+logits", "xla+fused", "xla+logits")


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
                   help="comma list among flash+fused,flash+logits,"
                        "xla+fused,xla+logits,auto (default: the four "
                        "forced cells)")
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
    plain0 = flash_attention.plain_launches
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
        "plain_launches": flash_attention.plain_launches - plain0,
        **provenance(device),
    }


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    token_benchmarks = sorted(n for n, s in DATASETS.items()
                              if s.kind in STREAM_KINDS)
    if (args.benchmark not in DATASETS
            or DATASETS[args.benchmark].kind not in STREAM_KINDS):
        p.error(f"-b {args.benchmark!r} is not a token workload; lmbench "
                f"sweeps token workloads (pick one of {token_benchmarks})")
    if args.configs:
        names = [c.strip() for c in args.configs.split(",") if c.strip()]
        unknown = [c for c in names if c not in CONFIGS]
        if unknown:
            p.error(f"unknown --configs {unknown}; choose from "
                    f"{sorted(CONFIGS)}")
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
