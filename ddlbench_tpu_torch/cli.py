"""Training CLI of the port: the ``single`` subset of ``ddlbench_tpu/cli.py``.

    python -m ddlbench_tpu_torch.cli -b imagenet -f single -m resnet50 \\
        -e 1 --steps-per-epoch 20

trains on the card (``--device cpu`` runs on the CPU; with no card and no
``--device cpu`` it raises) and prints the reference's lines: a ``run
manifest: {...}`` line, the ``train | ...`` interval lines, ``epoch ...
done``, ``valid | ...`` and ``valid accuracy: ...`` (train/metrics.py),
then ``result: {...}``, the summary as JSON.

    python -m ddlbench_tpu_torch.cli -b imagenet -f single -m resnet50 -s \
        --data-dir D -e 1 --steps-per-epoch 20

trains on on-disk data (``-s``): for a seq2seq benchmark a parallel
corpus (``train.src``/``train.tgt``) under ``--data-dir``, for a token
benchmark a text corpus (``train.txt``), both tokenized with a BPE
vocabulary trained on the corpus and cached beside it; otherwise a store
or a recognised image layout (ImageFolder, MNIST IDX, CIFAR-10 batches)
there, else a synthetic store generated there, read by the native
loader, augmented on the device (images; ``--no-augment`` turns that
off) and prefetched ``--prefetch-depth`` batches ahead (2;
``--no-prefetch`` is 0).

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_moe_s \
        -e 1 --steps-per-epoch 20 --moe-capacity-factor 1.25

The reference's defaults (mnist, single, resnet18, 3 epochs, log interval
25, seed 1, bfloat16) and the knobs the loop reads (``-e -p
--batch-size --steps-per-epoch --grad-accum-steps --lr --optimizer
--dtype --seed --jsonl``, the data flags above and the token knobs
``--label-smoothing --attention-backend --no-fused-head-loss
--remat-layers --moe-aux-weight --moe-capacity-factor``, with the
reference's defaults); ``--device`` stands in for ``--platform``;
``--momentum`` and ``--weight-decay`` override the per-workload defaults.
Every other flag of the reference is refused by name (an error naming it),
never ignored; so are ``-f`` strategies other than ``single`` and the
arches the port does not build (RunConfig.validate, models/zoo.py).
"""

from __future__ import annotations

import argparse
import json
import sys

from ddlbench_tpu_torch.config import ATTENTION_BACKENDS, DATASETS, RunConfig
from ddlbench_tpu_torch.models.zoo import MODEL_NAMES

# the reference's strategies: all but "single" raise NotImplementedError
STRATEGIES = ("single", "dp", "gpipe", "pipedream", "sp", "tp", "fsdp", "ep")

# the reference's flags the port does not carry
NOT_PORTED_FLAGS = (
    ("-g", "--devices"), ("--micro-batch-size",), ("--num-microbatches",), ("--stages",),
    ("--virtual-stages",), ("--pipe-schedule",), ("--zb-h2-stash",),
    ("--sched-search-budget",), ("--sched-search-seed",), ("--pipe-costs",),
    ("--schedule-trace",), ("--dp-replicas",), ("--tp-size",),
    ("--stage-replication",), ("--update-interval",),
    ("--shard-opt-state",), ("--dp-shard-update",), ("--allreduce-dtype",),
    ("--comm-buckets",), ("--warmup-epochs",), ("--auto-partition",), ("--plan",), ("--plan-bounds",), ("--hbm-gb",),
    ("--profile-mode",), ("--trace-dir",), ("--xla-trace-steps",),
    ("--trace",), ("--trace-capacity",), ("--audit",), ("--checkpoint-dir",),
    ("--resume",), ("--checkpoint-every-steps",), ("--keep-checkpoints",),
    ("--elastic-resume",), ("--elastic-slices",), ("--inject",),
    ("--anomaly-policy",), ("--anomaly-budget",), ("--loss-scale",),
    ("--grad-spike-factor",), ("--nan-policy",), ("--hang-timeout-s",),
    ("--log-activations-dir",), ("--log-activations-freq",),
    ("--log-activations-steps",), ("--platform",),
)


class _NotPorted(argparse.Action):
    """A reference flag the port lacks: using it is an error naming it."""

    def __call__(self, parser, namespace, values, option_string=None):
        hint = " (use --device)" if option_string == "--platform" else ""
        parser.error(f"{option_string} is not ported to the PyTorch "
                     f"training path yet{hint}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ddlbench_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter,
                                allow_abbrev=False)
    p.add_argument("-b", "--benchmark", default="mnist",
                   choices=sorted(DATASETS))
    p.add_argument("-f", "--framework", default="single", choices=STRATEGIES,
                   help="strategy (only single is ported)")
    p.add_argument("-m", "--model", default="resnet18",
                   choices=MODEL_NAMES)
    p.add_argument("-p", "--log-interval", type=int, default=25)
    p.add_argument("-s", "--real-data", action="store_true",
                   help="on-disk data through the native loader")
    p.add_argument("--data-dir", default=None,
                   help="on-disk dataset root (-s; ./data when unset)")
    p.add_argument("--no-augment", action="store_true",
                   help="no training augmentation in -s mode")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches made ahead of the step by a producer "
                        "thread; 0 = inline")
    p.add_argument("--no-prefetch", action="store_true",
                   help="--prefetch-depth 0")
    p.add_argument("-e", "--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="micro-steps of --batch-size rows per update")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optimizer", default=None, choices=("sgd", "adam"))
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="MoE router load-balance loss weight (MoE archs)")
    p.add_argument("--moe-capacity-factor", type=float, default=1.25,
                   help="MoE expert capacity = ceil(cf * tokens / experts)")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="training-objective label smoothing (default: 0.1 "
                        "for seq2seq benchmarks — GNMT parity — else 0)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--attention-backend", default="auto",
                   choices=ATTENTION_BACKENDS,
                   help="auto = the flash kernels where they take the "
                        "operands (a CUDA device, head dim 64)")
    p.add_argument("--no-fused-head-loss", action="store_true",
                   help="disable the fused LM-head projection+cross-entropy "
                        "(materialize full logits instead)")
    p.add_argument("--remat-layers", action="store_true",
                   help="checkpoint every layer (recompute activations in "
                        "the backward; token models, not MoE)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--jsonl", default=None,
                   help="also write the metric records here, one JSON "
                        "object a line")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card the run "
                        "raises unless cpu is asked for")
    for flags in NOT_PORTED_FLAGS:
        p.add_argument(*flags, nargs="*", action=_NotPorted,
                       default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    return p


def config_from_args(args: argparse.Namespace) -> RunConfig:
    return RunConfig(
        benchmark=args.benchmark, strategy=args.framework, arch=args.model,
        epochs=args.epochs, log_interval=args.log_interval,
        batch_size=args.batch_size, steps_per_epoch=args.steps_per_epoch,
        lr=args.lr, optimizer=args.optimizer, momentum=args.momentum,
        weight_decay=args.weight_decay, compute_dtype=args.dtype,
        seed=args.seed, synthetic=not args.real_data,
        data_dir=args.data_dir, augment=not args.no_augment,
        prefetch_depth=0 if args.no_prefetch else args.prefetch_depth,
        grad_accum_steps=args.grad_accum_steps,
        moe_aux_weight=args.moe_aux_weight,
        moe_capacity_factor=args.moe_capacity_factor,
        label_smoothing=args.label_smoothing,
        attention_backend=args.attention_backend,
        fused_head_loss=not args.no_fused_head_loss,
        remat_layers=args.remat_layers)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    cfg.validate()

    from ddlbench_tpu_torch.device import resolve_device
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import run_benchmark
    from ddlbench_tpu_torch.train.metrics import MetricLogger

    device = resolve_device(args.device)
    print("run manifest: " + json.dumps(vars(args)), flush=True)
    logger = MetricLogger(cfg.epochs, cfg.log_interval,
                          jsonl_path=args.jsonl, device=device)
    try:
        result = run_benchmark(cfg, make_strategy(cfg, device), logger)
    finally:
        logger.close()
    print("result: " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
