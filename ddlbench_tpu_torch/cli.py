"""Training CLI of the port: the ``single``, ``dp``, ``gpipe``,
``pipedream``, ``sp``, ``ep`` and ``fsdp`` subset of
``ddlbench_tpu/cli.py``.

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

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f dp \
        -g 4 -e 1 --steps-per-epoch 20 --dp-shard-update --comm-buckets 4

trains data-parallel on ``-g`` ranks, one process each (NCCL, rank r on
card r; ``--device cpu``: gloo ranks on the CPU); a machine with fewer
cards than ``-g`` is an error. Rank 0 prints the lines; ``result:`` is its
summary.

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f sp \
        -g 2 -e 1 --steps-per-epoch 20
    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_moe_s \
        -f ep -g 2 -e 1 --steps-per-epoch 20
    python -m ddlbench_tpu_torch.cli -b imagenet -m resnet50 -f fsdp -g 2 \
        -e 1 --steps-per-epoch 20
    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f tp \
        -g 2 -e 1 --steps-per-epoch 20

run the sharded one-program strategies on ``-g`` ranks in the same way:
``sp`` splits every sequence over the ranks (ring attention; token and
seq2seq benchmarks), ``ep`` splits the batch and every MoE block's
experts (MoE arches), ``fsdp`` splits the batch and every parameter and
its optimizer state (ZeRO-3; not MoE arches), ``tp`` replicates the
batch and slices every transformer block Megatron's way, every other
parameter split and gathered on use (parallel/sharded.py). Their
learning rate is not scaled by the world (the reference scales only
dp's).

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f gpipe \
        -g 4 -e 1 --steps-per-epoch 20 --pipe-schedule zero-bubble
    python -m ddlbench_tpu_torch.cli -b imagenet -m resnet50 -f pipedream \
        -g 4 -e 1 --steps-per-epoch 20

trains a pipeline of ``-g`` stages in one process, stage s on card s
(``--device cpu``: every stage on the CPU; fewer cards than stages is an
error), with the reference's batch grammar (``--micro-batch-size``,
``--num-microbatches``; pipedream's ``--batch-size`` is the global
batch), ``--virtual-stages``, ``--pipe-schedule`` (gpipe: fill-drain,
1f1b, interleaved, zero-bubble, zero-bubble-h2 with ``--zb-h2-stash``,
searched with ``--sched-search-budget`` and ``--sched-search-seed``),
pipedream's ``--update-interval`` and ``--plan-bounds``. gpipe prints the
reference's schedule-advisor lines first. ``-f gpipe --tp-size N`` (token
and seq2seq benchmarks, fill-drain, ``-g`` = stages x N) runs tpp: one
process a tensor-parallel shard, each walking every stage, the
transformer blocks Megatron-sliced (parallel/tpp.py; the unfused CE
head); with ``--dp-replicas R`` as well (``-g`` = R x stages x N) 3-D
tpp, one process a shard of a replica. ``--schedule-trace`` is the
reference's flag with its default; away from it the run is refused,
naming the ROADMAP item (A.8).

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f gpipe \
        -g 4 -e 1 --steps-per-epoch 20 --auto-partition \
        --pipe-schedule 1f1b --pipe-costs profile
    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s -f gpipe \
        -g 4 -e 1 --steps-per-epoch 20 --plan auto

``--auto-partition`` profiles the model (``--profile-mode flops``:
FLOPs over the card's peak, or ``time``: timed on the card) and runs the
hierarchical partitioner's plan ("auto-partition: executing plan ...";
a uniform plan's replicas are ranks of the hybrid, an uneven plan runs
the hetero strategies in one process), with ``--pipe-costs profile``
on a timetable weighted by the plan's per-chunk costs. ``--plan auto``
(-f gpipe, the mix flags unset) solves the dp/pp/tp mix, split and
schedule under ``--hbm-gb`` per card and runs the winner ("plan auto:
executing pp=..."). Both are solved here, once, before any rank starts.
``--log-activations-dir D`` writes the first ``--log-activations-steps``
steps' activations and gradients every ``--log-activations-freq``
epochs (single, dp, sp).

    python -m ddlbench_tpu_torch.cli -b synthtext -m transformer_s \
        -e 2 --steps-per-epoch 20 --checkpoint-dir D \
        --checkpoint-every-steps 5 --keep-checkpoints 3 --resume

commits a checkpoint under ``--checkpoint-dir`` after every epoch and
every ``--checkpoint-every-steps`` steps (train/checkpoint.py: atomic,
manifest-verified), keeps the newest ``--keep-checkpoints``, and with
``--resume`` continues from the newest valid one ("resumed from D epoch
N", a validation of the restored state, then the next epoch; a step
checkpoint resumes mid-epoch), on every strategy. ``-f dp
--dp-shard-update --elastic-slices E`` reduces in E world-invariant
slices, and ``--elastic-resume`` reshards a checkpoint saved at another
world (train/reshard.py) instead of refusing it.

The reference's defaults (mnist, single, resnet18, 3 epochs, log interval
25, seed 1, bfloat16) and the knobs the loop reads (``-e -p
--batch-size --steps-per-epoch --grad-accum-steps --lr --optimizer
--dtype --seed --jsonl``, the data flags above, the token knobs
``--label-smoothing --attention-backend --no-fused-head-loss
--remat-layers --moe-aux-weight --moe-capacity-factor`` and the dp knobs
``-g --dp-shard-update --allreduce-dtype --comm-buckets
--shard-opt-state --warmup-epochs`` and the pipeline and checkpoint
flags above, with the reference's defaults);
``--device`` stands in for ``--platform``; ``--momentum`` and
``--weight-decay`` override the per-workload defaults. Every other flag
of the reference is refused by name (an error naming it), never ignored;
so are the arches the port does not build (RunConfig.validate,
models/zoo.py).
"""

from __future__ import annotations

import argparse
import json
import sys

from ddlbench_tpu_torch.config import (ATTENTION_BACKENDS, DATASETS,
                                      HardwareModel, RunConfig)
from ddlbench_tpu_torch.models.zoo import MODEL_NAMES
from ddlbench_tpu_torch.partition.schedule import PIPE_SCHEDULES

# the reference's strategies
STRATEGIES = ("single", "dp", "gpipe", "pipedream", "sp", "tp", "fsdp", "ep")

# the reference's flags the port does not carry
NOT_PORTED_FLAGS = (
    ("--trace-dir",), ("--xla-trace-steps",),
    ("--trace",), ("--trace-capacity",), ("--audit",), ("--inject",),
    ("--anomaly-policy",), ("--anomaly-budget",), ("--loss-scale",),
    ("--grad-spike-factor",), ("--nan-policy",), ("--hang-timeout-s",),
    ("--platform",),
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
                   help="strategy")
    p.add_argument("-g", "--devices", type=int, default=1,
                   help="ranks of -f dp/sp/ep/fsdp, one process and one "
                        "card each; "
                        "stages x dp-replicas x tp-size of a pipeline, "
                        "one card a stage")
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
    p.add_argument("--micro-batch-size", type=int, default=None)
    p.add_argument("--num-microbatches", type=int, default=None)
    p.add_argument("--stages", type=int, default=None)
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved layout (gpipe or pipedream): model "
                        "chunks per stage")
    p.add_argument("--pipe-schedule", default="fill-drain",
                   choices=PIPE_SCHEDULES,
                   help="gpipe's timetable: fill-drain (GPipe flush), or "
                        "an event schedule (1f1b, interleaved, zero-bubble, "
                        "zero-bubble-h2, searched; "
                        "parallel/pipeline_rt.py)")
    p.add_argument("--zb-h2-stash", type=int, default=1,
                   help="zero-bubble-h2's extra in-flight microbatches "
                        "per chunk")
    p.add_argument("--sched-search-budget", type=int, default=256,
                   help="searched schedule's move-evaluation budget")
    p.add_argument("--sched-search-seed", type=int, default=0,
                   help="searched schedule's rng seed")
    p.add_argument("--pipe-costs", default="unit", choices=("unit", "profile"),
                   help="timetable cost model of the event schedules: "
                        "unit = F=B=W half-ticks; profile = per-chunk "
                        "F/B/W cost vectors summed from the "
                        "--auto-partition profile over the chosen bounds")
    p.add_argument("--schedule-trace", default=None, metavar="PATH",
                   help="measured-bubble advice (ROADMAP A.8)")
    p.add_argument("--dp-replicas", type=int, default=1,
                   help="hybrid PP x DP: replicas of every stage, one rank "
                        "each (-g = replicas x stages; with --tp-size N "
                        "3-D tpp, -g = replicas x stages x N)")
    p.add_argument("--tp-size", type=int, default=1,
                   help="tensor x pipeline parallelism (gpipe, fill-drain)")
    p.add_argument("--stage-replication", default=None, metavar="R0,R1,...",
                   help="replicas per stage (-g = their sum): uniform runs "
                        "the hybrid, uneven the hetero pipeline")
    p.add_argument("--update-interval", type=int, default=1,
                   help="pipedream macrobatch: microbatches per update")
    p.add_argument("--plan-bounds", default=None, metavar="0,K,...,L",
                   help="explicit per-chunk layer bounds of a pipeline "
                        "(stages x virtual-stages + 1 ints from 0)")
    p.add_argument("--auto-partition", action="store_true",
                   help="profile + hierarchical partitioner choose stage "
                        "bounds and replication (gpipe, pipedream)")
    p.add_argument("--plan", default="manual", choices=("manual", "auto"),
                   help="auto = solve the dp/pp/tp mix + stage split + "
                        "schedule from the profile under the per-card "
                        "memory cap and run the winner; pass -f gpipe and "
                        "leave the mix flags unset")
    p.add_argument("--hbm-gb", type=float, default=None, metavar="G",
                   help="per-card memory budget in GiB for the planner / "
                        "auto-partition feasibility gates (default: the "
                        "HardwareModel's 80 GB H100 figure)")
    p.add_argument("--profile-mode", default="flops",
                   choices=("flops", "time"))
    p.add_argument("--log-activations-dir", default=None,
                   help="write per-layer activations and their loss "
                        "gradients as npz files here")
    p.add_argument("--log-activations-freq", type=int, default=1,
                   help="log every N epochs")
    p.add_argument("--log-activations-steps", type=int, default=1,
                   help="log the first N steps of a logged epoch")
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
    p.add_argument("--shard-opt-state", action="store_true",
                   help="ZeRO-1 on dp: shard optimizer state over the ranks "
                        "(params stay replicated)")
    p.add_argument("--dp-shard-update", action="store_true",
                   help="explicit sharded weight update (ZeRO-1): "
                        "reduce-scatter grads and update a 1/world slice of "
                        "the packed params and optimizer state per rank")
    p.add_argument("--allreduce-dtype", default="f32",
                   choices=("f32", "float32", "bf16", "bfloat16", "int8"),
                   help="wire dtype of dp's gradient collectives (int8: "
                        "global-absmax scaling and stochastic rounding)")
    p.add_argument("--comm-buckets", type=int, default=1, metavar="K",
                   help="split the packed flat gradient into K "
                        "layer-aligned buckets, one collective each; with "
                        "--dp-shard-update the params stay sharded between "
                        "steps and each bucket is all-gathered before the "
                        "forward")
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="gradual lr warmup epochs (Horovod ImageNet parity: "
                        "base lr -> base*world over this many epochs)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save a checkpoint per epoch here (torch.save, "
                        "atomic commit protocol)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest VALID checkpoint in "
                        "--checkpoint-dir (torn/corrupt ones are skipped); "
                        "an empty dir warns and starts fresh")
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   metavar="K",
                   help="also commit a mid-epoch checkpoint every K steps "
                        "(full resume state: bitwise mid-epoch resume)")
    p.add_argument("--keep-checkpoints", type=int, default=None, metavar="N",
                   help="retain only the newest N committed checkpoints "
                        "(older ones + stale .tmp dirs are GC'd)")
    p.add_argument("--elastic-resume", action="store_true",
                   help="topology-portable resume (train/reshard.py): when "
                        "the checkpoint's recorded world shape mismatches "
                        "the current one, reshard the ZeRO-1 flat state "
                        "between world sizes (pure permutation, f32 "
                        "bitwise) instead of raising CheckpointShapeError; "
                        "lr world-scaling stays pinned to the launch world")
    p.add_argument("--elastic-slices", type=int, default=None, metavar="E",
                   help="world-invariant reduction order for -f dp "
                        "--dp-shard-update: gradients computed in E fixed "
                        "slices of the global batch and reduced over a "
                        "canonical balanced tree (+ butterfly allreduce), "
                        "so a run checkpointed at world N resumes at world "
                        "M with BITWISE-identical f32 trajectories (E a "
                        "power of two divisible by every world it runs on)")
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
        num_devices=args.devices, epochs=args.epochs,
        log_interval=args.log_interval,
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
        remat_layers=args.remat_layers, shard_opt_state=args.shard_opt_state,
        dp_shard_update=args.dp_shard_update,
        allreduce_dtype=args.allreduce_dtype,
        comm_buckets=args.comm_buckets, warmup_epochs=args.warmup_epochs,
        micro_batch_size=args.micro_batch_size,
        num_microbatches=args.num_microbatches, num_stages=args.stages,
        virtual_stages=args.virtual_stages,
        pipe_schedule=args.pipe_schedule, zb_h2_stash=args.zb_h2_stash,
        sched_search_budget=args.sched_search_budget,
        sched_search_seed=args.sched_search_seed,
        pipe_costs=args.pipe_costs, schedule_trace=args.schedule_trace,
        dp_replicas=args.dp_replicas, tp_size=args.tp_size,
        stage_replication=(tuple(int(r) for r in
                                 args.stage_replication.split(","))
                           if args.stage_replication else None),
        update_interval=args.update_interval,
        plan_bounds=(tuple(int(b) for b in args.plan_bounds.split(","))
                     if args.plan_bounds else None),
        auto_partition=args.auto_partition, plan=args.plan,
        profile_mode=args.profile_mode,
        hardware=(HardwareModel(hbm_bytes=args.hbm_gb * 1024**3)
                  if args.hbm_gb is not None else HardwareModel()),
        activation_log_dir=args.log_activations_dir,
        activation_log_freq=args.log_activations_freq,
        activation_log_steps=args.log_activations_steps,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        checkpoint_every_steps=args.checkpoint_every_steps,
        keep_checkpoints=args.keep_checkpoints,
        elastic_resume=args.elastic_resume,
        elastic_slices=args.elastic_slices)


def _train_rank(comm, cfg: RunConfig, jsonl: str, device=None,
                partition=None) -> dict:
    """The run of :func:`main` on ``device``, or on rank ``comm`` (a
    spawned process): its strategy (at the auto-partition plan
    ``partition`` when given), the loop, its summary (rank 0's is
    printed)."""
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import run_benchmark
    from ddlbench_tpu_torch.train.metrics import MetricLogger

    if comm is not None:
        device = comm.device
    logger = MetricLogger(cfg.epochs, cfg.log_interval, jsonl_path=jsonl,
                          device=device, rank=comm.rank if comm else 0)
    try:
        return run_benchmark(cfg, make_strategy(cfg, device, comm,
                                                partition=partition), logger)
    finally:
        logger.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    cfg.validate()

    from ddlbench_tpu_torch import distributed
    from ddlbench_tpu_torch.device import resolve_device
    from ddlbench_tpu_torch.train.loop import prepare_run

    def world(cfg):
        # a hybrid pipeline's replica holds its stages' cards
        # (distributed.hybrid_stage_devices), a tpp rank its stages' of
        # one shard (tp_stage_devices, tpp3d_stage_devices): its group on
        # the first
        ranks = cfg.spawned_ranks()
        pipe = ranks and cfg.strategy in ("gpipe", "pipedream")
        stride = cfg.resolved_stages() if pipe else 1
        tp = cfg.tp_size if pipe else 1
        if ranks:
            distributed.check_world(args.device or "cuda", ranks,
                                    stride=stride, tp=tp)
        return ranks, stride, tp

    world(cfg)
    device = resolve_device(args.device)
    print("run manifest: " + json.dumps(vars(args)), flush=True)
    # --plan auto and --auto-partition decide how many ranks run: solved
    # here, once, and handed to every rank
    cfg, partition = prepare_run(cfg, device)
    ranks, stride, tp = world(cfg)
    if ranks:
        result = distributed.spawn(_train_rank, ranks, device.type,
                                   args=(cfg, args.jsonl, None, partition),
                                   stride=stride, tp=tp)[0]
    else:
        result = _train_rank(None, cfg, args.jsonl, device, partition)
    print("result: " + json.dumps(result), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
