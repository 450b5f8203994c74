"""The benchmark training loop (the core of ``ddlbench_tpu/train/loop.py``
``run_benchmark``, ``_run_benchmark``, ``_make_data`` and ``evaluate``).

The data is synthetic (made on the device) or, with ``cfg.synthetic``
False, read from ``cfg.data_dir`` as the reference's ``_make_data``
reads it: a parallel corpus (train.src/train.tgt) for a seq2seq
benchmark (data/translation.py), a text corpus (train.txt) for a token
benchmark (data/textcorpus.py), else a store through the native loader
(data/ondisk.py: images, or token ids). ``run_benchmark`` warms the step up on a
throwaway copy of the state, restores the initial weights, running
statistics and a fresh optimizer, then runs ``cfg.epochs`` epochs of
``steps_per_epoch`` steps at the step-decay learning rate
(``lr_step_gamma`` every ``lr_step_epochs`` epochs), logging every
``log_interval`` steps and at the epoch's end, and validates once per
epoch on the test split. A pipeline's step takes micro_batch_size x
num_microbatches rows (``cfg.global_batch``) and makes its own updates
(one a step, or one a microbatch under pipedream) at the rate it is
given. Under ``dp`` with SGD the base rate is scaled by
the world and by ``grad_accum_steps`` (Horovod's linear scaling, the
reference's ``_scaled_lr``; Adam's is not), ``warmup_epochs`` ramps it per
step (``gradual_warmup_lr``), every rank makes the same global batch and
trains on its rows of it (parallel/dp.py), throughput counts the global
batch, and only rank 0 prints. Each run prints the reference's ``comm
volume/step`` line (train/comm_stats.py). Losses are summed on the
device and read once per log interval, so the host waits for the card
only there; a non-finite interval loss stops the run (the reference's
default ``nan_policy``).

The warm-up reads the source's batch (0, 0), as the reference does,
unless the source is a sequential stream (``stateful_stream``: the
on-disk stores), where a warm-up batch would shift every batch of the run
by one: it then reads epoch 0's first synthetic batch of the run's shape.

Batches come through the prefetcher (data/prefetch.py), ``prefetch_depth``
ahead of the step on a producer thread (0: inline). The input stall is
the time the loop waited for a batch; per step the loop records the wall
time of its body, the wait excluded, for the p50/p95 fields (between
syncs, the host's dispatch time, as in the reference).

``--plan auto`` and ``--auto-partition`` are resolved before the data
stream is built (:func:`prepare_run`); on on-disk data the loader's
fetch cost is measured on a throwaway source and priced into the plan
(per microbatch), the plan's probe only where it is solved. With
``activation_log_dir`` the loop logs the first steps' activations and
gradients (profiler/actlog.py) under single, dp and sp, before the step.
Tracing, checkpoints, the watchdog, the guard and preemption are not
ported: RunConfig.validate refuses their knobs.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ddlbench_tpu_torch.config import PIPELINE_STRATEGIES, RunConfig
from ddlbench_tpu_torch.data.prefetch import Prefetcher
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.device import resolve_device
from ddlbench_tpu_torch.parallel.api import (AutoPartition, auto_partition,
                                             make_strategy)
from ddlbench_tpu_torch.parallel.common import (gradual_warmup_lr,
                                                step_decay_lr)
from ddlbench_tpu_torch.parallel.dp import DPStrategy
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.telemetry.stats import latency_summary
from ddlbench_tpu_torch.train.comm_stats import comm_line, comm_stats
from ddlbench_tpu_torch.train.metrics import MetricLogger

Strategy = Union[SingleStrategy, DPStrategy, GPipeStrategy]


def _device_of(strategy: Strategy) -> torch.device:
    """Where the batches are made: the model's first layer's device (a
    pipeline's first stage)."""
    return next(strategy.model.parameters()).device


def _rank(strategy: Strategy) -> int:
    """The strategy's rank in the whole run (rank 0 prints): 3-D tpp's
    is its replica's (``comm``, the data group) times tp plus its
    shard's (``tp_comm``)."""
    comm = getattr(strategy, "comm", None)
    rank = comm.rank if comm is not None else 0
    tp_comm = getattr(strategy, "tp_comm", None)
    if tp_comm is not None and tp_comm is not comm:
        rank = rank * tp_comm.world + tp_comm.rank
    return rank


def scaled_lr(cfg: RunConfig, world: int) -> Tuple[float, int]:
    """(the base learning rate, the warmup's world): under dp with SGD
    and ``scale_lr_by_world`` the rate x world x grad_accum_steps and the
    warmup ramping over ``world``, else the rate as configured and a
    world of 1 (the warmup is then the identity), as the reference's
    ``_scaled_lr``."""
    lr = cfg.resolved_lr()
    if (cfg.strategy == "dp" and cfg.scale_lr_by_world
            and cfg.resolved_optimizer() == "sgd"):
        return lr * world * cfg.grad_accum_steps, world
    return lr, 1


def make_data(cfg: RunConfig, device: torch.device, verbose: bool = True):
    """The run's data source: synthetic; or under ``cfg.data_dir`` a
    parallel corpus (seq2seq benchmarks) or a text corpus (token
    benchmarks), each printing the reference's line about it; else the
    on-disk store under ``cfg.data_dir`` ("./data" when None), images in
    the compute dtype. A store generated there holds ``steps_per_epoch``
    batches of train and a fifth as many (at least one batch) of test
    samples."""
    B, spec = cfg.global_batch(), cfg.dataset()
    say = print if verbose else (lambda *a, **k: None)
    if cfg.synthetic:
        return make_synthetic(spec, B, device, seed=cfg.seed,
                              steps_per_epoch=cfg.steps_per_epoch)
    if spec.kind == "seq2seq" and cfg.data_dir:
        from ddlbench_tpu_torch.data.translation import (
            TranslationData, find_parallel_corpus)

        if find_parallel_corpus(cfg.data_dir, "train"):
            data = TranslationData(cfg.data_dir, spec, B, device,
                                   seed=cfg.seed,
                                   steps_per_epoch=cfg.steps_per_epoch)
            rep = data.bucketing_report()
            say(f"translation data: vocab {data.tokenizer.vocab_size}, "
                f"padding efficiency {rep['fixed_efficiency']:.3f} fixed "
                f"vs {rep['bucketed_efficiency']:.3f} bucketed "
                f"({rep['num_compiles_bucketed']} bucket compiles)",
                flush=True)
            return data
    if spec.kind == "tokens" and cfg.data_dir:
        from ddlbench_tpu_torch.data.textcorpus import (TextCorpusData,
                                                        find_text_corpus)

        if find_text_corpus(cfg.data_dir, "train"):
            data = TextCorpusData(cfg.data_dir, spec, B, device,
                                  seed=cfg.seed,
                                  steps_per_epoch=cfg.steps_per_epoch)
            say(f"text corpus: {data.num_tokens} tokens, vocab "
                f"{data.tokenizer.vocab_size}, "
                f"{data.steps_per_epoch()} steps/epoch", flush=True)
            return data
    from ddlbench_tpu_torch.data.ondisk import OnDiskData

    train_count = (cfg.steps_per_epoch or 0) * B or None
    test_count = max(B, train_count // 5) if train_count else None
    return OnDiskData(cfg.data_dir or "./data", spec, B, device,
                      seed=cfg.seed, dtype=getattr(torch, cfg.compute_dtype),
                      train_count=train_count, test_count=test_count,
                      augment=cfg.augment)


def _probe_input_ms(cfg: RunConfig, device: torch.device,
                    what: str) -> float:
    """The on-disk loader's fetch cost per microbatch, measured on a
    throwaway source (so the run's stream stays unconsumed) and scaled
    from the global batch to the profile's microbatch units."""
    from ddlbench_tpu_torch.profiler.profile import measure_input_ms

    probe = make_data(cfg, device, verbose=False)
    try:
        global_ms = measure_input_ms(probe)
    finally:
        getattr(probe, "close", lambda: None)()
    mb, _ = cfg.resolved_batches()
    ms = global_ms * mb / cfg.global_batch()
    print(f"{what}: measured input cost {global_ms:.2f} ms/global-batch "
          f"({ms:.3f} ms/microbatch)", flush=True)
    return ms


def prepare_run(cfg: RunConfig, device: torch.device
                ) -> Tuple[RunConfig, Optional[AutoPartition]]:
    """Resolve ``--plan auto`` (partition/planner.py) and
    ``--auto-partition`` (parallel/api.auto_partition) once, in this
    process, before any rank starts: returns the config the run executes
    and the auto-partition plan (None without one). The rewritten mix
    decides how many ranks run, and every rank gets the same plan."""
    if cfg.plan == "auto":
        from ddlbench_tpu_torch.partition.planner import resolve_auto_plan

        cfg = resolve_auto_plan(
            cfg, input_time_ms=0.0 if cfg.synthetic else (
                lambda: _probe_input_ms(cfg, device, "plan auto")),
            device=device)
    partition = None
    if cfg.auto_partition and cfg.strategy in PIPELINE_STRATEGIES:
        input_ms = (0.0 if cfg.synthetic
                    else _probe_input_ms(cfg, device, "auto-partition"))
        partition = auto_partition(cfg, device, input_ms)
        cfg = partition.cfg
    return cfg, partition


def activation_logger(cfg: RunConfig, strategy: Strategy, rank: int):
    """profiler/actlog.py's logger for ``cfg.activation_log_dir`` under a
    strategy that holds the whole model (single, dp, sp), else None (rank
    0 says the others are skipped). Every rank gets one (dp's overlapped
    engine gathers its parameters with a collective); rank 0 writes."""
    if not cfg.activation_log_dir:
        return None
    if cfg.strategy not in ("single", "dp", "sp"):
        if rank == 0:
            print("activation logging unsupported for this strategy "
                  "(packed or absent per-layer params); skipped",
                  flush=True)
        return None
    from ddlbench_tpu_torch.profiler.actlog import ActivationLogger

    return ActivationLogger(
        cfg.activation_log_dir, strategy.model,
        getattr(torch, cfg.compute_dtype), cfg.activation_log_freq,
        cfg.activation_log_steps, moe_aux_weight=cfg.moe_aux_weight,
        label_smoothing=cfg.resolved_label_smoothing(), write=rank == 0)


def _warmup(strategy: Strategy, cfg: RunConfig, data, lr: float,
            steps: int) -> float:
    """Run ``steps`` train steps on the batch (0, 0) of ``data``, or of the
    synthetic data of the run's shape when ``data`` is a sequential stream
    (module docstring), then restore the model's weights and running
    statistics and start a fresh optimizer, so the measured run starts
    from the initial state. Returns the seconds."""
    t0 = time.perf_counter()
    initial = {k: v.clone() for k, v in strategy.model.state_dict().items()}
    if getattr(data, "stateful_stream", False):
        data = make_synthetic(cfg.dataset(), cfg.global_batch(),
                              _device_of(strategy), seed=cfg.seed)
    x, y = data.batch(0, 0)
    for _ in range(steps):
        m = strategy.train_step(x, y, lr)
    float(m["loss"])
    strategy.model.load_state_dict(initial)
    strategy.init()
    return time.perf_counter() - t0


def evaluate(strategy: Strategy, prefetch: Prefetcher,
             epoch: int) -> Dict[str, Optional[float]]:
    """One validation epoch over the test split: the eval step's sums
    accumulate on the device and are read once. Returns loss, accuracy
    and top5."""
    loss_sum = correct = correct5 = count = None
    with prefetch.stream(epoch, train=False) as stream:
        for x, y in stream:
            m = strategy.eval_step(x, y)
            part = (m["loss"] * m["count"], m["correct"], m["correct5"],
                    m["count"])
            if loss_sum is None:
                loss_sum, correct, correct5, count = part
            else:
                loss_sum, correct, correct5, count = (
                    loss_sum + part[0], correct + part[1],
                    correct5 + part[2], count + part[3])
    n = int(count)
    return {"loss": float(loss_sum) / max(1, n),
            "accuracy": int(correct) / max(1, n),
            "top5": int(correct5) / n if n else None}


def _epoch(cfg: RunConfig, strategy: Strategy, prefetch: Prefetcher,
           logger: MetricLogger, epoch: int, base_lr: float, B: int,
           warmup_world: int = 1, actlog=None):
    """One training epoch and its validation; returns (the steps' body
    seconds, the validation accuracy)."""
    lr = step_decay_lr(base_lr, epoch - 1, cfg.lr_step_epochs,
                       cfg.lr_step_gamma)
    warming = cfg.warmup_epochs and epoch - 1 < cfg.warmup_epochs
    tick = time.perf_counter()
    interval_tick, interval_samples = tick, 0
    loss_sum, interval_steps, step_s = None, 0, []
    with prefetch.stream(epoch, train=True) as stream:
        steps = stream.steps
        for step, (x, y) in enumerate(stream):
            if actlog is not None and actlog.should_log(epoch, step):
                materialize = getattr(strategy, "materialize_params", None)
                if materialize is not None:
                    materialize()  # dp's sharded parameters, gathered
                path = actlog.log(epoch, step, x, y)
                if path:
                    print(f"activations logged: {path}", flush=True)
            t1 = time.perf_counter()
            step_lr = (gradual_warmup_lr(lr, warmup_world, epoch - 1, step,
                                         steps, cfg.warmup_epochs)
                       if warming else lr)
            m = strategy.train_step(x, y, step_lr)
            loss_sum = m["loss"] if loss_sum is None else loss_sum + m["loss"]
            interval_steps += 1
            interval_samples += B
            if (step + 1) % cfg.log_interval == 0 or step == steps - 1:
                loss = float(loss_sum) / interval_steps
                if not math.isfinite(loss):
                    raise RuntimeError(
                        f"non-finite training loss {loss} in epoch {epoch} "
                        f"interval ending step {step + 1}")
                now = time.perf_counter()
                logger.train_interval(
                    epoch, 100.0 * (step + 1) / steps,
                    interval_samples / max(1e-9, now - interval_tick), loss)
                interval_tick, interval_samples = now, 0
                loss_sum, interval_steps = None, 0
            step_s.append(time.perf_counter() - t1)
    epoch_time = time.perf_counter() - tick
    logger.epoch_done(epoch, steps * B / epoch_time, epoch_time,
                      input_stall_ms=stream.stall_ms,
                      step_ms=latency_summary(step_s))
    val = evaluate(strategy, prefetch, epoch)
    logger.valid_epoch(epoch, val["loss"], val["accuracy"], top5=val["top5"])
    return step_s, val["accuracy"]


def run_benchmark(cfg: RunConfig, strategy: Optional[Strategy] = None,
                  logger: Optional[MetricLogger] = None,
                  warmup_steps: int = 1,
                  device: Optional[str] = None) -> Dict[str, Any]:
    """Run the benchmark protocol for ``cfg`` and return the summary dict
    (MetricLogger.summary). The strategy is built on ``device`` (cuda
    unless "cpu" is asked for) when none is given, after
    :func:`prepare_run`; a dp strategy comes built, on its rank
    (distributed.spawn), with the config it was built for."""
    cfg.validate()
    if strategy is None:
        dev = resolve_device(device)
        cfg, partition = prepare_run(cfg, dev)
        strategy = make_strategy(cfg, dev, partition=partition)
    dev = _device_of(strategy)
    rank = _rank(strategy)
    B = cfg.global_batch()
    logger = logger or MetricLogger(cfg.epochs, cfg.log_interval,
                                    device=dev, rank=rank)
    base_lr, warmup_world = scaled_lr(
        cfg, getattr(strategy, "world_size", 1))
    if rank == 0:
        print(comm_line(comm_stats(strategy)), flush=True)
    data = make_data(cfg, dev, verbose=rank == 0)
    actlog = activation_logger(cfg, strategy, rank)
    try:
        warmup_s = (_warmup(strategy, cfg, data, base_lr, warmup_steps)
                    if warmup_steps > 0 else None)
        prefetch = Prefetcher(data, depth=cfg.prefetch_depth)
        all_steps, accuracy = [], 0.0
        for epoch in range(1, cfg.epochs + 1):
            s, accuracy = _epoch(cfg, strategy, prefetch, logger, epoch,
                                 base_lr, B, warmup_world, actlog)
            all_steps += s
    finally:
        getattr(data, "close", lambda: None)()

    step_time = latency_summary(all_steps)
    if warmup_s is not None:
        step_time["warmup_compile_s"] = warmup_s
    return logger.summary(accuracy, step_time=step_time)
