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

With ``checkpoint_dir`` the loop commits the strategy's train state
(its ``checkpoint_state``, parallel/state.py) after every epoch's
validation and every ``checkpoint_every_steps`` steps inside an epoch
(train/checkpoint.py), with ``logical.json`` (train/reshard.py) on every
commit and the newest ``keep_checkpoints`` kept (the current resume
target never dropped). Every rank gathers, rank 0 writes, and every rank
passes a barrier before the gather and after the rename. With
``resume`` it restores, after the warm-up, the newest valid checkpoint
(none: "starting fresh"): a world-size mismatch is resharded under
``elastic_resume`` or refused by name, the lr's world scaling stays
pinned to the launch world the checkpoint recorded, the metric logger's
counters come back, an epoch checkpoint is validated again before
training goes on, and a step checkpoint resumes inside its epoch (the
batches are (epoch, step)-addressed; a sequential on-disk stream is
fast-forwarded). Tracing, the watchdog, the guard, preemption and fault
injection are not ported: RunConfig.validate refuses their knobs.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
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


class Checkpoints:
    """The loop's checkpoint bookkeeping (module docstring): the global
    step, the retention pin (the current resume target), the logical
    metadata of every commit, and the save and restore seconds."""

    def __init__(self, cfg: RunConfig, strategy: Strategy,
                 logger: MetricLogger, rank: int, lr_world: int):
        self.cfg, self.strategy, self.logger = cfg, strategy, logger
        self.rank, self.lr_world = rank, lr_world
        self.global_step = 0
        self.pin: Optional[str] = None
        self.logical: Optional[Dict[str, Any]] = None
        self.save_s: list = []
        self.restore_s: Optional[float] = None

    def _say(self, line: str) -> None:
        if self.rank == 0:
            print(line, flush=True)

    def barrier(self) -> None:
        """Every rank of the run here: the strategy's groups in turn (3-D
        tpp's tp group, then its data group, which together order every
        rank after rank 0)."""
        seen = []
        for name in ("tp_comm", "dp_comm", "comm"):
            comm = getattr(self.strategy, name, None)
            if comm is not None and all(comm is not c for c in seen):
                seen.append(comm)
                comm.barrier()

    def commit(self, epoch: int, step: Optional[int] = None) -> str:
        """Commit the strategy's state as of epoch ``epoch`` (and interior
        step ``step``): every rank gathers, rank 0 writes. Returns the
        path."""
        from ddlbench_tpu_torch.train import reshard
        from ddlbench_tpu_torch.train.checkpoint import (checkpoint_name,
                                                         save_checkpoint)

        t0 = time.perf_counter()
        self.barrier()
        tree = self.strategy.checkpoint_state()
        if self.logical is None:
            self.logical = reshard.logical_meta(self.strategy, self.cfg, tree,
                                                self.lr_world)
        path = os.path.join(os.path.abspath(self.cfg.checkpoint_dir),
                            checkpoint_name(epoch, step))
        if self.rank == 0:
            path = save_checkpoint(
                self.cfg.checkpoint_dir, epoch, tree, step=step,
                global_step=self.global_step,
                logger_state=self.logger.state_dict(), seed=self.cfg.seed,
                keep=self.cfg.keep_checkpoints, pin=self.pin,
                logical=self.logical)
        self.barrier()
        self.pin = path
        self.save_s.append(time.perf_counter() - t0)
        return path

    def resume(self, data, prefetch: Prefetcher) -> Tuple[int, int]:
        """Restore the newest valid checkpoint (module docstring) and
        return (the epoch, the step in it) the run goes on from; (1, 0)
        where there is none."""
        from ddlbench_tpu_torch.parallel.state import check_payload
        from ddlbench_tpu_torch.train import reshard
        from ddlbench_tpu_torch.train.checkpoint import (latest_valid,
                                                         load_logical,
                                                         load_state)

        cfg, strategy = self.cfg, self.strategy
        quiet = (contextlib.nullcontext() if self.rank == 0
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            info = latest_valid(cfg.checkpoint_dir)
        if info is None:
            self._say(f"resume: no valid checkpoint under "
                      f"{cfg.checkpoint_dir}; starting fresh")
            return 1, 0
        t0 = time.perf_counter()
        current = strategy.checkpoint_state()
        saved_logical = load_logical(info.path)
        cur_logical = reshard.logical_meta(strategy, cfg, current,
                                           self.lr_world)
        with quiet:
            decision = reshard.compare(saved_logical, cur_logical,
                                       cfg.elastic_resume)
        restored = load_state(info.path)
        if decision == "reshard":
            self._say(f"elastic resume: resharding checkpoint from world "
                      f"{saved_logical['world']} to {cur_logical['world']} "
                      f"(buckets {saved_logical.get('buckets')} -> "
                      f"{cur_logical.get('buckets')})")
            restored = reshard.elastic_restore(restored, saved_logical,
                                               strategy)
        check_payload(restored, current)
        strategy.load_checkpoint_state(restored)
        self.restore_s = time.perf_counter() - t0
        if saved_logical is not None:
            if saved_logical.get("global_batch") != cfg.global_batch():
                self._say(f"resume: WARNING checkpoint was written at global "
                          f"batch {saved_logical.get('global_batch')}, run "
                          f"uses {cfg.global_batch()} — the (epoch, "
                          f"step)-addressed data streams will not match the "
                          f"original trajectory")
            saved_lr_world = saved_logical.get("lr_world")
            if saved_lr_world and saved_lr_world != self.lr_world:
                # the run's hyperparameters were fixed at launch: a
                # reshaped fleet replays the same schedule
                self.lr_world = saved_lr_world
                self._say(f"elastic resume: lr world-scaling pinned to the "
                          f"launch world ({self.lr_world})")
            if saved_logical.get("elastic_slices") != cfg.elastic_slices:
                self._say(f"resume: WARNING checkpoint recorded "
                          f"--elastic-slices "
                          f"{saved_logical.get('elastic_slices')}, run uses "
                          f"{cfg.elastic_slices} — reduction orders differ, "
                          f"the trajectory will not be bitwise")
        self.pin = info.path
        meta = info.meta
        if meta.get("seed") is not None and meta["seed"] != cfg.seed:
            self._say(f"resume: WARNING checkpoint was written with seed "
                      f"{meta['seed']}, run uses seed {cfg.seed} — the "
                      f"(epoch, step)-addressed data/RNG streams will not "
                      f"match the original trajectory")
        if meta.get("logger"):
            self.logger.load_state_dict(meta["logger"])
        steps = data.steps_per_epoch(train=True)
        start_epoch, resume_step = info.epoch + 1, 0
        if info.mid_epoch:
            # the data's position is the step index: the next step of the
            # epoch, or the next epoch where the step was its last
            start_epoch, resume_step = info.epoch, info.step + 1
            if resume_step >= steps:
                start_epoch, resume_step = info.epoch + 1, 0
            self._say(f"resumed from {cfg.checkpoint_dir} epoch "
                      f"{info.epoch} step {info.step} (mid-epoch)")
        else:
            self._say(f"resumed from {cfg.checkpoint_dir} epoch "
                      f"{info.epoch}")
        self.global_step = (meta["global_step"]
                            if meta.get("global_step") is not None
                            else (start_epoch - 1) * steps + resume_step)
        if not info.mid_epoch:
            # validate the restored state before training goes on (the
            # reference's main_with_runtime.py:374-376); a mid-epoch
            # resume validates at its epoch's end
            val = evaluate(strategy, prefetch, info.epoch)
            self.logger.valid_epoch(info.epoch, val["loss"],
                                    val["accuracy"], top5=val["top5"])
        return start_epoch, resume_step

    def record(self) -> Dict[str, Any]:
        """The run's checkpoint seconds for the summary."""
        return {"saves": len(self.save_s), "save_s": list(self.save_s),
                "restore_s": self.restore_s}


def _epoch(cfg: RunConfig, strategy: Strategy, prefetch: Prefetcher,
           logger: MetricLogger, epoch: int, base_lr: float, B: int,
           warmup_world: int, actlog, ckpt: Checkpoints, start_step: int):
    """One training epoch from step ``start_step`` and its validation,
    with ``ckpt``'s step and epoch commits; returns (the steps' body
    seconds, the validation accuracy)."""
    lr = step_decay_lr(base_lr, epoch - 1, cfg.lr_step_epochs,
                       cfg.lr_step_gamma)
    warming = cfg.warmup_epochs and epoch - 1 < cfg.warmup_epochs
    every = cfg.checkpoint_every_steps
    tick = time.perf_counter()
    interval_tick, interval_samples = tick, 0
    loss_sum, interval_steps, step_s = None, 0, []
    with prefetch.stream(epoch, train=True, start_step=start_step) as stream:
        steps = stream.steps
        for step, (x, y) in enumerate(stream, start=start_step):
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
            ckpt.global_step += 1
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
            if every and (step + 1) % every == 0 and step != steps - 1:
                ckpt.commit(epoch, step)  # the epoch's own commit covers
                #                           its last step
    epoch_time = time.perf_counter() - tick
    logger.epoch_done(epoch, (steps - start_step) * B / epoch_time,
                      epoch_time, input_stall_ms=stream.stall_ms,
                      step_ms=latency_summary(step_s))
    val = evaluate(strategy, prefetch, epoch)
    logger.valid_epoch(epoch, val["loss"], val["accuracy"], top5=val["top5"])
    if cfg.checkpoint_dir:
        ckpt.commit(epoch)
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
    ckpt = Checkpoints(cfg, strategy, logger, rank,
                       getattr(strategy, "world_size", 1))
    base_lr, warmup_world = scaled_lr(cfg, ckpt.lr_world)
    if rank == 0:
        print(comm_line(comm_stats(strategy)), flush=True)
    data = make_data(cfg, dev, verbose=rank == 0)
    actlog = activation_logger(cfg, strategy, rank)
    try:
        warmup_s = (_warmup(strategy, cfg, data, base_lr, warmup_steps)
                    if warmup_steps > 0 else None)
        prefetch = Prefetcher(data, depth=cfg.prefetch_depth)
        start_epoch, start_step = 1, 0
        if cfg.checkpoint_dir and cfg.resume:
            start_epoch, start_step = ckpt.resume(data, prefetch)
            base_lr, warmup_world = scaled_lr(cfg, ckpt.lr_world)
        all_steps = []
        accuracy = (logger.valid_history[-1]["accuracy"]
                    if logger.valid_history else 0.0)
        for epoch in range(start_epoch, cfg.epochs + 1):
            s, accuracy = _epoch(
                cfg, strategy, prefetch, logger, epoch, base_lr, B,
                warmup_world, actlog, ckpt,
                start_step if epoch == start_epoch else 0)
            all_steps += s
    finally:
        getattr(data, "close", lambda: None)()

    step_time = latency_summary(all_steps)
    if warmup_s is not None:
        step_time["warmup_compile_s"] = warmup_s
    result = logger.summary(accuracy, step_time=step_time)
    if cfg.checkpoint_dir:
        result["checkpoint"] = ckpt.record()
    return result
