"""The benchmark training loop (the core of ``ddlbench_tpu/train/loop.py``
``run_benchmark``, ``_run_benchmark`` and ``evaluate``).

``run_benchmark`` warms the step up on a throwaway copy of the state,
restores the initial weights, running statistics and a fresh optimizer,
then runs ``cfg.epochs`` epochs of ``steps_per_epoch`` steps at the
step-decay learning rate (``lr_step_gamma`` every ``lr_step_epochs``
epochs), logging every ``log_interval`` steps and at the epoch's end, and
validates once per epoch. Losses are summed on the device and read once per
log interval, so the host waits for the card only there; a non-finite
interval loss stops the run (the reference's default ``nan_policy``).

Per step the loop records the wall time of its body (the batch excluded:
that is the input stall, the time spent making batches, on the device here)
for the p50/p95 fields; between syncs it is the host's dispatch time, as in
the reference. Plans, auto-partition, tracing, checkpoints, the watchdog,
the guard and preemption are not ported: RunConfig.validate refuses their
knobs.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.data.synthetic import SyntheticData, make_synthetic
from ddlbench_tpu_torch.device import resolve_device
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.parallel.common import step_decay_lr
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.telemetry.stats import latency_summary
from ddlbench_tpu_torch.train.metrics import MetricLogger


def _device_of(strategy: SingleStrategy) -> torch.device:
    return next(strategy.model.parameters()).device


def _warmup(strategy: SingleStrategy, data: SyntheticData, lr: float,
            steps: int) -> float:
    """Run ``steps`` train steps on epoch 0's first batch, then restore the
    model's weights and running statistics and start a fresh optimizer, so
    the measured run starts from the initial state. Returns the seconds."""
    t0 = time.perf_counter()
    initial = {k: v.clone() for k, v in strategy.model.state_dict().items()}
    x, y = data.batch(0, 0)
    for _ in range(steps):
        m = strategy.train_step(x, y, lr)
    float(m["loss"])
    strategy.model.load_state_dict(initial)
    strategy.init()
    return time.perf_counter() - t0


def evaluate(strategy: SingleStrategy, data: SyntheticData,
             epoch: int) -> Dict[str, Optional[float]]:
    """One validation epoch: the eval step's sums accumulate on the device
    and are read once. Returns loss, accuracy and top5."""
    loss_sum = correct = correct5 = count = None
    for step in range(data.steps_per_epoch(train=False)):
        m = strategy.eval_step(*data.batch(epoch, step, train=False))
        part = (m["loss"] * m["count"], m["correct"], m["correct5"],
                m["count"])
        if loss_sum is None:
            loss_sum, correct, correct5, count = part
        else:
            loss_sum, correct, correct5, count = (
                loss_sum + part[0], correct + part[1], correct5 + part[2],
                count + part[3])
    n = int(count)
    return {"loss": float(loss_sum) / max(1, n),
            "accuracy": int(correct) / max(1, n),
            "top5": int(correct5) / n if n else None}


def run_benchmark(cfg: RunConfig, strategy: Optional[SingleStrategy] = None,
                  logger: Optional[MetricLogger] = None,
                  warmup_steps: int = 1,
                  device: Optional[str] = None) -> Dict[str, Any]:
    """Run the benchmark protocol for ``cfg`` and return the summary dict
    (MetricLogger.summary). The strategy is built on ``device`` (cuda
    unless "cpu" is asked for) when none is given."""
    cfg.validate()
    if strategy is None:
        strategy = make_strategy(cfg, resolve_device(device))
    dev = _device_of(strategy)
    B = cfg.global_batch()
    data = make_synthetic(cfg.dataset(), B, dev, seed=cfg.seed,
                          steps_per_epoch=cfg.steps_per_epoch)
    logger = logger or MetricLogger(cfg.epochs, cfg.log_interval,
                                    device=dev)
    base_lr = cfg.resolved_lr()
    warmup_s = (_warmup(strategy, data, base_lr, warmup_steps)
                if warmup_steps > 0 else None)

    all_steps = []
    accuracy = 0.0
    for epoch in range(1, cfg.epochs + 1):
        lr = step_decay_lr(base_lr, epoch - 1, cfg.lr_step_epochs,
                           cfg.lr_step_gamma)
        steps = data.steps_per_epoch(train=True)
        tick = time.perf_counter()
        interval_tick, interval_samples = tick, 0
        loss_sum, interval_steps, stall_s, step_s = None, 0, 0.0, []
        for step in range(steps):
            t0 = time.perf_counter()
            x, y = data.batch(epoch, step)
            t1 = time.perf_counter()
            stall_s += t1 - t0
            m = strategy.train_step(x, y, lr)
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
        all_steps += step_s
        logger.epoch_done(epoch, steps * B / epoch_time, epoch_time,
                          input_stall_ms=stall_s * 1e3,
                          step_ms=latency_summary(step_s))
        val = evaluate(strategy, data, epoch)
        logger.valid_epoch(epoch, val["loss"], val["accuracy"],
                           top5=val["top5"])
        accuracy = val["accuracy"]

    step_time = latency_summary(all_steps)
    if warmup_s is not None:
        step_time["warmup_compile_s"] = warmup_s
    return logger.summary(accuracy, step_time=step_time)
