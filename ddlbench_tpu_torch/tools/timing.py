"""The benchmark timing ritual (``ddlbench_tpu/tools/timing.py``
``timed_steps``): warm up outside the clock, time a loop of chained train
steps, and close both on ``float(loss)``, a device-to-host copy that waits
for the last step."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def timed_steps_detail(run_step: Callable[[object, object], dict],
                       get_batch: Callable[[int, int], Tuple[object, object]],
                       steps: int, warmup: int
                       ) -> Tuple[float, float, List[float]]:
    """``steps`` train steps, timed: returns (wall-clock seconds, input
    seconds, per-step seconds). ``run_step(x, y) -> metrics`` updates its
    own state (each step reads the previous one's parameters, so the last
    loss is a full barrier); ``get_batch(epoch, step)`` supplies batches
    (epoch 0 = warmup, 1 = timed). The input seconds are the host time
    spent in ``get_batch`` inside the timed loop (the stall). A step's
    time is the device's, from a CUDA event recorded after each step (the
    gap between two steps' events, so time the card sat idle waiting for
    the host counts), when the loss is on the card; on the CPU it is the
    host time of the step."""
    m = None
    x, y = get_batch(0, 0)
    for _ in range(max(1, warmup)):
        m = run_step(x, y)
    float(m["loss"])
    on_card = m["loss"].device.type == "cuda"
    events, step_s, stall_s = [], [], 0.0
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    t0 = time.perf_counter()
    for step in range(steps):
        t_in = time.perf_counter()
        x, y = get_batch(1, step)
        t_step = time.perf_counter()
        stall_s += t_step - t_in
        m = run_step(x, y)
        if on_card:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        else:
            step_s.append(time.perf_counter() - t_step)
    float(m["loss"])
    dt = time.perf_counter() - t0
    if on_card:
        step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    return dt, stall_s, step_s


def timed_steps(run_step: Callable[[object, object], dict],
                get_batch: Callable[[int, int], Tuple[object, object]],
                steps: int, warmup: int) -> float:
    """Wall-clock seconds for ``steps`` train steps. ``run_step(x, y) ->
    metrics`` updates its own state (each step reads the previous one's
    parameters, so the last loss is a full barrier); ``get_batch(epoch,
    step)`` supplies batches (epoch 0 = warmup, 1 = timed). Nothing but
    the steps and their batches runs inside the clock
    (timed_steps_detail adds per-step events and the input stall)."""
    m = None
    x, y = get_batch(0, 0)
    for _ in range(max(1, warmup)):
        m = run_step(x, y)
    float(m["loss"])
    t0 = time.perf_counter()
    for step in range(steps):
        x, y = get_batch(1, step)
        m = run_step(x, y)
    float(m["loss"])
    return time.perf_counter() - t0
