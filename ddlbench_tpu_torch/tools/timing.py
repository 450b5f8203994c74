"""The benchmark timing ritual (``ddlbench_tpu/tools/timing.py``
``timed_steps`` and ``timed_steps_prefetched``): warm up outside the
clock, time a loop of chained train steps, and close both on
``float(loss)``, a device-to-host copy that waits for the last step."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def _step_seconds(events, host_s):
    """Per-step seconds: the device's, between consecutive CUDA events
    recorded after each step (so time the card sat idle waiting for the
    host counts), when there are events; else the host's."""
    if events:
        return [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    return host_s


def timed_steps(run_step: Callable[[object, object], dict],
                get_batch: Callable[[int, int], Tuple[object, object]],
                steps: int, warmup: int) -> float:
    """Wall-clock seconds for ``steps`` train steps. ``run_step(x, y) ->
    metrics`` updates its own state (each step reads the previous one's
    parameters, so the last loss is a full barrier); ``get_batch(epoch,
    step)`` supplies batches (epoch 0 = warmup, 1 = timed). Nothing but
    the steps and their batches runs inside the clock
    (timed_steps_prefetched adds per-step events and the input stall)."""
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


def timed_steps_prefetched(run_step: Callable[[object, object], dict],
                           prefetcher, warmup: int
                           ) -> Tuple[float, float, int, List[float]]:
    """The timed loop driven by the input pipeline (data/prefetch.py):
    ``warmup`` steps on the source's epoch-0 first batch outside the
    clock, then one full epoch-1 stream of ``prefetcher``, the clock
    started before the stream's producer. Returns (wall-clock seconds,
    the seconds the loop waited for batches, the steps driven, per-step
    seconds: the device's, between CUDA events recorded after each step,
    so time the card sat idle waiting for the host counts, when the loss
    is on the card; else the host's)."""
    m = None
    x, y = prefetcher.data.batch(0, 0)
    for _ in range(max(1, warmup)):
        m = run_step(x, y)
    float(m["loss"])
    on_card = m["loss"].device.type == "cuda"
    events, host_s = [], []
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    t0 = time.perf_counter()
    with prefetcher.stream(1, train=True) as stream:
        for x, y in stream:
            ts = time.perf_counter()
            m = run_step(x, y)
            if on_card:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            else:
                host_s.append(time.perf_counter() - ts)
        float(m["loss"])
        dt = time.perf_counter() - t0
    return dt, stream.stall_s, stream.steps, _step_seconds(events, host_s)
