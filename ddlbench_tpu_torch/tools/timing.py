"""The benchmark timing ritual (``ddlbench_tpu/tools/timing.py``
``timed_steps``): warm up outside the clock, time a loop of chained train
steps, and close both on ``float(loss)``, a device-to-host copy that waits
for the last step."""

from __future__ import annotations

import time
from typing import Callable, Tuple


def timed_steps(run_step: Callable[[object, object], dict],
                get_batch: Callable[[int, int], Tuple[object, object]],
                steps: int, warmup: int) -> float:
    """Wall-clock seconds for ``steps`` train steps. ``run_step(x, y) ->
    metrics`` updates its own state (each step reads the previous one's
    parameters, so the last loss is a full barrier); ``get_batch(epoch,
    step)`` supplies batches (epoch 0 = warmup, 1 = timed)."""
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
