"""No-progress detection on a caller's clock (``ddlbench_tpu/train/
watchdog.py``'s :class:`ProgressMonitor`).

The reference's hang watchdog (a monitor thread on the wall clock) and its
non-finite-loss policy belong to the training tooling and are not ported
yet. What the serving fleet needs is the deadline rule alone, with the
clock factored out: the fleet kicks each replica's monitor on the virtual
model-pass clock, so a slow host can never make a replica look stalled.
"""

from __future__ import annotations


class ProgressMonitor:
    """Clock-agnostic no-progress detector. ``kick(now)`` records progress
    on whatever monotone timeline the caller runs (the serving engine's
    virtual model-pass clock, a step counter), and ``expired(now)`` is True
    once more than ``window`` of that timeline has passed without a kick.
    Pure host arithmetic: no thread, and no clock of its own."""

    def __init__(self, window: float, now: float = 0.0):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = window
        self._last = now

    def kick(self, now: float) -> None:
        """Record progress at ``now``; postpones expiry by ``window``."""
        self._last = now

    def expired(self, now: float) -> bool:
        return now - self._last > self.window

    @property
    def last_progress(self) -> float:
        return self._last

    def stalled_for(self, now: float) -> float:
        return now - self._last
