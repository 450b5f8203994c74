"""Thread-safe, ring-buffered span/counter tracer on monotonic clocks.

The port's copy of ``ddlbench_tpu/telemetry/tracer.py`` (pure host code).
The serving engine (serve/engine.py, ``cfg.trace``) records its
request-lifecycle events here through :meth:`Tracer.emit` with virtual
timestamps; servebench installs a fresh bounded tracer per policy row.

* **Disabled** (the default): every recording call is one attribute check;
  ``span`` returns a cached no-op context manager, nothing is allocated or
  locked, no clock is read.
* **Enabled**: one lock-guarded append into a bounded ``deque`` per event
  (two ``time.perf_counter_ns`` reads per wall-clock span). The ring drops
  the OLDEST events when full and ``dropped_events`` counts them, so a long
  run keeps its most recent window.

Recording never reorders or perturbs the traced computation — the tracer
only stores what it is handed and reads clocks — so a traced run's results
are those of the untraced run.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# Event tuples: (phase, name, t0_ns, dur_ns, thread_id, thread_name, args).
# phase follows the Chrome trace-event phases the exporter emits:
# "X" = complete span, "C" = counter sample, "i" = instant.
Event = Tuple[str, str, int, int, int, str, Optional[Dict[str, Any]]]


class _NullSpan:
    """Cached do-nothing context manager — the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: clocks its own enter/exit and records on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.complete(self._name, self._t0, time.perf_counter_ns(),
                              self._args)
        return False


class Tracer:
    """Bounded, thread-safe event recorder. One instance serves all threads.

    ``capacity`` bounds host memory: at ~120 bytes/event the default
    200k-event ring tops out around 25 MB regardless of run length.
    """

    def __init__(self, capacity: int = 200_000):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = False
        self._capacity = capacity
        self._events: deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dropped = 0

    # ---- recording ----

    def span(self, name: str, **args: Any):
        """Context manager timing a region; no-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record an already-timed region (both stamps from
        ``time.perf_counter_ns``)."""
        if not self.enabled:
            return
        th = threading.current_thread()
        self._append(("X", name, t0_ns, t1_ns - t0_ns, th.ident or 0,
                      th.name, args))

    def counter(self, name: str, value: float) -> None:
        """Record one sample of a named counter track."""
        if not self.enabled:
            return
        th = threading.current_thread()
        self._append(("C", name, time.perf_counter_ns(), 0, th.ident or 0,
                      th.name, {"value": value}))

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration marker."""
        if not self.enabled:
            return
        th = threading.current_thread()
        self._append(("i", name, time.perf_counter_ns(), 0, th.ident or 0,
                      th.name, args or None))

    def emit(self, phase: str, name: str, t0_ns: int, dur_ns: int = 0,
             track: str = "virtual",
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record an event on a named SYNTHETIC track with caller-supplied
        timestamps — the virtual-time entry point. The serving engine
        stamps one model pass as 1000 trace-ns, so it renders as 1 µs in
        the exported trace and every timestamp stays an exact integer.
        Synthetic tracks use thread id 0, which no started thread carries,
        so they never alias a real thread's track in the exporter."""
        if not self.enabled:
            return
        self._append((phase, name, int(t0_ns), int(dur_ns), 0, track, args))

    def _append(self, evt: Event) -> None:
        with self._lock:
            if len(self._events) == self._capacity:
                self._dropped += 1
            self._events.append(evt)

    # ---- lifecycle / readout ----

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    @property
    def capacity(self) -> int:
        """Ring size (exported in the trace metadata)."""
        return self._capacity

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def events(self) -> List[Event]:
        """Snapshot of the recorded events in record order."""
        with self._lock:
            return list(self._events)

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# Process-global tracer: the engine looks it up lazily, servebench installs
# and enables one per traced row. A plain module global, not a context var,
# so every thread sees the same instance.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests install bounded fresh ones)."""
    global _TRACER
    _TRACER = tracer
    return tracer
