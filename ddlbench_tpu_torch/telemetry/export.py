"""Chrome trace-event JSON export — the Perfetto-loadable trace format.

The port's copy of ``chrome_trace_dict``, ``export_chrome_trace``,
``autoscale_decisions``, ``sdc_events``, ``trace_truncation`` and
``warn_if_truncated`` from ``ddlbench_tpu/telemetry/export.py``. Emits the JSON Object Format of the
Trace Event spec (``chrome://tracing`` and https://ui.perfetto.dev load it):

* one ``"X"`` (complete) event per span with ``ts``/``dur`` in
  MICROSECONDS (float; the spec's unit); ``"C"`` counter samples and
  ``"i"`` instants pass through;
* one ``"M"`` ``thread_name`` metadata event per track (the serving
  engine's virtual-time events carry synthetic track names: one track per
  request per replica, a pool track and an engine counter track);
* a top-level ``metadata`` object with the tracer's drop count and ring
  capacity, the torch/CUDA runtime, and any caller-supplied metadata
  (servebench embeds its SLOs and time unit so ``serveview`` can default
  from the file).

A reducer that silently under-counts a truncated trace is worse than none:
:func:`trace_truncation` reads the drop count back out of a trace, and
:func:`warn_if_truncated` is the loud path the serveview CLI goes through.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from ddlbench_tpu_torch.telemetry.tracer import Tracer

_PID = 1  # single host process; one pid keeps Perfetto's track grouping flat


def _runtime_metadata() -> Dict[str, Any]:
    """torch/CUDA versions and the visible card count."""
    import torch

    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_count": (torch.cuda.device_count()
                             if torch.cuda.is_available() else 0)}


def chrome_trace_dict(tracer: Tracer,
                      extra_metadata: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
    """Build the trace-event dict (separated from file I/O for tests)."""
    events: List[Dict[str, Any]] = []
    # track key is (os thread id, thread name), mapped to a synthetic tid:
    # the OS reuses the idents of joined threads
    track_ids: Dict[tuple, int] = {}
    for phase, name, t0_ns, dur_ns, os_tid, tname, args in tracer.events():
        key = (os_tid, tname)
        tid = track_ids.get(key)
        if tid is None:
            tid = track_ids[key] = len(track_ids) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                "args": {"name": tname},
            })
        evt: Dict[str, Any] = {
            "ph": phase, "name": name, "pid": _PID, "tid": tid,
            "ts": t0_ns / 1e3,
        }
        if phase == "X":
            evt["dur"] = dur_ns / 1e3
        if phase == "i":
            evt["s"] = "t"  # thread-scoped instant
        if args:
            evt["args"] = dict(args)
        events.append(evt)
    metadata = {
        "producer": "ddlbench_tpu_torch.telemetry",
        "dropped_events": tracer.dropped_events,
        "capacity": tracer.capacity,
        **_runtime_metadata(),
    }
    if extra_metadata:
        metadata.update(extra_metadata)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metadata,
    }


def export_chrome_trace(tracer: Tracer, path: str,
                        extra_metadata: Optional[Dict[str, Any]] = None,
                        ) -> int:
    """Write the trace to ``path``; returns the number of span/counter
    events written (metadata events excluded)."""
    doc = chrome_trace_dict(tracer, extra_metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


AUTOSCALE_PREFIX = "autoscale:"
SDC_PREFIX = "sdc:"


def _instants(doc: Any, prefix: str) -> List[Dict[str, Any]]:
    """The ``"i"`` instants whose name starts with ``prefix``, in trace
    order, as ``{"t": <model passes>, "kind": <name less prefix>,
    **args}``. Accepts a live Tracer or an exported trace dict or event
    list."""
    out: List[Dict[str, Any]] = []
    if hasattr(doc, "events"):  # a live Tracer
        for phase, name, t0_ns, _dur, _tid, _tname, args in doc.events():
            if phase == "i" and name.startswith(prefix):
                out.append({"t": t0_ns / 1e3, "kind": name[len(prefix):],
                            **(args or {})})
        return out
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "i" and name.startswith(prefix):
            # serve traces stamp 1 model pass as 1000 trace-ns and the
            # exporter writes ts in us, so ts IS virtual model passes
            out.append({"t": float(e.get("ts", 0.0)),
                        "kind": name[len(prefix):],
                        **(e.get("args") or {})})
    return out


def autoscale_decisions(doc: Any) -> List[Dict[str, Any]]:
    """The autoscaler's decision instants, read back out of a trace.

    serve/autoscaler.py emits one ``"i"`` instant per actuation
    (``autoscale:scale_up`` / ``:scale_down`` / ``:repair`` /
    ``:budget_exhausted``) on an ``autoscale/<fleet>`` track, with the
    ledger event (its triggering signal included) in ``args``."""
    return _instants(doc, AUTOSCALE_PREFIX)


def sdc_events(doc: Any) -> List[Dict[str, Any]]:
    """The SDC defence's instants, read back out of a trace.

    serve/engine.py emits one ``"i"`` instant per ledger event
    (``sdc:detect`` / ``:quarantine`` / ``:recompute_mismatch`` /
    ``:ship_reject``) on a ``<replica>/sdc`` track, with the slot, the
    trust boundary and the displaced-request count in ``args``, so "which
    boundary caught the flip at t 6?" is answerable from the trace
    alone."""
    return _instants(doc, SDC_PREFIX)


def trace_truncation(doc: Any) -> int:
    """Drop count recorded in a trace's metadata block: > 0 means the ring
    overflowed and the OLDEST events are gone. 0 for bare event lists (no
    metadata — nothing to claim either way)."""
    if hasattr(doc, "dropped_events"):  # a live Tracer
        return int(doc.dropped_events)
    if isinstance(doc, dict):
        meta = doc.get("metadata") or {}
        try:
            return int(meta.get("dropped_events", 0) or 0)
        except (TypeError, ValueError):
            return 0
    return 0


def warn_if_truncated(doc: Any, reducer: str) -> int:
    """Loud stderr banner when ``doc`` is a truncated trace, so a windowed
    ring never silently shrinks the figures a reducer reports. Returns the
    drop count."""
    n = trace_truncation(doc)
    if n:
        cap = ""
        if isinstance(doc, dict):
            c = (doc.get("metadata") or {}).get("capacity")
            cap = f" (ring capacity {c})" if c else ""
        print(f"{reducer}: WARNING: trace is TRUNCATED — {n} oldest events "
              f"were dropped by the ring buffer{cap}; reduced figures "
              "under-count the run. Re-capture with a larger "
              "--trace-capacity.", file=sys.stderr, flush=True)
    return n
