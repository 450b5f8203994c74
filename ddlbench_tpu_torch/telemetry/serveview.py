"""Serving-trace reducer: TTFT/ITL decomposition + windowed SLO series.

The port's copy of ``ddlbench_tpu/telemetry/serveview.py``. It turns a
request-lifecycle trace (serve/engine.py under ``ServeConfig.trace``; a
Chrome-trace file or the live in-memory tracer) into where each request's
latency went and when SLOs were missed:

* **TTFT decomposition** — each request's [submit, first_token) window is
  tiled exactly into ``queue`` (``queue_wait`` spans: the arrival wait and
  post-eviction requeue waits), ``prefill`` (steps in which one of its
  prompt chunks ran), ``decode`` (pre-first-token decode passes: the full
  prefix hit, eviction replays) and ``sched_gap`` (admitted but not
  scheduled). Intervals are reduced in the integer domain the engine
  stamped them in (1 model pass = 1000 trace-ns), so the components sum
  to the TTFT exactly; ``decomp_exact`` asserts the tiling per request.
* **ITL decomposition** — each inter-token gap splits into ``decode``
  (steps whose decode pass the request rode) and ``preempted`` (evicted,
  requeued or re-prefilling). Per-token times come from the ``tok``-indexed
  decode spans; across eviction-recompute replays the LAST emission of a
  token index wins, as in the engine's finished records.
* **Windowed SLO attainment + goodput** (``--window W``) — completions
  bucketed into [kW, (k+1)W), each with attainment, output and good
  tokens, goodput per unit and the submissions that arrived in it.

SLOs default from the trace metadata servebench embeds
(``serve.slo_ttft``/``slo_itl``). Truncated traces warn loudly.

CLI::

    python -m ddlbench_tpu_torch.telemetry.serveview trace.json \
        [--window 32] [--slo-ttft 16] [--slo-itl 2.0] [--per-request]
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ddlbench_tpu_torch.telemetry.export import (trace_truncation,
                                                 warn_if_truncated)
from ddlbench_tpu_torch.telemetry.stats import percentile, request_slo_ok


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of intervals as a sorted disjoint list."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _total(merged: List[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in merged)


# virtual milli-units: the engine stamps 1 model pass as 1000 trace-ns
# (telemetry/tracer.Tracer.emit), which the exporter renders as 1 µs —
# all interval math here stays in this integer domain so tilings are
# exact, and only the reported values divide back into model-pass units
_SCALE = 1000.0


def _iter_events(trace: Any) -> Iterable[Tuple[str, str, int, int,
                                               Dict[str, Any]]]:
    """(phase, name, t0, t1, args) in integer trace-ns from a trace dict,
    bare event list, or live Tracer (record order preserved — 'last
    emission wins' relies on it)."""
    if hasattr(trace, "events"):  # a live telemetry.Tracer
        for phase, name, t0_ns, dur_ns, _tid, _tname, args in trace.events():
            yield phase, name, int(t0_ns), int(t0_ns + dur_ns), args or {}
        return
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    for e in events:
        if not isinstance(e, dict) or "ts" not in e:
            continue
        # export wrote ts = ns / 1e3; round() recovers the exact integer
        t0 = int(round(float(e["ts"]) * 1000.0))
        t1 = t0 + int(round(float(e.get("dur", 0.0)) * 1000.0))
        yield e.get("ph", ""), str(e.get("name", "")), t0, t1, \
            e.get("args") or {}


def _serve_metadata(trace: Any) -> Dict[str, Any]:
    if isinstance(trace, dict):
        meta = trace.get("metadata") or {}
        serve = meta.get("serve")
        if isinstance(serve, dict):
            return serve
    return {}


def collect_requests(trace: Any) -> Dict[Any, Dict[str, Any]]:
    """Per-request event record, keyed by rid. Replicas of a
    ReplicatedServer trace into one file on separate tracks, but the
    dispatcher routes each rid to exactly one replica, so the rid is a
    complete key (workload rids are unique by construction)."""
    reqs: Dict[Any, Dict[str, Any]] = {}
    for phase, name, t0, t1, args in _iter_events(trace):
        rid = args.get("rid")
        if rid is None:
            continue
        r = reqs.setdefault(rid, {
            "rid": rid, "submit": None, "finish": None, "first_token": None,
            "queue": [], "prefill": [], "decode": [], "tok_end": {},
            "evictions": 0, "cached_tokens": 0, "n_tokens": None,
        })
        if name == "submit":
            if r["submit"] is None:
                r["submit"] = t0
        elif name == "queue_wait":
            r["queue"].append((t0, t1))
        elif name == "prefill_chunk":
            r["prefill"].append((t0, t1))
        elif name in ("decode", "verify"):
            # a speculative verify span IS the request's decode time for
            # that pass; it may emit several tokens at once (args.emitted)
            # — all stamped at the pass end, matching the engine's
            # token_times
            r["decode"].append((t0, t1))
            tok = args.get("tok")
            if tok is not None:
                for i in range(int(args.get("emitted", 1))):
                    r["tok_end"][int(tok) + i] = t1  # last emission wins
        elif name == "first_token":
            r["first_token"] = t0  # last wins across recompute replays
            r["tok_end"][0] = t0
        elif name == "evict":
            r["evictions"] += 1
        elif name == "admit":
            r["cached_tokens"] = max(r["cached_tokens"],
                                     int(args.get("cached_tokens", 0)))
        elif name == "finish":
            r["finish"] = t0
            r["n_tokens"] = args.get("n_tokens")
    return reqs


def _clip(iv: List[Tuple[int, int]], w0: int,
          w1: int) -> List[Tuple[int, int]]:
    return [(max(a, w0), min(b, w1)) for a, b in iv
            if min(b, w1) > max(a, w0)]


def decompose_request(r: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """TTFT component tiling for one finished request (None when the
    request never produced a first token — still queued/in flight when
    the trace ended)."""
    if r["submit"] is None or r["first_token"] is None:
        return None
    w0, w1 = r["submit"], r["first_token"]
    ttft = w1 - w0
    queue = _clip(_merge(r["queue"]), w0, w1)
    prefill = _clip(_merge(r["prefill"]), w0, w1)
    decode = _clip(_merge(r["decode"]), w0, w1)
    q, p, d = (int(_total(queue)), int(_total(prefill)),
               int(_total(decode)))
    busy = int(_total(_merge(queue + prefill + decode)))
    gap = ttft - busy
    # exact tiling: the three activity classes are disjoint by
    # construction (queue ends where the admitting step starts; spans
    # stamp integer endpoints), so their sum equals the union and
    # q + p + d + gap == ttft identically. False = instrumentation drift.
    exact = (q + p + d == busy) and gap >= 0
    return {
        "rid": r["rid"],
        "ttft": ttft / _SCALE,
        "queue": q / _SCALE,
        "prefill": p / _SCALE,
        "decode": d / _SCALE,
        "sched_gap": gap / _SCALE,
        "exact": exact,
        "evictions": r["evictions"],
        "cached_tokens": r["cached_tokens"],
    }


def _token_times(r: Dict[str, Any]) -> List[int]:
    """Per-token emission times (trace-ns): the final emission of each
    token index, in index order. Indices are contiguous from 0 for a
    finished request; a hole means the trace window lost events."""
    toks = r["tok_end"]
    return [toks[i] for i in range(len(toks)) if i in toks]


def itl_gaps(r: Dict[str, Any]) -> List[Dict[str, float]]:
    """Inter-token gaps of one request, each split into decode time and
    preempted (evicted/requeued/re-prefilling) time — exact in the
    integer domain, same discipline as the TTFT tiling."""
    times = _token_times(r)
    dec_merged = _merge(r["decode"])
    out = []
    for g0, g1 in zip(times, times[1:]):
        dec = int(_total(_clip(dec_merged, g0, g1)))
        out.append({"gap": (g1 - g0) / _SCALE, "decode": dec / _SCALE,
                    "preempted": (g1 - g0 - dec) / _SCALE})
    return out


def _pctl(samples: List[float]) -> Dict[str, float]:
    return {
        "p50": percentile(samples, 50.0),
        "p95": percentile(samples, 95.0),
        "p99": percentile(samples, 99.0),
        "mean": sum(samples) / len(samples) if samples else 0.0,
    }


def _slo_record(r: Dict[str, Any]) -> Dict[str, Any]:
    """A trace-derived request as the record shape
    ``telemetry/stats.request_slo_ok`` takes — ONE predicate decides
    "met the SLO" for servebench's goodput, the engine's snapshot, and
    the windowed attainment here."""
    return {
        "arrival": r["submit"] / _SCALE,
        "first_token_t": r["first_token"] / _SCALE,
        "token_times": [t / _SCALE for t in _token_times(r)],
    }


def timeline(reqs: Dict[Any, Dict[str, Any]], *, window: float,
             slo_ttft: Optional[float] = None,
             slo_itl: Optional[float] = None) -> List[Dict[str, Any]]:
    """Windowed SLO-attainment + goodput series: tumbling buckets of
    ``window`` virtual units over [0, last finish]. Every bucket is
    emitted (empty ones as zeros) so the series is a continuous signal —
    the autoscaler input named by ROADMAP item 2c."""
    if window <= 0:
        raise ValueError(f"window must be > 0, got {window}")
    done = [r for r in reqs.values()
            if r["finish"] is not None and r["first_token"] is not None
            and r["submit"] is not None]
    submits = sorted(r["submit"] / _SCALE for r in reqs.values()
                     if r["submit"] is not None)
    if not done and not submits:
        return []
    hi = max([r["finish"] / _SCALE for r in done] + submits)
    n_buckets = int(hi // window) + 1
    buckets = [{
        "t0": k * window, "t1": (k + 1) * window, "submitted": 0,
        "completed": 0, "slo_ok": 0, "attainment": 0.0,
        "tokens": 0, "good_tokens": 0, "goodput_tokens_per_unit": 0.0,
    } for k in range(n_buckets)]
    for t in submits:
        buckets[min(int(t // window), n_buckets - 1)]["submitted"] += 1
    for r in done:
        b = buckets[min(int((r["finish"] / _SCALE) // window),
                        n_buckets - 1)]
        n_tok = (r["n_tokens"] if r["n_tokens"] is not None
                 else len(r["tok_end"]))
        b["completed"] += 1
        b["tokens"] += n_tok
        if request_slo_ok(_slo_record(r), slo_ttft, slo_itl):
            b["slo_ok"] += 1
            b["good_tokens"] += n_tok
    for b in buckets:
        b["attainment"] = (b["slo_ok"] / b["completed"]
                           if b["completed"] else 0.0)
        b["goodput_tokens_per_unit"] = b["good_tokens"] / window
    return buckets


def breakdown(trace: Any, *, slo_ttft: Optional[float] = None,
              slo_itl: Optional[float] = None,
              window: Optional[float] = None,
              per_request: bool = True) -> Dict[str, Any]:
    """Reduce a serving trace to its latency decomposition + SLO series.

    ``trace``: Chrome trace dict, bare event list, or a live Tracer.
    SLOs default from the ``serve`` metadata block servebench embeds when
    the trace dict carries one. Returns requests/incomplete counts,
    per-component TTFT percentiles, pooled ITL decode/preempted
    percentiles, the exactness flag (every request's components tiled its
    TTFT), optionally the per-request table and — with ``window`` — the
    windowed timeline.
    """
    meta = _serve_metadata(trace)
    if slo_ttft is None:
        slo_ttft = meta.get("slo_ttft")
    if slo_itl is None:
        slo_itl = meta.get("slo_itl")
    reqs = collect_requests(trace)
    decomps = []
    incomplete = 0
    itl_decode: List[float] = []
    itl_preempted: List[float] = []
    for r in reqs.values():
        d = decompose_request(r)
        if d is None:
            incomplete += 1
            continue
        decomps.append(d)
        for g in itl_gaps(r):
            itl_decode.append(g["decode"])
            itl_preempted.append(g["preempted"])
    out: Dict[str, Any] = {
        "requests": len(decomps),
        "incomplete": incomplete,
        "decomp_exact": all(d["exact"] for d in decomps),
        "ttft": {comp: _pctl([d[comp] for d in decomps])
                 for comp in ("ttft", "queue", "prefill", "decode",
                              "sched_gap")},
        "itl": {"decode": _pctl(itl_decode),
                "preempted": _pctl(itl_preempted)},
        "slo_ttft": slo_ttft,
        "slo_itl": slo_itl,
        "dropped_events": trace_truncation(trace),
    }
    if per_request:
        out["per_request"] = sorted(decomps, key=lambda d: d["rid"])
    if window is not None:
        out["window"] = window
        out["timeline"] = timeline(reqs, window=window, slo_ttft=slo_ttft,
                                   slo_itl=slo_itl)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="serveview", description=__doc__)
    p.add_argument("trace", help="Chrome trace-event JSON file written by "
                                 "servebench --trace (or any trace with "
                                 "the engine's event taxonomy)")
    p.add_argument("--window", type=float, default=None,
                   help="emit the windowed SLO/goodput timeline with "
                        "buckets this many virtual units wide")
    p.add_argument("--slo-ttft", type=float, default=None,
                   help="TTFT SLO in virtual units (default: the trace's "
                        "embedded serve metadata)")
    p.add_argument("--slo-itl", type=float, default=None,
                   help="mean inter-token-latency SLO in virtual units "
                        "(default: the trace's embedded serve metadata)")
    p.add_argument("--per-request", action="store_true",
                   help="include the per-request component table "
                        "(omitted by default to keep the JSON small)")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    warn_if_truncated(doc, "serveview")
    out = breakdown(doc, slo_ttft=args.slo_ttft, slo_itl=args.slo_itl,
                    window=args.window, per_request=args.per_request)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
