"""Step-latency and serving latency/goodput aggregation.

The port's copy of ``percentile``, ``latency_summary``, ``request_slo_ok``
and ``serve_summary`` from ``ddlbench_tpu/telemetry/stats.py`` (without the
per-tier split, since the port has no SLO tiers yet). Pure host arithmetic: the same finished
records give the same summary in both packages, bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def percentile(samples: List[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation (numpy default)."""
    if not samples:
        return 0.0
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    s = sorted(samples)
    k = (len(s) - 1) * (q / 100.0)
    lo = math.floor(k)
    hi = math.ceil(k)
    if lo == hi:
        return s[int(k)]
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def latency_summary(samples_s: List[float]) -> Dict[str, float]:
    """p50/p95/p99/max (milliseconds) and the count of one sample set (in
    seconds)."""
    ms = [t * 1e3 for t in samples_s]
    return {
        "p50_ms": percentile(ms, 50.0),
        "p95_ms": percentile(ms, 95.0),
        "p99_ms": percentile(ms, 99.0),
        "max_ms": max(ms) if ms else 0.0,
        "steps": len(ms),
    }


def request_slo_ok(rec: Dict, slo_ttft: Optional[float] = None,
                   slo_itl: Optional[float] = None) -> bool:
    """One finished record's SLO verdict: TTFT <= slo_ttft AND mean ITL
    (TPOT) <= slo_itl; an omitted SLO always passes. ``arrival`` None
    counts as time 0."""
    arrival = rec["arrival"]
    ttft = rec["first_token_t"] - (arrival if arrival is not None else 0.0)
    times = rec["token_times"]
    gaps = [b - a for a, b in zip(times, times[1:])]
    tpot = sum(gaps) / len(gaps) if gaps else 0.0
    return ((slo_ttft is None or ttft <= slo_ttft)
            and (slo_itl is None or tpot <= slo_itl))


def serve_summary(records: List[Dict], *, duration: float,
                  slo_ttft: Optional[float] = None,
                  slo_itl: Optional[float] = None) -> Dict[str, float]:
    """Serving-side latency/goodput aggregation over completed requests.

    TTFT (arrival -> first token) and ITL (gap between consecutive tokens
    of one request, pooled over all requests) p50/p95/p99, plus the
    serving headline — **goodput under SLO**: output tokens per time unit
    counting ONLY requests that met BOTH SLOs (:func:`request_slo_ok`).
    Zero records and/or zero duration return the same key set with zeros.
    """
    ttfts, itls, good_tokens, total_tokens, n_ok = [], [], 0, 0, 0
    for r in records:
        arrival = r["arrival"]
        ttft = r["first_token_t"] - (arrival if arrival is not None
                                     else 0.0)
        times = r["token_times"]
        ttfts.append(ttft)
        itls.extend(b - a for a, b in zip(times, times[1:]))
        total_tokens += r["n_tokens"]
        if request_slo_ok(r, slo_ttft, slo_itl):
            n_ok += 1
            good_tokens += r["n_tokens"]
    out = {
        "completed": len(records),
        "output_tokens": total_tokens,
        "duration": duration,
        "throughput_tokens_per_unit": (total_tokens / duration
                                       if duration > 0 else 0.0),
        "goodput_tokens_per_unit": (good_tokens / duration
                                    if duration > 0 else 0.0),
        "slo_attainment": n_ok / len(records) if records else 0.0,
        # prompt tokens served from the prefix cache
        "prefix_cached_tokens": sum(
            r.get("cached_tokens", 0) for r in records),
    }
    for name, samples in (("ttft", ttfts), ("itl", itls)):
        for q in (50.0, 95.0, 99.0):
            out[f"{name}_p{q:.0f}"] = percentile(samples, q)
    if slo_ttft is not None:
        out["slo_ttft"] = slo_ttft
    if slo_itl is not None:
        out["slo_itl"] = slo_itl
    return out
