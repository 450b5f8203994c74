"""Serving benchmark: continuous batching vs static batching under load.

The port of ``ddlbench_tpu/tools/servebench.py``: the plain row, the
reference's raw-speed levers, its SLO surface and its serving fleet. It
drives the continuous-batching engines (serve/engine.py) with a seeded
open- or closed-loop workload (serve/workload.py) and prints one JSON line per
policy with TTFT and inter-token-latency p50/p95/p99 and **goodput under
SLO** (telemetry/stats.serve_summary), under the reference's keys; the
reference's JAX provenance keys are replaced by the port's device fields
(device.provenance).

The levers, as in the reference: ``--kv-dtype`` stores the KV pool in
bfloat16 or int8 (a quarter of the float32 bytes, quantised at the write,
dequantised inside the attention kernels; the row gains ``kv_dtype``);
``--shared-prefix G:P`` makes G groups of requests that share a P-token
prompt head, and ``--prefix-cache`` serves cached heads from resident pages
on the continuous policy (compare ``prefill_tokens``, ``ttft_p50`` and the
``prefix_*`` fields with and without it); ``--speculative ngram:N:K`` turns
the decode step into a drafted verify pass (token streams those of plain
decoding; the row gains ``speculative``, the ``spec_*`` counters,
``spec_accept_rate`` and ``tokens_per_pass``).

The SLO surface, as in the reference (each field flag-gated, so a plain
row keeps its key set): ``--sample temperature:T[,top-k:K]`` samples on the
host with counter-based seeds (run seed, request id, token index);
``--deadline-slack S`` stamps every request with a completion deadline
(arrival + S): hopeless requests are SHED at admission and retried by the
driver under ``--retry N:B`` (the k-th retry after B*2^k units, then
rejected), expired ones cancel into the ``timeout`` terminal state (the
row gains shed/timeouts/retries/rejected/requests_lost and their rates);
``--tier-mix F`` draws that fraction into the preemptible ``batch`` tier
(the row gains the per-tier split); ``--shape diurnal|ramp|spike`` shapes
the poisson arrivals. ``--trace PATH`` records the request-lifecycle trace
in virtual time and writes it as Chrome trace-event JSON (``PATH.<policy>``
when several policies run); ``--timeline`` reduces it in-process
(telemetry/serveview.py) into the windowed SLO/goodput table and the
TTFT/ITL breakdowns in the row. Tracing changes no field of the row.

The fleet, as in the reference: ``--replicas N`` serves with N replicas
behind a least-loaded dispatcher, ``--resize AT:N`` (repeatable) scales
the live fleet at virtual time AT (scale-down drains replicas onto the
recompute path; no request is lost and the streams are those of an
un-resized run; the row gains ``resize_events``, ``final_replicas``,
``requests_lost``), ``--heartbeat W`` drains a replica that holds work
without progress for more than W units, and ``--autoscale LO:HI`` puts a
FleetController (serve/autoscaler.py) in the loop, which resizes the
fleet within [LO, HI] from windowed SLO signals and repairs killed or
drained replicas (the row gains ``replica_hours``, ``scale_events``,
``repairs``, ``autoscale_attainment``, ``autoscale_events``; the tool
exits nonzero if an autoscaled run loses a request). Every replica sits
on the one card and shares the one copy of the weights, each with its
own KV pool; a global step runs the replicas one after another, so the
wall-clock numbers are those of N engines taking turns on one card.
tools/servechaos.py injects replica kills, stalls and bit flips into the
same drivers.

Disaggregation and the SDC ledger, as in the reference: ``--disaggregate
P:D`` serves with a P-replica prefill fleet feeding a D-replica decode
fleet by KV-page shipping (serve/handoff.py; continuous policy only,
replaces ``--replicas``, excludes ``--resize``; the streams equal the
aggregated fleet's, an int8 pool ships a quarter of the float32 payload
bytes; the row gains ``disaggregate``, ``prefill_replicas``,
``decode_replicas`` and the ``shipped_*`` counters), and ``--scrub N``
arms the page-checksum ledger (serve/integrity.py) and scrubs N stamped
pages a step (0 = boundary checks only; the row gains ``scrub`` and the
``sdc_*`` counters, all 0 on clean traffic). With ``--autoscale`` a
disaggregated server gets one controller per fleet. The reference's
``--serve-tp``, ``--paged-kernel`` and ``--audit`` wait for later slices
and fail naming their ROADMAP item.

Time is VIRTUAL: one unit = one model pass (a [max_batch, 1] decode step or
one prefill chunk), so every virtual-time number is reproducible under a
fixed seed and equal to the reference's for the same traffic.
``--wall-clock`` adds real seconds: the run's wall time, wall-clock output
tokens per second, and the mean decode-step and prefill-chunk times (and
with ``--speculative`` the mean verify-pass time, with ``--sample`` the
mean host time of one draw, with ``--scrub`` the seconds the SDC ledger
spent reading and checksumming slots, ``ledger_s``).

The model runs on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` the tool raises. Each row carries
``plain_launches``: the paged attention calls of the run that took the
plain path on CUDA tensors the kernels refuse (a head dim other than 64; 0
on the CPU).

Usage:
    python -m ddlbench_tpu_torch.tools.servebench [-m transformer_s]
        [-b synthtext] [--arrival poisson|bursty|closed] [--rate 0.5]
        [--requests 64] [--max-batch 8] [--pool-pages 64] [--page 16]
        [--max-len 256] [--slo-ttft 16] [--slo-itl 2.0]
        [--shared-prefix 4:64] [--prefix-cache] [--kv-dtype int8]
        [--speculative ngram:3:4] [--sample temperature:0.8,top-k:40]
        [--deadline-slack 64] [--retry 2:8] [--tier-mix 0.3]
        [--shape diurnal] [--trace PATH [--timeline] [--window 32]]
        [--replicas 2] [--resize 8:1] [--heartbeat 4]
        [--autoscale 1:3 [--scale-window 32] [--scale-cooldown 64]]
        [--disaggregate 1:1] [--scrub 4] [--wall-clock] [--device cpu]
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import List, Tuple

import torch

from ddlbench_tpu_torch.config import DATASETS, ServeConfig
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.ops.paged_decode import (paged_attention,
                                                 paged_chunk_attention)
from ddlbench_tpu_torch.serve.autoscaler import (AutoscalePolicy,
                                                 combined_attainment,
                                                 make_controllers,
                                                 replica_hours)
from ddlbench_tpu_torch.serve.engine import ReplicatedServer, make_server
from ddlbench_tpu_torch.serve.handoff import make_disaggregated
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.export import export_chrome_trace
from ddlbench_tpu_torch.telemetry.serveview import breakdown
from ddlbench_tpu_torch.telemetry.stats import serve_summary
from ddlbench_tpu_torch.telemetry.tracer import Tracer, get_tracer, set_tracer

# engine stats keys that only carry signal under --speculative: left out
# of the other rows, as in the reference, so their key set is unchanged
_SPEC_FIELDS = frozenset((
    "spec_passes", "spec_drafted", "spec_accepted", "decode_tokens",
    "spec_accept_rate", "tokens_per_pass"))

# engine stats keys that only carry signal under --deadline-slack
_CHAOS_FIELDS = frozenset(("shed", "timeouts"))

# stats keys only the disaggregated server emits (the wire-byte counts)
_DISAGG_FIELDS = frozenset((
    "shipped_requests", "shipped_pages", "shipped_payload_bytes",
    "shipped_sidecar_bytes", "shipped_checksum_bytes"))

# stats keys that only carry signal with the SDC ledger armed (--scrub
# here, --corrupt in servechaos): the engine always counts, the row shows
# them only when the flag asked
_SDC_FIELDS = frozenset((
    "sdc_injected", "sdc_detected", "sdc_quarantined", "sdc_recovered",
    "sdc_scrubbed", "sdc_recompute_checks", "sdc_wire_detected",
    "sdc_wire_repaired"))


def _round6(v):
    """round(_, 6) through nested timeline/breakdown structures, so the
    row stays reproducible and diff-friendly."""
    if isinstance(v, float):
        return round(v, 6)
    if isinstance(v, dict):
        return {k: _round6(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_round6(x) for x in v]
    return v


def parse_retry(spec, perr):
    """Parse a ``--retry N:B`` spec: N >= 1 resubmissions, base backoff
    B >= 0. Returns (N, B) or None for an absent spec."""
    if not spec:
        return None
    try:
        n_s, b_s = spec.split(":")
        retry = (int(n_s), float(b_s))
    except ValueError:
        perr(f"--retry wants N:B (retries:base_backoff), got {spec!r}")
    if retry[0] < 1 or retry[1] < 0:
        perr(f"--retry {spec!r}: N >= 1 and B >= 0")
    return retry


def parse_autoscale(spec, perr):
    """Parse ``--autoscale LO:HI`` (the controller's replica clamps).
    Returns (lo, hi) or None for an absent spec."""
    if not spec:
        return None
    try:
        lo_s, hi_s = spec.split(":")
        lohi = (int(lo_s), int(hi_s))
    except ValueError:
        perr(f"--autoscale wants LO:HI (min:max replicas), got {spec!r}")
    if lohi[0] < 1 or lohi[1] < lohi[0]:
        perr(f"--autoscale {spec!r}: needs 1 <= LO <= HI")
    return lohi


def parse_disaggregate(spec, perr):
    """Parse ``--disaggregate P:D`` (prefill:decode replica counts), shared
    with servechaos. Returns (P, D) or None for an absent spec."""
    if not spec:
        return None
    try:
        p_s, d_s = spec.split(":")
        pd = (int(p_s), int(d_s))
    except ValueError:
        perr(f"--disaggregate wants P:D (prefill:decode replicas), "
             f"got {spec!r}")
    if pd[0] < 1 or pd[1] < 1:
        perr(f"--disaggregate {spec!r}: both fleets need >= 1 replica")
    return pd


def parse_resizes(specs, perr) -> List[Tuple[float, int]]:
    """Parse the ``--resize AT:N`` specs into a time-sorted schedule."""
    resizes = []
    for rspec in specs:
        try:
            at_s, n_s = rspec.split(":")
            at, nrep = float(at_s), int(n_s)
        except ValueError:
            perr(f"--resize wants AT:N (virtual_time:replicas), "
                 f"got {rspec!r}")
        if at < 0 or nrep < 1:
            perr(f"--resize {rspec!r}: AT >= 0 and N >= 1")
        resizes.append((at, nrep))
    return sorted(resizes)


def parse_sample(spec, perr) -> Tuple[float, int]:
    """Parse ``--sample temperature:T[,top-k:K]`` into (T, K); (0.0, 0),
    greedy, for an absent spec."""
    temperature, top_k = 0.0, 0
    if not spec:
        return temperature, top_k
    for part in spec.split(","):
        key, _, val = part.partition(":")
        if key == "temperature":
            temperature = float(val)
        elif key == "top-k":
            top_k = int(val)
        else:
            perr(f"--sample parts are temperature:T and top-k:K, "
                 f"got {part!r}")
    if temperature <= 0.0:
        perr("--sample needs temperature:T with T > 0 "
             "(omit --sample for greedy)")
    return temperature, top_k


def parse_shared_prefix(spec, perr) -> Tuple[int, int]:
    """Parse ``--shared-prefix G:P``; (0, 0) for an absent spec."""
    if not spec:
        return 0, 0
    try:
        groups, prefix_len = (int(x) for x in spec.split(":"))
    except ValueError:
        perr("--shared-prefix wants G:P (groups:prefix_tokens), "
             f"got {spec!r}")
    return groups, prefix_len


def check_args(args: argparse.Namespace, perr) -> None:
    """The reference's argument errors, reported through ``perr`` (the
    parser's ``error`` from the command line)."""
    if args.timeline and not args.trace:
        perr("--timeline reduces a recorded trace; pass --trace PATH")
    if args.window <= 0:
        perr("--window must be > 0 time units")
    parse_shared_prefix(args.shared_prefix, perr)
    parse_retry(args.retry, perr)
    disagg = parse_disaggregate(args.disaggregate, perr)
    if parse_autoscale(args.autoscale, perr):
        if args.resize:
            perr("--autoscale closes the resize loop itself; it does "
                 "not compose with a scripted --resize schedule")
        if args.scale_window <= 0:
            perr("--scale-window must be > 0 time units")
        if args.scale_cooldown < 0:
            perr("--scale-cooldown must be >= 0 time units")
    if args.shape and args.arrival != "poisson":
        perr("--shape modulates the poisson arrival process; pass "
             "--arrival poisson")
    if disagg:
        if [s.strip() for s in args.policies.split(",")
                if s.strip()] != ["continuous"]:
            perr("--disaggregate serves the continuous policy only "
                 "(pass --policies continuous); the static baseline's "
                 "fill/drain barrier has no phase boundary to ship at")
        if args.replicas != 1:
            perr("--disaggregate P:D sets both fleet sizes; drop "
                 "--replicas")
        if args.resize:
            perr("--resize scales one aggregated fleet; it does not "
                 "compose with --disaggregate")
    if args.deadline_slack is not None and args.deadline_slack <= 0:
        perr("--deadline-slack must be > 0 time units")
    if args.retry and args.deadline_slack is None:
        perr("--retry retries SHED submissions; nothing is ever shed "
             "without --deadline-slack")
    if args.tier_mix is not None and not 0.0 <= args.tier_mix <= 1.0:
        perr("--tier-mix is a probability in [0, 1]")
    if args.heartbeat < 0:
        perr("--heartbeat must be >= 0 time units (0 = off)")
    if args.scrub is not None and args.scrub < 0:
        perr("--scrub must be >= 0 pages per step (0 arms the ledger "
             "with boundary verification only)")
    parse_resizes(args.resize, perr)
    parse_sample(args.sample, perr)


def shed_accounting(requests, completed, shed, timeouts, driver_stats):
    """Terminal-state accounting: every request ends completed, timed out
    or rejected; anything else is lost (``requests_lost == 0`` is the
    invariant)."""
    retries = driver_stats.get("retries", 0)
    rejected = driver_stats.get("rejected", 0)
    submissions = requests + retries
    return {
        "retries": retries,
        "rejected": rejected,
        "requests_lost": requests - completed - timeouts - rejected,
        # zero-request rows keep the schema with all-zero rates
        "shed_rate": (round(shed / submissions, 6) if submissions else 0.0),
        "timeout_rate": (round(timeouts / requests, 6)
                         if requests else 0.0),
        "retry_amplification": (round(submissions / requests, 6)
                                if requests else 1.0),
    }


class _Submitter:
    """Driver-side admission with the bounded retry-with-backoff policy: a
    SHED submission (deadline admission control refused it) retries after
    ``backoff * 2**attempt`` time units, up to ``retries`` times, then
    goes terminal as REJECTED; ``stats`` collects ``retries`` and
    ``rejected`` for the row. With no deadlines nothing is shed and this
    is plain ``server.submit``."""

    def __init__(self, server, retry=None, deadline_slack=None, stats=None):
        self.server = server
        self.retries, self.backoff = retry if retry else (0, 1.0)
        self.slack = deadline_slack
        self.pending = []  # (due, rid, attempt, req), sorted by due
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("retries", 0)
        self.stats.setdefault("rejected", 0)

    def offer(self, req, clock: float, attempt: int = 0) -> str:
        """One submission attempt -> "ok" | "retry" | "rejected"."""
        if req.arrival is None:
            req.arrival = clock  # closed loop stamps at release
        if self.slack is not None and req.deadline is None:
            # closed-loop deadline stamp: the workload could not know the
            # release time (open-loop requests arrive stamped)
            req.deadline = req.arrival + self.slack
        if self.server.submit(req, now=clock):
            return "ok"
        if attempt < self.retries:
            self.stats["retries"] += 1
            bisect.insort(self.pending,
                          (clock + self.backoff * (2 ** attempt),
                           req.rid, attempt + 1, req))
            return "retry"
        self.stats["rejected"] += 1
        return "rejected"

    def release_due(self, clock: float) -> int:
        """Fire due retries; returns how many went terminal (rejected)."""
        dead = 0
        while self.pending and self.pending[0][0] <= clock:
            _, _, attempt, req = self.pending.pop(0)
            if self.offer(req, clock, attempt) == "rejected":
                dead += 1
        return dead

    def next_due(self):
        return self.pending[0][0] if self.pending else None


def _resize_fn(n: int):
    def fire(server, clock):
        rep = server.resize(n, now=clock)
        print(f"servebench: resize @ {clock:g} -> {n} replicas "
              f"(evicted {rep['evicted']}, redistributed "
              f"{rep['redistributed']})", file=sys.stderr, flush=True)
    return fire


def _merge_events(resizes, events):
    """One sorted ``(at, fn(server, clock))`` schedule from the ``(at, n)``
    resize specs plus other timed injections (servechaos passes its kill
    and stall closures through ``events``)."""
    ev = [(at, _resize_fn(n)) for at, n in (resizes or [])]
    ev.extend(events or [])
    ev.sort(key=lambda e: e[0])
    return ev


def _fire_events(server, clock: float, events):
    """Fire every due ``(at, fn)`` event of a sorted list the caller
    consumes: resizes, replica kills, stalls."""
    while events and clock >= events[0][0]:
        _, fn = events.pop(0)
        fn(server, clock)


def _advance_controllers(controllers, clock: float):
    """Bring every autoscale controller up to the virtual clock, after
    each global step and idle jump, so its decisions land at
    deterministic instants."""
    for c in controllers or ():
        c.advance(clock)


def run_open_loop(server, reqs, resizes=None, events=None, retry=None,
                  deadline_slack=None, driver_stats=None,
                  controllers=None) -> float:
    """Release requests at their arrival times; returns the final clock.
    ``events`` is a list of timed ``(at, fn(server, clock))`` injections
    (``resizes``, ``(at, n)`` pairs, are sugar for them);
    ``retry=(N, backoff)`` arms the shed retry policy and
    ``driver_stats`` (a dict) receives its counters; ``controllers`` are
    autoscale controllers advanced in lockstep with the virtual clock."""
    clock, i = 0.0, 0
    ev = _merge_events(resizes, events)
    sub = _Submitter(server, retry, deadline_slack, driver_stats)
    pend = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    while i < len(pend) or sub.pending or server.has_work():
        _fire_events(server, clock, ev)
        sub.release_due(clock)
        while i < len(pend) and pend[i].arrival <= clock:
            sub.offer(pend[i], clock)
            i += 1
        if not server.has_work():
            # idle: jump to the next arrival, pending retry or scheduled
            # injection (an injection fires under the load its schedule
            # names; one dated past the end of all work never fires)
            nxts = [t for t in (
                pend[i].arrival if i < len(pend) else None,
                sub.next_due(),
                ev[0][0] if ev else None) if t is not None]
            if not nxts:
                break
            clock = max(clock, min(nxts))
            # the controllers see idle time too: the diurnal trough's
            # scale-downs come from it
            _advance_controllers(controllers, clock)
            continue
        rep = server.step(clock)
        clock += rep.cost
        _advance_controllers(controllers, clock)
    return clock


def run_closed_loop(server, reqs, concurrency: int, resizes=None,
                    events=None, retry=None, deadline_slack=None,
                    driver_stats=None, controllers=None) -> float:
    """Keep ``concurrency`` requests in flight; each TERMINAL event —
    completion, timeout, or a shed request exhausting its retries —
    releases the next. Returns the final clock."""
    clock, nxt, done = 0.0, 0, 0
    ev = _merge_events(resizes, events)
    sub = _Submitter(server, retry, deadline_slack, driver_stats)
    n = len(reqs)
    outstanding = 0  # released and not yet terminal (incl. pending retry)

    def top_up():
        nonlocal nxt, done, outstanding
        while nxt < n and outstanding < concurrency:
            st = sub.offer(reqs[nxt], clock)
            nxt += 1
            if st == "rejected":
                done += 1
            else:
                outstanding += 1

    top_up()
    while done < n:
        _fire_events(server, clock, ev)
        dead = sub.release_due(clock)
        done += dead
        outstanding -= dead
        top_up()
        if not server.has_work():
            # jump to the next retry or scheduled injection
            nxts = [t for t in (sub.next_due(), ev[0][0] if ev else None)
                    if t is not None]
            if nxts:
                clock = max(clock, min(nxts))
                _advance_controllers(controllers, clock)
                continue
            if outstanding:
                # a server-internal shed (a failover, drain or resize
                # under deadlines) retires a request with no completion
                # or timeout the driver sees; it would hold its slot
                # forever. The vanished requests are terminal (they show
                # in requests_lost) and their slots release the tail
                done += outstanding
                outstanding = 0
                top_up()
                continue
            break  # everything released went terminal
        rep = server.step(clock)
        clock += rep.cost
        _advance_controllers(controllers, clock)
        term = len(rep.completed) + len(rep.timed_out)
        done += term
        outstanding -= term
        top_up()
    return clock


# the reference's flags that wait for a later slice -> the ROADMAP item
NOT_PORTED_FLAGS = {
    "--serve-tp": "A.7: a tp > 1 replica needs tp devices",
    "--paged-kernel": "A.8: the Pallas kernels' math formulations",
    "--audit": "A.8: telemetry/audit.py",
}


class NotPorted(argparse.Action):
    """A reference flag the port lacks: using it is an error that names
    the ROADMAP item it waits on (the action's ``const``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to the PyTorch "
                     f"serving path yet (ROADMAP {self.const})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="transformer_s")
    p.add_argument("-b", "--benchmark", default="synthtext")
    p.add_argument("--policies", default="continuous,static",
                   help="comma list among continuous,static — each runs "
                        "the same workload at the same pool size")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--pool-pages", type=int, default=64)
    p.add_argument("--page", type=int, default=16)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="tokens per prefill call (page multiple; default: "
                        "one page; 0 = whole prompt in one padded call)")
    p.add_argument("--token-budget", type=int, default=0,
                   help="tokens one step may pack (0 = max_batch + 2 "
                        "prefill chunks)")
    p.add_argument("--replicas", type=int, default=1,
                   help="independent serving replicas (least-loaded "
                        "dispatch); all of them share the one card and "
                        "the one copy of the weights, each with its own "
                        "KV pool")
    p.add_argument("--resize", action="append", default=[], metavar="AT:N",
                   help="live replica resize schedule (repeatable): at "
                        "virtual time AT scale the fleet to N replicas "
                        "under load — scale-down drains replicas (in-"
                        "flight requests evicted onto the recompute path, "
                        "queues redistributed least-loaded). No request is "
                        "lost and token streams are those of an "
                        "un-resized run; the row gains resize_events/"
                        "final_replicas/requests_lost fields")
    p.add_argument("--disaggregate", default=None, metavar="P:D",
                   help="disaggregated serving: a P-replica PREFILL fleet "
                        "feeds a D-replica DECODE fleet by KV-page "
                        "shipping (serve/handoff.py); int8 pools ship a "
                        "quarter of the float32 payload bytes. The streams "
                        "equal the aggregated fleet's; the row gains "
                        "disaggregate/prefill_replicas/decode_replicas and "
                        "shipped_* fields. Continuous policy only; "
                        "replaces --replicas and excludes --resize")
    p.add_argument("--autoscale", default=None, metavar="LO:HI",
                   help="close the loop: a FleetController "
                        "(serve/autoscaler.py) watches windowed SLO "
                        "attainment/goodput and shed/timeout/queue signals "
                        "and resizes the fleet live within [LO, HI], "
                        "auto-repairing killed or heartbeat-drained "
                        "replicas. The row gains replica_hours/"
                        "scale_events/repairs/autoscale_attainment and the "
                        "decision ledger; the tool exits nonzero if the "
                        "run loses a request. Excludes --resize")
    p.add_argument("--scale-window", type=float, default=32.0, metavar="W",
                   help="autoscale observation-window width in time units "
                        "(one decision per window)")
    p.add_argument("--scale-cooldown", type=float, default=64.0,
                   metavar="C",
                   help="min time between same-direction autoscale "
                        "actuations (repairs are exempt)")
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "bursty", "closed"))
    p.add_argument("--shape", default=None,
                   choices=("diurnal", "ramp", "spike"),
                   help="traffic shape layered on --arrival poisson: the "
                        "rate curve (daily cycle / linear ramp / flash "
                        "crowd) scales inter-arrivals drawn from a "
                        "separate seeded stream, so prompts are the same "
                        "for every shape")
    p.add_argument("--rate", type=float, default=0.5,
                   help="open-loop arrival rate (requests per model pass; "
                        "with --shape, the peak rate)")
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--burst-factor", type=float, default=4.0)
    p.add_argument("--concurrency", type=int, default=16,
                   help="closed-loop in-flight request count")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--prompt-lens", default="4,16,64",
                   help="lo,typical,hi of the heavy-tail prompt mixture")
    p.add_argument("--out-lens", default="2,16,64",
                   help="lo,typical,hi of the heavy-tail output mixture")
    p.add_argument("--tail-frac", type=float, default=0.25)
    p.add_argument("--shared-prefix", default=None, metavar="G:P",
                   help="shared-prefix traffic: G prefix groups of P "
                        "tokens each; every prompt = one group's prefix + "
                        "a unique heavy-tail tail")
    p.add_argument("--prefix-cache", action="store_true",
                   help="the cross-request prefix cache on the continuous "
                        "policy (the static baseline always runs without "
                        "it and reports the cache counters as 0)")
    p.add_argument("--kv-dtype", default=None,
                   choices=("float32", "bfloat16", "int8"),
                   help="KV-pool storage dtype: bfloat16 halves the pool "
                        "bytes, int8 quarters them; the row gains a "
                        "kv_dtype field")
    p.add_argument("--speculative", default=None, metavar="ngram:N:K",
                   help="self-drafting speculative decoding: an N-gram "
                        "drafter proposes up to K tokens per decode row, "
                        "verified in one K+1-wide pass priced as one model "
                        "pass; the row gains speculative/spec_*/"
                        "tokens_per_pass fields")
    p.add_argument("--scrub", type=int, default=None, metavar="N",
                   help="arm the SDC checksum ledger (serve/integrity.py) "
                        "and scrub N stamped pool pages per step (0 = "
                        "boundary verification only): the clean-traffic "
                        "cost of the defence servechaos exercises under "
                        "--corrupt. The row gains scrub and the sdc_* "
                        "counters (all zero without injected faults)")
    p.add_argument("--sample", default=None, metavar="temperature:T[,top-k:K]",
                   help="sample instead of greedy argmax: softmax(logits/T)"
                        " with optional top-k restriction, counter-based "
                        "per-request seeds (run seed + request id + token "
                        "index) so streams are reproducible; default greedy")
    p.add_argument("--slo-ttft", type=float, default=16.0,
                   help="TTFT SLO in time units (model passes)")
    p.add_argument("--slo-itl", type=float, default=2.0,
                   help="mean inter-token-latency SLO in time units")
    p.add_argument("--deadline-slack", type=float, default=None,
                   metavar="S",
                   help="per-request completion deadline = arrival + S "
                        "time units: the engine SHEDS a request at "
                        "admission when its projected completion already "
                        "misses the deadline (see --retry) and cancels an "
                        "expired one into the `timeout` terminal state "
                        "with all pages freed; the row gains shed/"
                        "timeouts/retries/rejected/requests_lost and rates")
    p.add_argument("--retry", default=None, metavar="N:B",
                   help="bounded retry-with-backoff for SHED requests: up "
                        "to N resubmissions, the k-th after B*2^k time "
                        "units, then rejected. Needs --deadline-slack")
    p.add_argument("--tier-mix", type=float, default=None, metavar="F",
                   help="SLO tiers: each request is tier=batch with "
                        "probability F (else interactive); interactive "
                        "admits ahead of batch and batch is evicted first. "
                        "The row gains per-tier TTFT/ITL/goodput/"
                        "attainment")
    p.add_argument("--heartbeat", type=float, default=0.0, metavar="W",
                   help="serve-side straggler heartbeat: a replica "
                        "holding work with no progress for > W time units "
                        "is drained and its requests redistribute to the "
                        "survivors (0 = off)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the request-lifecycle trace (virtual-time "
                        "spans and counters, one track per request) and "
                        "write Chrome trace-event JSON here — PATH.<policy> "
                        "when several policies run. The row is the same "
                        "with or without it")
    p.add_argument("--trace-capacity", type=int, default=200_000,
                   help="trace ring size in events (the ring keeps the "
                        "newest window and the metadata records drops)")
    p.add_argument("--timeline", action="store_true",
                   help="with --trace: reduce the trace (telemetry/"
                        "serveview.py) and put the windowed SLO/goodput "
                        "table and the TTFT/ITL breakdowns in the row")
    p.add_argument("--window", type=float, default=32.0,
                   help="timeline bucket width in time units "
                        "(with --timeline)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the traffic and the random weights")
    p.add_argument("--wall-clock", action="store_true",
                   help="also report real elapsed seconds, wall-clock "
                        "tokens/s, mean decode-step / prefill-chunk ms and "
                        "with --sample the mean host ms of one draw")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no card and no --device "
                        "cpu raises")
    for flag, item in NOT_PORTED_FLAGS.items():
        p.add_argument(flag, action=NotPorted, const=item,
                       help=argparse.SUPPRESS)
    return p


def _value_error(msg):
    raise ValueError(msg)


def plain_launches() -> int:
    """Paged attention calls so far that took the plain path on CUDA
    tensors the kernels refuse."""
    return (paged_attention.plain_launches
            + paged_chunk_attention.plain_launches)


def run(args: argparse.Namespace, model: LayerModel,
        device: torch.device
        ) -> List[Tuple[dict, ReplicatedServer, List[ServeRequest]]]:
    """Serve the workload under each policy with ``model`` (already on
    ``device``). Returns one (JSON row, server, requests) per policy."""
    check_args(args, _value_error)
    spec = DATASETS[args.benchmark]
    plo, ptyp, phi = (int(x) for x in args.prompt_lens.split(","))
    olo, otyp, ohi = (int(x) for x in args.out_lens.split(","))
    policies = [s.strip() for s in args.policies.split(",") if s.strip()]
    groups, prefix_len = parse_shared_prefix(args.shared_prefix,
                                             _value_error)
    retry = parse_retry(args.retry, _value_error)
    autoscale = parse_autoscale(args.autoscale, _value_error)
    resizes = parse_resizes(args.resize, _value_error)
    temperature, top_k = parse_sample(args.sample, _value_error)
    disagg = parse_disaggregate(args.disaggregate, _value_error)
    # under --autoscale the initial fleet is --replicas clamped into the
    # band; the controller takes it from there
    replicas0 = (max(autoscale[0], min(autoscale[1], args.replicas))
                 if autoscale else args.replicas)
    base = ServeConfig(
        max_batch=args.max_batch, pool_pages=args.pool_pages,
        page=args.page, max_len=min(args.max_len, spec.seq_len),
        token_budget=args.token_budget,
        prefill_chunk=(args.page if args.prefill_chunk is None
                       else args.prefill_chunk),
        replicas=replicas0, heartbeat=args.heartbeat,
        temperature=temperature, top_k=top_k, sample_seed=args.seed,
        trace=bool(args.trace),
        slo_ttft=args.slo_ttft, slo_itl=args.slo_itl,
        kv_dtype=args.kv_dtype or "float32",
        speculative=args.speculative or "none",
        integrity=args.scrub is not None, scrub=args.scrub or 0)
    prov = provenance(device)
    out = []
    for policy in policies:
        # the static baseline is cache-off by definition; its row still
        # carries the prefix counters, as zeros
        cfg = base.replace(
            policy=policy,
            prefix_cache=args.prefix_cache and policy == "continuous")
        cfg.validate()
        # fresh workload per policy: the closed-loop driver stamps
        # arrivals, and both policies must see identical traffic
        reqs = make_workload(
            seed=args.seed, n_requests=args.requests,
            vocab=spec.num_classes, arrival=args.arrival, rate=args.rate,
            shape=args.shape, burst_size=args.burst_size,
            burst_factor=args.burst_factor,
            prompt_lo=plo, prompt_typical=ptyp, prompt_hi=phi,
            out_lo=olo, out_typical=otyp, out_hi=ohi,
            tail_frac=args.tail_frac, prefix_groups=groups,
            prefix_len=prefix_len, max_len=cfg.max_len,
            deadline_slack=args.deadline_slack,
            batch_frac=args.tier_mix or 0.0)
        if disagg:
            server = make_disaggregated(model, cfg, device, *disagg)
        else:
            server = make_server(model, cfg, device)
        controllers = None
        if autoscale:
            controllers = make_controllers(server, AutoscalePolicy(
                lo=autoscale[0], hi=autoscale[1], window=args.scale_window,
                cooldown_up=args.scale_cooldown,
                cooldown_down=args.scale_cooldown))
        # one fresh bounded ring per policy row, installed process-global
        # (the engine looks it up lazily) and restored afterwards
        tracer = prev_tracer = None
        if args.trace:
            prev_tracer = get_tracer()
            tracer = set_tracer(Tracer(args.trace_capacity)).enable()
        dstats: dict = {}
        plain0 = plain_launches()
        t0 = time.perf_counter()
        try:
            if args.arrival == "closed":
                duration = run_closed_loop(
                    server, reqs, args.concurrency, resizes=resizes,
                    retry=retry, deadline_slack=args.deadline_slack,
                    driver_stats=dstats, controllers=controllers)
            else:
                duration = run_open_loop(
                    server, reqs, resizes=resizes, retry=retry,
                    deadline_slack=args.deadline_slack, driver_stats=dstats,
                    controllers=controllers)
            # settle the controllers' ledgers at the final clock
            _advance_controllers(controllers, duration)
        finally:
            if tracer is not None:
                tracer.disable()
                set_tracer(prev_tracer)
        wall = time.perf_counter() - t0
        if len(server.resize_events) < len(resizes):
            unfired = [f"{at:g}:{n}" for at, n in
                       resizes[len(server.resize_events):]]
            print(f"servebench: WARNING {len(unfired)} --resize event(s) "
                  f"dated past the end of work never fired "
                  f"({', '.join(unfired)}); the run drained at "
                  f"{duration:g}", file=sys.stderr, flush=True)
        timeline_fields = {}
        if tracer is not None:
            if args.timeline:
                bd = breakdown(tracer, slo_ttft=args.slo_ttft,
                               slo_itl=args.slo_itl, window=args.window,
                               per_request=False)
                timeline_fields = {
                    "window": args.window,
                    "timeline": _round6(bd["timeline"]),
                    "ttft_breakdown": _round6(bd["ttft"]),
                    "itl_breakdown": _round6(bd["itl"]),
                    "decomp_exact": bd["decomp_exact"],
                }
            path = (args.trace if len(policies) == 1
                    else f"{args.trace}.{policy}")
            n = export_chrome_trace(tracer, path, extra_metadata={
                "serve": {"tool": "servebench", "policy": policy,
                          "tp": cfg.tp, "replicas": cfg.replicas,
                          "slo_ttft": args.slo_ttft,
                          "slo_itl": args.slo_itl,
                          "time_unit": "model_pass",
                          "seed": args.seed}})
            print(f"servebench: {n} trace events written to {path}"
                  + (f" ({tracer.dropped_events} dropped: ring full)"
                     if tracer.dropped_events else ""),
                  file=sys.stderr, flush=True)
        fin = server.finished
        summary = serve_summary(fin, duration=duration,
                                slo_ttft=args.slo_ttft,
                                slo_itl=args.slo_itl,
                                per_tier=args.tier_mix is not None)
        eng_stats = server.stats_summary()
        chaos = args.deadline_slack is not None
        sdc = args.scrub is not None
        acct = shed_accounting(args.requests, len(fin),
                               int(eng_stats["shed"]),
                               int(eng_stats["timeouts"]), dstats)
        lost = acct["requests_lost"]
        rec = {
            "tool": "servebench",
            "model": args.model,
            "benchmark": args.benchmark,
            "policy": policy,
            "arrival": args.arrival,
            **({"shape": args.shape} if args.shape else {}),
            "rate": args.rate if args.arrival != "closed" else None,
            "concurrency": (args.concurrency if args.arrival == "closed"
                            else None),
            "requests": args.requests,
            "seed": args.seed,
            "max_batch": cfg.max_batch,
            "pool_pages": cfg.pool_pages,
            "page": cfg.page,
            "max_len": cfg.max_len,
            "prefill_chunk": cfg.resolved_prefill_chunk(),
            "token_budget": cfg.resolved_token_budget(),
            "replicas": cfg.replicas,
            "prefix_cache": cfg.prefix_cache,
            "shared_prefix": args.shared_prefix,
            "sample": args.sample,
            "time_unit": "model_pass",
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in summary.items()},
            # serve_summary already reports completed; the speculative
            # counters only show under --speculative, the deadline ones
            # under --deadline-slack, the shipping ones under
            # --disaggregate and the SDC ones under --scrub
            **{k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in eng_stats.items()
               if k != "completed"
               and (args.speculative or k not in _SPEC_FIELDS)
               and (chaos or k not in _CHAOS_FIELDS)
               and (disagg or k not in _DISAGG_FIELDS)
               and (sdc or k not in _SDC_FIELDS)},
            # --disaggregate only: the fleet split
            **({"disaggregate": args.disaggregate,
                "prefill_replicas": disagg[0],
                "decode_replicas": disagg[1]} if disagg else {}),
            **({"kv_dtype": cfg.kv_dtype} if args.kv_dtype else {}),
            **({"speculative": cfg.speculative}
               if args.speculative else {}),
            # --scrub only: the budget behind the sdc_* counters
            **({"scrub": cfg.scrub} if sdc else {}),
            # --timeline only: windowed SLO/goodput series + TTFT/ITL
            # component breakdowns
            **timeline_fields,
            # --deadline-slack only: the knob, the driver's retry outcome
            # and the shed/timeout economics
            **({"deadline_slack": args.deadline_slack,
                "retry": args.retry, **acct} if chaos else {}),
            # --tier-mix only: the per-tier split rides serve_summary
            **({"tier_mix": args.tier_mix}
               if args.tier_mix is not None else {}),
            # --heartbeat only: straggler drains
            **({"heartbeat": args.heartbeat,
                "heartbeat_drains": len(server.heartbeat_events)}
               if args.heartbeat else {}),
            # --resize only: the schedule, what each event displaced, the
            # schedule entries dated past the end of work (never fired),
            # the final fleet size and the no-request-lost invariant
            **({"resize": args.resize,
                "resize_events": server.resize_events,
                "resizes_unfired": len(resizes) - len(server.resize_events),
                "final_replicas": len(server.engines),
                "requests_lost": lost}
               if args.resize else {}),
            # --autoscale only: the replica-hours used, every decision
            # with its signal, and the no-loss invariant the exit code
            # gates on
            **({"autoscale": args.autoscale,
                "scale_window": args.scale_window,
                "scale_cooldown": args.scale_cooldown,
                "replica_hours": round(replica_hours(controllers), 6),
                "scale_events": sum(c.scale_events for c in controllers),
                "repairs": sum(c.repairs for c in controllers),
                "autoscale_attainment": round(
                    combined_attainment(controllers), 6),
                "autoscale_events": _round6(
                    [e for c in controllers for e in c.events]),
                "final_replicas": len(server.engines),
                "requests_lost": lost}
               if autoscale else {}),
            "plain_launches": plain_launches() - plain0,
            **prov,
        }
        if args.wall_clock:
            # every replica's passes, retired ones included; on one card
            # the replicas take turns, so these are per-pass times
            engines = server.engines + server.retired
            w = {k: sum(e.wall[k] for e in engines) for k in engines[0].wall}
            st = {k: sum(e.stats[k] for e in engines)
                  for k in ("decode_calls", "prefill_calls", "spec_passes")}
            rec["wall_s"] = round(wall, 3)
            rec["wall_tokens_per_s"] = round(
                summary["output_tokens"] / wall, 3) if wall > 0 else 0.0
            rec["decode_step_ms"] = round(
                1e3 * w["decode_s"] / st["decode_calls"], 4) \
                if st["decode_calls"] else 0.0
            rec["prefill_chunk_ms"] = round(
                1e3 * w["prefill_s"] / st["prefill_calls"], 4) \
                if st["prefill_calls"] else 0.0
            if args.speculative:
                rec["verify_step_ms"] = round(
                    1e3 * w["verify_s"] / st["spec_passes"], 4) \
                    if st["spec_passes"] else 0.0
            if args.sample:
                rec["sample_ms"] = round(
                    1e3 * w["sample_s"] / w["sampled"], 4) \
                    if w["sampled"] else 0.0
            if sdc:
                # the SDC ledger's device reads and checksums, in all
                rec["ledger_s"] = round(w["ledger_s"], 4)
        out.append((rec, server, reqs))
    return out


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    check_args(args, p.error)
    spec = DATASETS.get(args.benchmark)
    if spec is None or spec.kind != "tokens":
        p.error(f"-b {args.benchmark!r} is not a causal-LM token workload; "
                "the serving engine serves causal LMs (e.g. synthtext)")
    device = resolve_device(args.device)
    model = get_model(args.model, spec, seed=args.seed).to(device)
    try:
        results = run(args, model, device)
    except NotImplementedError as e:  # a model without serving ops
        p.error(str(e))
    rc = 0
    for rec, _, _ in results:
        print(json.dumps(rec), flush=True)
        if args.autoscale and rec["requests_lost"] != 0:
            # a self-scaling fleet that loses requests is a broken
            # controller
            print(f"servebench: FAILED no-loss gate under --autoscale: "
                  f"requests_lost={rec['requests_lost']} on policy "
                  f"{rec['policy']}", file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
