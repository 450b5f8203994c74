"""Serving-fleet chaos benchmark: replica kills, stragglers, deadlines.

The port of ``ddlbench_tpu/tools/servechaos.py``. It drives the replicated
fleet (serve/engine.py :class:`ReplicatedServer`) with a seeded servebench
workload while injecting replica faults, and reports recovery as numbers:
one JSON line, reproducible in virtual time (1 unit = 1 model pass) and
equal to the reference's on every field but the provenance.

Faults (virtual-time schedule, repeatable flags):

* ``--kill T:R`` — HARD-KILL the replica at fleet index R at time T: its
  pool (all resident KV) is lost, its finished records are salvaged, and
  every request it held is resubmitted least-loaded onto the survivors,
  where eviction/recompute regenerates the token streams from scratch.
  The gates: ``requests_lost == 0`` and ``streams_match`` — the
  failed-over streams equal an unfaulted control run's of the same
  workload on the same device.
* ``--stall T:R:D`` — STRAGGLER: the replica makes no progress for D
  global steps while holding its requests. With ``--heartbeat W`` the
  serve-side no-progress detector (train/watchdog.ProgressMonitor on the
  virtual clock) drains it within the window.
* ``--deadline-slack S`` / ``--retry N:B`` / ``--tier-mix F`` — the
  deadline and SLO-tier load shape shared with servebench.

Reported: ``mttr_replica_s`` — per kill, the virtual time from the kill
until the LAST displaced in-flight request emits its first post-failover
token (the ``_s`` suffix is the reference's; the unit is model passes) —
plus ``requests_lost``, ``streams_match``/``streams_diverged`` against the
control, shed/timeout/retry rates, per-tier SLO attainment, heartbeat
drains and the final fleet size.

Self-healing: ``--autoscale LO:HI`` runs the same faults under a
FleetController (serve/autoscaler.py) that repairs killed or drained
replicas through the factory spawn. The tool then also runs the
scripted-recovery baseline (same faults, no controller) when that
schedule survives a fleet that does not repair, and reports
``mttr_scripted_*`` beside ``mttr_replica_s*`` with the
``repair_mttr_le_scripted`` verdict.

All replicas share one device and the one copy of the weights, each with
its own KV pool; on the card a global step runs them one after another,
so ``--wall-clock`` times N replicas taking turns on one card. The model
runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` the tool raises. The reference's ``--corrupt``,
``--no-detect``, ``--scrub`` (the SDC ledger) and ``--disaggregate``
wait for later slices and fail with an error naming their ROADMAP item.

Usage:
    python -m ddlbench_tpu_torch.tools.servechaos [-m transformer_s]
        [-b synthtext] [--replicas 2] [--kill 12:1] [--stall 8:0:6]
        [--heartbeat 4] [--deadline-slack 32] [--retry 2:4]
        [--tier-mix 0.5] [--autoscale 2:2] [--arrival poisson|closed]
        [--rate 0.5] [--requests 64] [--no-control] [--wall-clock]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Tuple

import torch

from ddlbench_tpu_torch.config import DATASETS, ServeConfig
from ddlbench_tpu_torch.device import provenance, resolve_device
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.serve.autoscaler import (AutoscalePolicy,
                                                 make_controllers,
                                                 replica_hours)
from ddlbench_tpu_torch.serve.engine import make_server
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.stats import serve_summary
from ddlbench_tpu_torch.tools.servebench import (NotPorted, _round6,
                                                 _value_error,
                                                 parse_autoscale,
                                                 parse_retry,
                                                 parse_shared_prefix,
                                                 plain_launches,
                                                 run_closed_loop,
                                                 run_open_loop,
                                                 shed_accounting)

# the reference's flags that wait for a later slice -> the ROADMAP item
NOT_PORTED_FLAGS = {
    "--corrupt": "A.4: the SDC ledger and scrub, serve/integrity.py",
    "--no-detect": "A.4: the SDC ledger and scrub, serve/integrity.py",
    "--scrub": "A.4: the SDC ledger and scrub, serve/integrity.py",
    "--disaggregate": "A.4: disaggregation, serve/handoff.py",
}

# the SDC counters the reference's engines carry in every stats summary
# (and so in its rows); the port has no SDC ledger and refuses --corrupt,
# so nothing is injected or detected and each reads 0
SDC_COUNTERS = ("sdc_injected", "sdc_detected", "sdc_quarantined",
                "sdc_recovered", "sdc_scrubbed", "sdc_recompute_checks")


def _parse_kills(specs, perr) -> List[Tuple[float, int]]:
    """``--kill T:R`` specs as (t, fleet index) pairs."""
    out = []
    for s in specs:
        try:
            t_s, r_s = s.split(":")
            out.append((float(t_s), int(r_s)))
        except ValueError:
            perr(f"--kill wants T:R (virtual_time:fleet_index), got {s!r}")
        if out[-1][0] < 0 or out[-1][1] < 0:
            perr(f"--kill {s!r}: T >= 0 and R >= 0")
    return out


def _parse_stalls(specs, perr) -> List[Tuple[float, int, int]]:
    """``--stall T:R:D`` specs as (t, fleet index, ticks) triples."""
    out = []
    for s in specs:
        try:
            t_s, r_s, d_s = s.split(":")
            out.append((float(t_s), int(r_s), int(d_s)))
        except ValueError:
            perr(f"--stall wants T:R:D (time:fleet_index:ticks), got {s!r}")
        if out[-1][0] < 0 or out[-1][1] < 0 or out[-1][2] < 1:
            perr(f"--stall {s!r}: T >= 0, R >= 0, D >= 1")
    return out


def _fault_events(kills, stalls):
    """The drivers' timed-injection schedule: kills and stalls as ``(at,
    fn(server, clock))`` closures (tools/servebench._fire_events). Fleet
    indices are resolved AT FIRE TIME: a kill shrinks the fleet, so later
    specs address the surviving fleet's positions."""
    ev = []

    def kill_fn(r):
        def fire(server, clock):
            rep = server.fail(r, now=clock)
            print(f"servechaos: kill @ {clock:g} -> replica "
                  f"{rep['replica_id']} (salvaged {rep['salvaged']}, "
                  f"displaced {len(rep['displaced_inflight'])} in-flight "
                  f"+ {rep['displaced_queued']} queued)",
                  file=sys.stderr, flush=True)
        return fire

    def stall_fn(r, d):
        def fire(server, clock):
            server.stall(r, d, now=clock)
            print(f"servechaos: stall @ {clock:g} -> replica index {r} "
                  f"for {d} steps", file=sys.stderr, flush=True)
        return fire

    for t, r in kills:
        ev.append((t, kill_fn(r)))
    for t, r, d in stalls:
        ev.append((t, stall_fn(r, d)))
    ev.sort(key=lambda e: e[0])
    return ev


def _run(server, reqs, args, retry, events=None, driver_stats=None,
         controllers=None) -> float:
    if args.arrival == "closed":
        dur = run_closed_loop(server, reqs, args.concurrency,
                              events=events, retry=retry,
                              deadline_slack=args.deadline_slack,
                              driver_stats=driver_stats,
                              controllers=controllers)
    else:
        dur = run_open_loop(server, reqs, events=events, retry=retry,
                            deadline_slack=args.deadline_slack,
                            driver_stats=driver_stats,
                            controllers=controllers)
    for c in controllers or ():
        c.advance(dur)  # settle the ledgers at the final clock
    return dur


def _static_walk_ok(kills, replicas: int) -> bool:
    """Would this kill schedule survive on a fleet that never repairs
    (every kill shrinks it for good)? The feasibility check of the
    scripted-recovery baseline under --autoscale."""
    size = replicas
    for _, r in sorted(kills, key=lambda k: k[0]):
        if size <= 1 or r >= size:
            return False
        size -= 1
    return True


def mttr_from_events(fail_events, finished):
    """Per kill: the virtual time from the kill until the LAST displaced
    in-flight request emitted its first post-failover token (its replay's
    ``first_token_t``: the failover stream restarts from scratch).
    Displaced requests that never completed are left out of that kill's
    sample; a kill with none reports None."""
    fin = {f["rid"]: f for f in finished}
    out = []
    for ev in fail_events:
        recov = [fin[rid]["first_token_t"] - ev["t"]
                 for rid in ev["displaced_inflight"] if rid in fin]
        out.append(max(recov) if recov else None)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="transformer_s")
    p.add_argument("-b", "--benchmark", default="synthtext")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--kill", action="append", default=[], metavar="T:R",
                   help="hard-kill the replica at fleet index R at "
                        "virtual time T (repeatable; pool lost, records "
                        "salvaged, requests failed over)")
    p.add_argument("--stall", action="append", default=[], metavar="T:R:D",
                   help="straggler: replica at fleet index R makes no "
                        "progress for D global steps starting at time T "
                        "(repeatable; pairs with --heartbeat)")
    p.add_argument("--heartbeat", type=float, default=0.0, metavar="W",
                   help="no-progress detection window in time units: a "
                        "stalled replica holding work is drained after W "
                        "(0 = no detection; the stall just delays)")
    p.add_argument("--deadline-slack", type=float, default=None, metavar="S",
                   help="per-request completion deadline = arrival + S "
                        "(expired -> named `timeout`; hopeless at "
                        "admission -> named `shed`)")
    p.add_argument("--retry", default=None, metavar="N:B",
                   help="driver retry policy for shed requests: N "
                        "retries, k-th after B*2^k time units")
    p.add_argument("--tier-mix", type=float, default=None, metavar="F",
                   help="fraction of requests in the preemptible `batch` "
                        "tier (interactive admits ahead, batch evicts "
                        "first; per-tier SLO split reported)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--pool-pages", type=int, default=64)
    p.add_argument("--page", type=int, default=16)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--token-budget", type=int, default=0)
    p.add_argument("--arrival", default="poisson",
                   choices=("poisson", "bursty", "closed"))
    p.add_argument("--rate", type=float, default=0.5)
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--burst-factor", type=float, default=4.0)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--prompt-lens", default="4,16,64")
    p.add_argument("--out-lens", default="2,16,64")
    p.add_argument("--tail-frac", type=float, default=0.25)
    p.add_argument("--slo-ttft", type=float, default=16.0)
    p.add_argument("--slo-itl", type=float, default=2.0)
    p.add_argument("--prefix-cache", action="store_true",
                   help="the cross-request prefix cache (serve/prefix.py)")
    p.add_argument("--shared-prefix", default=None, metavar="G:P",
                   help="shared-prefix workload (servebench's flag): "
                        "prompts draw from G groups sharing a P-token "
                        "prefix")
    p.add_argument("--kv-dtype", default=None,
                   choices=("float32", "bfloat16", "int8"))
    p.add_argument("--speculative", default=None, metavar="ngram:N:K")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the traffic and the random weights")
    p.add_argument("--autoscale", default=None, metavar="LO:HI",
                   help="run the faults under a FleetController "
                        "(serve/autoscaler.py) that repairs killed or "
                        "heartbeat-drained replicas; adds the scripted-"
                        "recovery baseline run (same faults, no "
                        "controller) when the schedule survives a fleet "
                        "that does not repair, and the row gains repairs/"
                        "replica_hours/autoscale_events, mttr_scripted_* "
                        "and the repair-vs-scripted MTTR verdict")
    p.add_argument("--scale-window", type=float, default=32.0, metavar="W",
                   help="autoscale observation-window width in time units")
    p.add_argument("--scale-cooldown", type=float, default=64.0,
                   metavar="C",
                   help="min time between same-direction scale actuations "
                        "(repairs are exempt)")
    p.add_argument("--no-control", action="store_true",
                   help="skip the unfaulted control run (streams_match "
                        "reported as null)")
    p.add_argument("--wall-clock", action="store_true",
                   help="also report the tool's real elapsed seconds")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no card and no --device "
                        "cpu raises")
    for flag, item in NOT_PORTED_FLAGS.items():
        p.add_argument(flag, action=NotPorted, const=item,
                       help=argparse.SUPPRESS,
                       nargs=0 if flag == "--no-detect" else None)
    return p


def check_args(args: argparse.Namespace, perr) -> None:
    """The reference's argument errors, reported through ``perr`` (the
    parser's ``error`` from the command line)."""
    kills = _parse_kills(args.kill, perr)
    stalls = _parse_stalls(args.stall, perr)
    parse_retry(args.retry, perr)
    autoscale = parse_autoscale(args.autoscale, perr)
    if autoscale:
        if args.scale_window <= 0:
            perr("--scale-window must be > 0 time units")
        if args.scale_cooldown < 0:
            perr("--scale-cooldown must be >= 0 time units")
    if args.deadline_slack is not None and args.deadline_slack <= 0:
        perr("--deadline-slack must be > 0 time units")
    if args.retry and args.deadline_slack is None:
        perr("--retry needs --deadline-slack (nothing else sheds)")
    if args.tier_mix is not None and not 0.0 <= args.tier_mix <= 1.0:
        perr("--tier-mix is a probability in [0, 1]")
    if args.heartbeat < 0:
        perr("--heartbeat must be >= 0 (0 = off)")
    if args.replicas < 2 and kills:
        perr("--kill needs --replicas >= 2 (a survivor to fail over to)")
    if not autoscale:
        # every kill shrinks the fleet by one, so walking the kills in
        # time order (stable: equal-time kills fire in spec order) bounds
        # each spec's valid indices exactly
        size = args.replicas
        for t, r in sorted(kills, key=lambda k: k[0]):
            if size <= 1:
                perr(f"--kill {t:g}:{r}: the fleet is already down to its "
                     f"last replica by t={t:g}")
            if r >= size:
                perr(f"--kill {t:g}:{r}: fleet index {r} out of range — "
                     f"at most {size} replicas remain by t={t:g}")
            size -= 1
        for t, r, d in stalls:
            # a kill at the same instant fires first (the event sort)
            size_at_t = args.replicas - sum(1 for kt, _ in kills if kt <= t)
            if r >= size_at_t:
                perr(f"--stall {t:g}:{r}:{d}: fleet index {r} out of "
                     f"range — at most {size_at_t} replicas remain by "
                     f"t={t:g} ({args.replicas} replicas, kills before "
                     f"it)")
    else:
        # a repairing controller re-grows the fleet between faults: each
        # spec just has to address the full fleet
        for t, r in kills:
            if r >= args.replicas:
                perr(f"--kill {t:g}:{r}: fleet index {r} out of range for "
                     f"a {args.replicas}-replica fleet")
        for t, r, d in stalls:
            if r >= args.replicas:
                perr(f"--stall {t:g}:{r}:{d}: fleet index {r} out of "
                     f"range for a {args.replicas}-replica fleet")
    parse_shared_prefix(args.shared_prefix, perr)


def run(args: argparse.Namespace, model: LayerModel,
        device: torch.device
        ) -> Tuple[Dict[str, Any], Dict[str, Any], List[ServeRequest]]:
    """Run the control, the scripted baseline (under --autoscale) and the
    chaos run with ``model`` (already on ``device``). Returns the JSON
    row, the servers by name (``control``, ``baseline``, ``chaos``; the
    ones that ran) and the chaos run's requests."""
    check_args(args, _value_error)
    kills = _parse_kills(args.kill, _value_error)
    stalls = _parse_stalls(args.stall, _value_error)
    retry = parse_retry(args.retry, _value_error)
    autoscale = parse_autoscale(args.autoscale, _value_error)
    groups, prefix_len = parse_shared_prefix(args.shared_prefix,
                                             _value_error)
    if stalls and not args.heartbeat:
        print("servechaos: WARNING --stall without --heartbeat: the "
              "straggler is never detected, its requests just wait it "
              "out", file=sys.stderr, flush=True)
    spec = DATASETS[args.benchmark]
    plo, ptyp, phi = (int(x) for x in args.prompt_lens.split(","))
    olo, otyp, ohi = (int(x) for x in args.out_lens.split(","))
    cfg = ServeConfig(
        max_batch=args.max_batch, pool_pages=args.pool_pages,
        page=args.page, max_len=min(args.max_len, spec.seq_len),
        token_budget=args.token_budget,
        prefill_chunk=(args.page if args.prefill_chunk is None
                       else args.prefill_chunk),
        replicas=args.replicas, slo_ttft=args.slo_ttft,
        slo_itl=args.slo_itl, heartbeat=args.heartbeat,
        kv_dtype=args.kv_dtype or "float32",
        prefix_cache=args.prefix_cache,
        speculative=args.speculative or "none")
    cfg.validate()

    def workload():
        # fresh per run: the closed-loop driver stamps arrivals/deadlines
        return make_workload(
            seed=args.seed, n_requests=args.requests,
            vocab=spec.num_classes, arrival=args.arrival, rate=args.rate,
            burst_size=args.burst_size, burst_factor=args.burst_factor,
            prompt_lo=plo, prompt_typical=ptyp, prompt_hi=phi,
            out_lo=olo, out_typical=otyp, out_hi=ohi,
            tail_frac=args.tail_frac, prefix_groups=groups,
            prefix_len=prefix_len, max_len=cfg.max_len,
            deadline_slack=args.deadline_slack,
            batch_frac=args.tier_mix or 0.0)

    prov = provenance(device)
    plain0 = plain_launches()
    servers: Dict[str, Any] = {}
    t0 = time.perf_counter()
    # -- control: the same workload, no faults: the stream reference
    control = None
    if not args.no_control:
        control = servers["control"] = make_server(model, cfg, device)
        _run(control, workload(), args, retry)
    # -- scripted-recovery baseline (--autoscale only): the same faults
    # with NO controller, so a killed replica stays dead
    scripted_mttrs = None
    if autoscale and kills:
        if _static_walk_ok(kills, args.replicas):
            baseline = servers["baseline"] = make_server(model, cfg, device)
            _run(baseline, workload(), args, retry,
                 events=_fault_events(kills, stalls))
            scripted_mttrs = mttr_from_events(baseline.fail_events,
                                              baseline.finished)
        else:
            print("servechaos: NOTE kill schedule needs the controller's "
                  "repairs to stay feasible; skipping the scripted-"
                  "recovery baseline (mttr_scripted_* reported as null)",
                  file=sys.stderr, flush=True)
    # -- the chaos run
    server = servers["chaos"] = make_server(model, cfg, device)
    controllers = None
    if autoscale:
        controllers = make_controllers(server, AutoscalePolicy(
            lo=autoscale[0], hi=autoscale[1], window=args.scale_window,
            cooldown_up=args.scale_cooldown,
            cooldown_down=args.scale_cooldown))
    dstats: Dict[str, int] = {}
    reqs = workload()
    duration = _run(server, reqs, args, retry,
                    events=_fault_events(kills, stalls),
                    driver_stats=dstats, controllers=controllers)
    wall = time.perf_counter() - t0

    fin = server.finished
    eng_stats = server.stats_summary()
    summary = serve_summary(fin, duration=duration, slo_ttft=args.slo_ttft,
                            slo_itl=args.slo_itl,
                            per_tier=args.tier_mix is not None)
    acct = shed_accounting(args.requests, len(fin),
                           int(eng_stats["shed"]),
                           int(eng_stats["timeouts"]), dstats)
    mttrs = mttr_from_events(server.fail_events, fin)
    mttr_ok = [m for m in mttrs if m is not None]
    # the repair verdict: mean auto-repair MTTR against the scripted
    # baseline's (None when either side has no sample)
    scripted_ok = [m for m in (scripted_mttrs or []) if m is not None]
    repair_le_scripted = None
    if mttr_ok and scripted_ok:
        repair_le_scripted = (sum(mttr_ok) / len(mttr_ok)
                              <= sum(scripted_ok) / len(scripted_ok))
    # the failover gate: every rid completed in BOTH runs carries the
    # identical token stream (deadline runs may time out different rids)
    streams_match = None
    streams_compared = streams_diverged = 0
    if control is not None:
        ctrl_fin = {f["rid"]: f["tokens"] for f in control.finished}
        run_fin = {f["rid"]: f["tokens"] for f in fin}
        both = sorted(set(ctrl_fin) & set(run_fin))
        streams_compared = len(both)
        streams_diverged = sum(1 for rid in both
                               if ctrl_fin[rid] != run_fin[rid])
        streams_match = streams_diverged == 0

    rec = {
        "tool": "servechaos",
        "model": args.model,
        "benchmark": args.benchmark,
        "arrival": args.arrival,
        "rate": args.rate if args.arrival != "closed" else None,
        "concurrency": (args.concurrency if args.arrival == "closed"
                        else None),
        "requests": args.requests,
        "seed": args.seed,
        "replicas": args.replicas,
        "max_batch": cfg.max_batch,
        "pool_pages": cfg.pool_pages,
        "page": cfg.page,
        "max_len": cfg.max_len,
        "time_unit": "model_pass",
        # the injection schedule as given, and what happened
        "kill": args.kill,
        "stall": args.stall,
        "heartbeat": args.heartbeat,
        "deadline_slack": args.deadline_slack,
        "retry": args.retry,
        "tier_mix": args.tier_mix,
        "kv_dtype": cfg.kv_dtype,
        "speculative": cfg.speculative,
        **({"prefix_cache": True, "shared_prefix": args.shared_prefix}
           if args.prefix_cache else {}),
        "kills_fired": len(server.fail_events),
        "stalls_fired": len(server.stall_events),
        "heartbeat_drains": len(server.heartbeat_events),
        "fail_events": server.fail_events,
        "heartbeat_events": [
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in e.items()} for e in server.heartbeat_events],
        "mttr_replica_s": [m if m is None else round(m, 6) for m in mttrs],
        "mttr_replica_s_mean": (round(sum(mttr_ok) / len(mttr_ok), 6)
                                if mttr_ok else None),
        "mttr_replica_s_max": (round(max(mttr_ok), 6) if mttr_ok else None),
        # terminal-state accounting: servebench's formula
        **acct,
        "timeouts": int(eng_stats["timeouts"]),
        "shed": int(eng_stats["shed"]),
        "streams_match": streams_match,
        "streams_compared": streams_compared,
        "streams_diverged": streams_diverged,
        "control_completed": (len(control.finished)
                              if control is not None else None),
        "final_replicas": len(server.engines),
        # --autoscale only: the repair ledger and economics, the scripted
        # baseline's MTTRs, and the repair-vs-scripted verdict
        **({"autoscale": args.autoscale,
            "scale_window": args.scale_window,
            "scale_cooldown": args.scale_cooldown,
            "repairs": sum(c.repairs for c in controllers),
            "scale_events": sum(c.scale_events for c in controllers),
            "replica_hours": round(replica_hours(controllers), 6),
            "autoscale_events": _round6(
                [e for c in controllers for e in c.events]),
            "mttr_scripted_s": (None if scripted_mttrs is None else
                                [m if m is None else round(m, 6)
                                 for m in scripted_mttrs]),
            "mttr_scripted_s_mean": (round(sum(scripted_ok)
                                           / len(scripted_ok), 6)
                                     if scripted_ok else None),
            "mttr_scripted_s_max": (round(max(scripted_ok), 6)
                                    if scripted_ok else None),
            "repair_mttr_le_scripted": repair_le_scripted}
           if autoscale else {}),
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in summary.items()},
        # completed comes from serve_summary; timeouts/shed are in the
        # row already as exact ints
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in eng_stats.items()
           if k not in ("completed", "timeouts", "shed")},
        **{k: 0 for k in SDC_COUNTERS},
        # paged attention calls of the tool's runs that took the plain
        # path on CUDA tensors (0 on the CPU)
        "plain_launches": plain_launches() - plain0,
        **prov,
    }
    if args.wall_clock:
        rec["wall_s"] = round(wall, 3)
    return rec, servers, reqs


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    check_args(args, p.error)
    spec = DATASETS.get(args.benchmark)
    if spec is None or spec.kind != "tokens":
        p.error(f"-b {args.benchmark!r} is not a causal-LM token workload")
    device = resolve_device(args.device)
    model = get_model(args.model, spec, seed=args.seed).to(device)
    rec, _, _ = run(args, model, device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
