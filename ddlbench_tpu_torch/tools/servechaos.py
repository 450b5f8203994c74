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
* ``--corrupt T:R:TARGET[@L.S]`` — SILENT DATA CORRUPTION: flip one real
  bit at time T in replica R's data plane (serve/integrity.py). TARGET is
  ``payload`` (a settled KV pool page), ``sidecar`` (an int8 scale row;
  needs ``--kv-dtype int8``), ``prefix`` (a prefix-cache page, shared when
  one is) or ``ship`` (an in-flight handoff ship; needs
  ``--disaggregate``, and R is 0: the wire has no replica index). ``@L.S``
  pins the model layer and pool slot; without it a settled resident page
  is picked at fire time. Any ``--corrupt`` arms the checksum ledger
  unless ``--no-detect`` asks for the run without a defence; ``--scrub N``
  budgets the scrubber at N pages a step (default: the whole pool). With
  detection on, the gate is ``--kill``'s: streams equal the control's and
  ``requests_lost == 0``; with ``--no-detect`` the row reports the
  divergence that escaped (``sdc_escaped``).
* ``--disaggregate P:D`` — chaos on the disaggregated layout
  (serve/handoff.py): a P-replica prefill fleet feeding a D-replica decode
  fleet. ``--kill`` then takes ``T:pR`` or ``T:dR`` to name the fleet (a
  decode kill routes its requests back through the prefill fleet).

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
``--device cpu`` the tool raises.

Usage:
    python -m ddlbench_tpu_torch.tools.servechaos [-m transformer_s]
        [-b synthtext] [--replicas 2] [--kill 12:1] [--stall 8:0:6]
        [--corrupt 10:0:payload] [--no-detect] [--scrub 4]
        [--disaggregate 1:2 --kill 6:d0] [--heartbeat 4] [--deadline-slack 32] [--retry 2:4]
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
from ddlbench_tpu_torch.serve import integrity as I
from ddlbench_tpu_torch.serve.engine import make_server
from ddlbench_tpu_torch.serve.handoff import make_disaggregated
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.telemetry.stats import serve_summary
from ddlbench_tpu_torch.tools.servebench import (_round6, _value_error,
                                                 parse_autoscale,
                                                 parse_disaggregate,
                                                 parse_retry,
                                                 parse_shared_prefix,
                                                 plain_launches,
                                                 run_closed_loop,
                                                 run_open_loop,
                                                 shed_accounting)

def _parse_kills(specs, perr, disagg=False):
    """Kill specs as (t, fleet, index) triples. The aggregated grammar is
    ``T:R`` (fleet None); under --disaggregate the index names its fleet:
    ``T:pR`` kills prefill replica R, ``T:dR`` decode replica R."""
    out = []
    for s in specs:
        try:
            t_s, r_s = s.split(":")
            if disagg:
                fleet = r_s[:1]
                if fleet not in ("p", "d") or not r_s[1:]:
                    raise ValueError
                out.append((float(t_s), fleet, int(r_s[1:])))
            else:
                out.append((float(t_s), None, int(r_s)))
        except ValueError:
            if disagg:
                perr(f"--kill under --disaggregate wants T:pR or T:dR "
                     f"(virtual_time:fleet+index), got {s!r}")
            perr(f"--kill wants T:R (virtual_time:fleet_index), got {s!r}")
        if out[-1][0] < 0 or out[-1][2] < 0:
            perr(f"--kill {s!r}: T >= 0 and R >= 0")
    return out


_CORRUPT_TARGETS = ("payload", "sidecar", "prefix", "ship")


def _parse_corrupts(specs, perr, disagg=False):
    """Corrupt specs as (t, fleet, index, target, layer, slot) tuples.
    Grammar ``T:R:TARGET[@L.S]``; under --disaggregate pool targets name
    their fleet like --kill (``T:pR:...`` / ``T:dR:...``) while the
    ``ship`` target keeps ``T:0:ship``."""
    out = []
    for s in specs:
        try:
            t_s, r_s, rest = s.split(":", 2)
            layer = slot = None
            if "@" in rest:
                tgt, at = rest.split("@", 1)
                l_s, p_s = at.split(".")
                layer, slot = int(l_s), int(p_s)
            else:
                tgt = rest
            t = float(t_s)
            if disagg and tgt != "ship":
                fleet = r_s[:1]
                if fleet not in ("p", "d") or not r_s[1:]:
                    raise ValueError
                r = int(r_s[1:])
            else:
                fleet, r = None, int(r_s)
            out.append((t, fleet, r, tgt, layer, slot))
        except ValueError:
            if disagg:
                perr(f"--corrupt under --disaggregate wants "
                     f"T:pR:TARGET[@L.S], T:dR:TARGET[@L.S] or T:0:ship, "
                     f"got {s!r}")
            perr(f"--corrupt wants T:R:TARGET[@LAYER.SLOT] "
                 f"(virtual_time:fleet_index:target), got {s!r}")
        t, fleet, r, tgt, layer, slot = out[-1]
        if tgt not in _CORRUPT_TARGETS:
            perr(f"--corrupt {s!r}: target must be one of "
                 f"{'/'.join(_CORRUPT_TARGETS)}, got {tgt!r}")
        if t < 0 or r < 0:
            perr(f"--corrupt {s!r}: T >= 0 and R >= 0")
        if slot is not None and slot < 1:
            perr(f"--corrupt {s!r}: slot 0 is the scratch page (it holds "
                 f"no request data); slots start at 1")
        if layer is not None and layer < 0:
            perr(f"--corrupt {s!r}: layer must be >= 0")
    return out


def _pick_slot(eng, target):
    """The deterministic fire-time victim: a SETTLED resident page (below
    every active row's write frontier: a flip into the page about to be
    appended to races the next write's re-stamp, which would bless the
    corruption; see integrity.stable_stamped_slots). For ``prefix`` the
    victim is a prefix-indexed page, a shared one (refcount >= 2) when one
    exists. None when nothing is resident yet."""
    if target == "prefix":
        idx = sorted(set(eng.prefix._slots.values()))
        shared = [s for s in idx if eng.allocator.refcount(s) >= 2]
        return (shared or idx or [None])[0]
    hot, cand = set(), []
    for a in eng._active():
        if a.state == "decode":
            p0 = a.decode_pos // eng.page
            for i in range(a.n_pages):
                s = int(eng.table[a.row, i])
                (hot.add(s) if i >= p0 else cand.append(s))
        else:
            fp = a.prefill_done // eng.page
            for i in range(min(a.n_pages, fp)):
                cand.append(int(eng.table[a.row, i]))
            if fp < a.n_pages:
                hot.add(int(eng.table[a.row, fp]))
    picks = sorted(set(cand) - hot - {0})
    if eng.integrity is not None:
        stamped = set(eng.integrity.stamped_slots())
        picks = [s for s in picks if s in stamped]
    return picks[0] if picks else None


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

    def kill_fn(fleet, r):
        def fire(server, clock):
            if fleet == "p":
                rep = server.fail_prefill(r, now=clock)
            elif fleet == "d":
                rep = server.fail_decode(r, now=clock)
            else:
                rep = server.fail(r, now=clock)
            which = {"p": "prefill ", "d": "decode "}.get(fleet, "")
            print(f"servechaos: kill @ {clock:g} -> {which}replica "
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

    for t, fleet, r in kills:
        ev.append((t, kill_fn(fleet, r)))
    for t, r, d in stalls:
        ev.append((t, stall_fn(r, d)))
    ev.sort(key=lambda e: e[0])
    return ev


def _corrupt_events(corrupts, fired):
    """SDC injections as ``(at, fn(server, clock))`` closures. Each fire
    flips ONE real bit (the serve/integrity.py flip helpers) and appends a
    record to ``fired``; a fire that finds no resident victim records
    nothing and warns. Byte 3, bit 6 of the first element lands in the
    float32 exponent (and moves an int8 value by 64): an ESCAPED flip
    visibly changes the argmax stream."""

    def corrupt_fn(spec):
        t, fleet, r, tgt, layer, slot = spec

        def fire(server, clock):
            if tgt == "ship":
                def hook(ship):
                    if server.wire_fault_hook is not hook:
                        return  # one-shot: a later spec re-armed it
                    li = (layer if layer is not None else
                          I.pool_layers(server.prefill.engines[0])[0])
                    rec = I.flip_ship_bit(ship, layer=li, index=3, bit=6)
                    fired.append({"t": clock, "target": tgt,
                                  "rid": ship["rid"], **rec})
                    server.wire_fault_hook = None
                    print(f"servechaos: corrupt @ {clock:g} -> in-flight "
                          f"ship rid {ship['rid']} layer {rec['layer']} "
                          f"(bit {rec['bit']} of byte {rec['byte']})",
                          file=sys.stderr, flush=True)
                server.wire_fault_hook = hook
                return
            if fleet == "p":
                eng = server.prefill.engines[r]
            elif fleet == "d":
                eng = server.decode.engines[r]
            else:
                eng = server.engines[r]
            li = layer if layer is not None else I.pool_layers(eng)[0]
            key = "scale_k" if tgt == "sidecar" else None
            s = slot if slot is not None else _pick_slot(eng, tgt)
            if s is None:
                print(f"servechaos: WARNING corrupt @ {clock:g} "
                      f"({tgt}): no settled resident page to flip yet — "
                      f"injection skipped", file=sys.stderr, flush=True)
                return
            rec = I.flip_pool_bit(eng, li, s, key=key, index=3, bit=6)
            eng.stats["sdc_injected"] += 1
            fired.append({"t": clock, "target": tgt, **rec})
            print(f"servechaos: corrupt @ {clock:g} -> {tgt} layer "
                  f"{rec['layer']} slot {rec['slot']} key {rec['key']} "
                  f"(bit {rec['bit']} of byte {rec['byte']}, refcount "
                  f"{eng.allocator.refcount(s)})",
                  file=sys.stderr, flush=True)
        return fire

    return [(spec[0], corrupt_fn(spec)) for spec in corrupts]


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


def _static_walk_ok(kills, sizes) -> bool:
    """Would this kill schedule survive on fleets that never repair (every
    kill shrinks its fleet for good)? ``sizes`` maps each fleet (None, or
    "p" and "d") to its size. The feasibility check of the
    scripted-recovery baseline under --autoscale."""
    sizes = dict(sizes)
    for _, fleet, r in sorted(kills, key=lambda k: k[0]):
        if sizes[fleet] <= 1 or r >= sizes[fleet]:
            return False
        sizes[fleet] -= 1
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


def _sdc_block(args, corrupts, fired, detect, cfg, server, fin, control,
               streams_diverged, acct):
    """The --corrupt row fields (spread AFTER the engine stats, so the
    tool-counted ``sdc_injected``, which includes wire injections no
    engine sees, wins over the fleet sum). ``sdc_escaped`` comes from
    OBSERVED outcomes, never from injected minus detected: a flip the next
    write overwrote hurt nobody, a flip that reached a stream shows as
    divergence or loss."""
    if not corrupts:
        return {}
    sdc_evs = server.sdc_events
    fin_by = {f["rid"]: f for f in fin}
    # time to detect: each injection paired with the first detection at
    # or after it
    mttds = []
    for f_ev in fired:
        det = [ev["t"] for ev in sdc_evs if ev["t"] >= f_ev["t"]]
        mttds.append(round(min(det) - f_ev["t"], 6) if det else None)
    mttd_ok = [m for m in mttds if m is not None]
    # quarantine recovery: per detection that displaced requests, the time
    # until the LAST displaced request's recovered stream re-emitted its
    # first token (mttr_from_events's definition, on the SDC events)
    mttr_sdc = []
    for ev in sdc_evs:
        disp = ev.get("displaced") or []
        if not disp:
            continue
        recov = [fin_by[rid]["first_token_t"] - ev["t"]
                 for rid in disp if rid in fin_by]
        mttr_sdc.append(round(max(recov), 6) if recov else None)
    mttr_ok = [m for m in mttr_sdc if m is not None]
    return {
        "corrupt": args.corrupt,
        "sdc_detect": detect,
        "scrub": cfg.scrub,
        "corrupts_fired": len(fired),
        "corrupt_events": _round6(fired),
        "sdc_injected": len(fired),
        "sdc_escaped": (None if control is None else
                        streams_diverged + acct["requests_lost"]),
        "sdc_events": _round6(sdc_evs),
        "mttd_sdc": mttds,
        "mttd_sdc_mean": (round(sum(mttd_ok) / len(mttd_ok), 6)
                          if mttd_ok else None),
        "mttr_sdc_s": mttr_sdc,
        "mttr_sdc_s_mean": (round(sum(mttr_ok) / len(mttr_ok), 6)
                            if mttr_ok else None),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", default="transformer_s")
    p.add_argument("-b", "--benchmark", default="synthtext")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--disaggregate", default=None, metavar="P:D",
                   help="chaos on the disaggregated layout "
                        "(serve/handoff.py): a P-replica prefill fleet "
                        "feeding a D-replica decode fleet by KV-page "
                        "shipping. Replaces --replicas; --kill takes T:pR "
                        "/ T:dR to name the fleet (a decode kill routes "
                        "its requests back through the prefill fleet, "
                        "where re-prefill regenerates the pages)")
    p.add_argument("--kill", action="append", default=[], metavar="T:R",
                   help="hard-kill the replica at fleet index R at "
                        "virtual time T (repeatable; pool lost, records "
                        "salvaged, requests failed over). Under "
                        "--disaggregate: T:pR (prefill) / T:dR (decode)")
    p.add_argument("--corrupt", action="append", default=[],
                   metavar="T:R:TARGET[@L.S]",
                   help="flip one bit at virtual time T in replica R's "
                        "data plane (repeatable). TARGET: payload | "
                        "sidecar (int8 scale row, needs --kv-dtype int8) "
                        "| prefix (a prefix-cache page, needs "
                        "--prefix-cache) | ship (an in-flight handoff "
                        "ship, needs --disaggregate and R=0). @L.S pins "
                        "the model layer and pool slot. Arms the checksum "
                        "ledger unless --no-detect")
    p.add_argument("--no-detect", action="store_true",
                   help="run --corrupt WITHOUT the checksum ledger: the "
                        "row reports the escaped divergence instead of "
                        "recovery")
    p.add_argument("--scrub", type=int, default=None, metavar="N",
                   help="scrubber budget in pages a step (needs "
                        "--corrupt; default: the whole pool each step "
                        "when detection is armed)")
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
    return p


def check_args(args: argparse.Namespace, perr) -> None:
    """The reference's argument errors, in its order, reported through
    ``perr`` (the parser's ``error`` from the command line)."""
    disagg = parse_disaggregate(args.disaggregate, perr)
    kills = _parse_kills(args.kill, perr, disagg=bool(disagg))
    stalls = _parse_stalls(args.stall, perr)
    corrupts = _parse_corrupts(args.corrupt, perr, disagg=bool(disagg))
    parse_retry(args.retry, perr)
    autoscale = parse_autoscale(args.autoscale, perr)
    if args.no_detect and not corrupts:
        perr("--no-detect needs --corrupt (there is nothing to not "
             "detect)")
    if args.scrub is not None:
        if args.scrub < 0:
            perr("--scrub must be >= 0 pages/step")
        if not corrupts:
            perr("--scrub needs --corrupt (measure clean scrub "
                 "overhead with servebench --scrub instead)")
        if args.no_detect and args.scrub:
            perr("--scrub needs the checksum ledger; drop --no-detect")
    for t, fleet, r, tgt, layer, slot in corrupts:
        if tgt == "ship":
            if not disagg:
                perr(f"--corrupt {t:g}:{r}:ship: the ship target "
                     f"corrupts an in-flight handoff payload — it "
                     f"needs --disaggregate")
            if r != 0:
                perr(f"--corrupt {t:g}:{r}:ship: the wire has no "
                     f"replica index; use T:0:ship")
        if tgt == "sidecar" and (args.kv_dtype or "float32") != "int8":
            perr(f"--corrupt {t:g}:...:sidecar: the scale sidecar "
                 f"only exists for --kv-dtype int8")
        if tgt == "prefix" and not args.prefix_cache:
            perr(f"--corrupt {t:g}:...:prefix: the prefix target "
                 f"flips a cache-shared page — it needs "
                 f"--prefix-cache")
        if slot is not None and slot >= args.pool_pages:
            perr(f"--corrupt @{layer}.{slot}: slot {slot} out of "
                 f"range for --pool-pages {args.pool_pages} "
                 f"(valid slots: 1..{args.pool_pages - 1})")
    if autoscale:
        if args.scale_window <= 0:
            perr("--scale-window must be > 0 time units")
        if args.scale_cooldown < 0:
            perr("--scale-cooldown must be >= 0 time units")
    if disagg and stalls:
        perr("--stall addresses one aggregated fleet; it does not "
             "compose with --disaggregate")
    if args.deadline_slack is not None and args.deadline_slack <= 0:
        perr("--deadline-slack must be > 0 time units")
    if args.retry and args.deadline_slack is None:
        perr("--retry needs --deadline-slack (nothing else sheds)")
    if args.tier_mix is not None and not 0.0 <= args.tier_mix <= 1.0:
        perr("--tier-mix is a probability in [0, 1]")
    if args.heartbeat < 0:
        perr("--heartbeat must be >= 0 (0 = off)")
    if not disagg and args.replicas < 2 and kills:
        perr("--kill needs --replicas >= 2 (a survivor to fail over to)")
    sizes = _fleet_sizes(args, disagg)
    if not autoscale:
        # every kill shrinks its fleet by one, so walking the kills in
        # time order (stable: equal-time kills fire in spec order) bounds
        # each spec's valid indices exactly
        for t, fleet, r in sorted(kills, key=lambda k: k[0]):
            name = {"p": "prefill ", "d": "decode "}.get(fleet, "")
            if sizes[fleet] <= 1:
                # a decode fleet keeps a survivor too: ships need a live
                # decode replica to bind into
                perr(f"--kill {t:g}:{fleet or ''}{r}: the {name}fleet "
                     f"is already down to its last replica by t={t:g}")
            if r >= sizes[fleet]:
                perr(f"--kill {t:g}:{fleet or ''}{r}: {name}fleet "
                     f"index {r} out of range — at most {sizes[fleet]} "
                     f"replicas remain by t={t:g}")
            sizes[fleet] -= 1
        for t, r, d in stalls:
            # a kill at the same instant fires first (the event sort)
            size_at_t = args.replicas - sum(1 for kt, _, _ in kills
                                            if kt <= t)
            if r >= size_at_t:
                perr(f"--stall {t:g}:{r}:{d}: fleet index {r} out of "
                     f"range — at most {size_at_t} replicas remain by "
                     f"t={t:g} ({args.replicas} replicas, kills before "
                     f"it)")
    else:
        # a repairing controller re-grows the fleet between faults: each
        # spec just has to address the full fleet
        for t, fleet, r in kills:
            if r >= sizes[fleet]:
                name = {"p": "prefill ", "d": "decode "}.get(fleet, "")
                perr(f"--kill {t:g}:{fleet or ''}{r}: {name}fleet "
                     f"index {r} out of range for a {sizes[fleet]}-"
                     f"replica fleet")
        for t, r, d in stalls:
            if r >= args.replicas:
                perr(f"--stall {t:g}:{r}:{d}: fleet index {r} out of "
                     f"range for a {args.replicas}-replica fleet")
    # corrupt specs address the kill-walked fleet: a replica dead by T
    # cannot host a flip (under --autoscale only the full size applies)
    for t, fleet, r, tgt, layer, slot in corrupts:
        if tgt == "ship":
            continue
        full = _fleet_sizes(args, disagg)[fleet]
        dead = (0 if autoscale else
                sum(1 for kt, kf, _ in kills if kf == fleet and kt <= t))
        if r >= full - dead:
            name = {"p": "prefill ", "d": "decode "}.get(fleet, "")
            perr(f"--corrupt {t:g}:{fleet or ''}{r}:{tgt}: "
                 f"{name}fleet index {r} out of range — at most "
                 f"{full - dead} replicas remain by t={t:g}")
    parse_shared_prefix(args.shared_prefix, perr)


def _fleet_sizes(args, disagg):
    """Each fleet's size: ``{None: replicas}``, or under --disaggregate
    ``{"p": P, "d": D}``."""
    return ({"p": disagg[0], "d": disagg[1]} if disagg
            else {None: args.replicas})


def run(args: argparse.Namespace, model: LayerModel,
        device: torch.device, perr=_value_error
        ) -> Tuple[Dict[str, Any], Dict[str, Any], List[ServeRequest]]:
    """Run the control, the scripted baseline (under --autoscale) and the
    chaos run with ``model`` (already on ``device``). Returns the JSON
    row, the servers by name (``control``, ``baseline``, ``chaos``; the
    ones that ran) and the chaos run's requests. ``perr`` reports an
    argument error (the parser's ``error`` from the command line)."""
    check_args(args, perr)
    disagg = parse_disaggregate(args.disaggregate, perr)
    kills = _parse_kills(args.kill, perr, disagg=bool(disagg))
    stalls = _parse_stalls(args.stall, perr)
    corrupts = _parse_corrupts(args.corrupt, perr, disagg=bool(disagg))
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
    # --corrupt arms the checksum ledger unless --no-detect asks for the
    # run without a defence; the scrubber defaults to a whole-pool sweep a
    # step, so a flip on a settled page is caught within one step
    detect = bool(corrupts) and not args.no_detect
    scrub = (0 if not detect else
             (args.scrub if args.scrub is not None else args.pool_pages))
    cfg = ServeConfig(
        max_batch=args.max_batch, pool_pages=args.pool_pages,
        page=args.page, max_len=min(args.max_len, spec.seq_len),
        token_budget=args.token_budget,
        prefill_chunk=(args.page if args.prefill_chunk is None
                       else args.prefill_chunk),
        replicas=1 if disagg else args.replicas, slo_ttft=args.slo_ttft,
        slo_itl=args.slo_itl, heartbeat=args.heartbeat,
        kv_dtype=args.kv_dtype or "float32",
        prefix_cache=args.prefix_cache,
        integrity=detect, scrub=scrub,
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

    def build():
        if disagg:
            return make_disaggregated(model, cfg, device, *disagg)
        return make_server(model, cfg, device)

    def check_layers(srv):
        # an explicit @L pin must name a layer that owns a KV pool:
        # checked on the first server built, before any run
        valid = I.pool_layers(srv.engines[0])
        for t, fleet, r, tgt, layer, slot in corrupts:
            if layer is not None and layer not in valid:
                perr(f"--corrupt @{layer}.{slot}: model layer {layer} "
                     f"owns no KV pool (attention layers: {valid})")

    prov = provenance(device)
    plain0 = plain_launches()
    servers: Dict[str, Any] = {}
    t0 = time.perf_counter()
    # -- control: the same workload, no faults: the stream reference
    control = None
    if not args.no_control:
        control = servers["control"] = build()
        check_layers(control)
        _run(control, workload(), args, retry)
    # -- scripted-recovery baseline (--autoscale only): the same faults
    # with NO controller, so a killed replica stays dead
    scripted_mttrs = None
    if autoscale and kills:
        if _static_walk_ok(kills, _fleet_sizes(args, disagg)):
            baseline = servers["baseline"] = build()
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
    server = servers["chaos"] = build()
    if args.no_control:
        check_layers(server)
    controllers = None
    if autoscale:
        controllers = make_controllers(server, AutoscalePolicy(
            lo=autoscale[0], hi=autoscale[1], window=args.scale_window,
            cooldown_up=args.scale_cooldown,
            cooldown_down=args.scale_cooldown))
    dstats: Dict[str, int] = {}
    corrupts_fired: List[Dict[str, Any]] = []
    reqs = workload()
    duration = _run(server, reqs, args, retry,
                    events=sorted(
                        _fault_events(kills, stalls)
                        + _corrupt_events(corrupts, corrupts_fired),
                        key=lambda e: e[0]),
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
        **({"disaggregate": args.disaggregate,
            "prefill_replicas": disagg[0],
            "decode_replicas": disagg[1]} if disagg else {}),
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
        **_sdc_block(args, corrupts, corrupts_fired, detect, cfg, server,
                     fin, control, streams_diverged, acct),
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
    try:
        rec, _, _ = run(args, model, device, perr=p.error)
    except NotImplementedError as e:  # a model without serving ops
        p.error(str(e))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
