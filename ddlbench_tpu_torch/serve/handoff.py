"""Disaggregated serving: a prefill fleet feeding a decode fleet by KV-page
shipping (the port of ``ddlbench_tpu/serve/handoff.py``).

Prefill and decode have opposite hardware appetites: prefill is one
compute-bound pass over the whole prompt, decode hundreds of memory-bound
one-token passes. The disaggregated layout gives each phase a fleet of its
own and moves a request ONCE, at the phase boundary:

    prefill fleet                          decode fleet
    admit -> chunk-prefill -> first token
            export_request(rid)  ----->  import_request(ship)
            (pages + scale sidecars       (bind into its own allocator,
             device -> host, refs freed)   resume mid-stream in decode)

The transfer primitive is the page pool itself: a request's KV state is its
table row's page slots, so export is a device-to-host gather of those pool
rows (payload and int8 scale sidecars) and import an allocator grant plus a
verbatim scatter on the receiving engine. The ship is host bytes, the trust
boundary the SDC ledger (serve/integrity.py) checks: its words are over the
host bytes, and the wire fault hook corrupts them. An int8 pool ships
exactly a quarter of the float32 payload bytes; the float32 scale sidecar
(8 B a position a layer) is counted apart.

On one card both fleets share the one model object (its weights live there
once) and the kernels; each replica of either fleet has its own KV pool, as
in :func:`~ddlbench_tpu_torch.serve.engine.make_server`. The reference's
split of the fleets over devices [0, P) and [P, P + D) has no counterpart.

Determinism: token streams are pure functions of (weights, prompt, rid,
token index), and int8 page bytes of (values, layer seed, k/v tag, stream
position). So the disaggregated server's streams equal the aggregated
fleet's, a prefill-replica kill mid-handoff loses nothing (displaced
requests re-prefill on the survivors, regenerating the same pages), and a
decode-replica kill routes its requests back through the PREFILL fleet's
dispatcher (the pages died with the replica), where re-prefill regenerates
the same bytes before they ship again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.serve.engine import (ReplicatedServer, ServeEngine,
                                             StepReport, fleet_stats,
                                             make_server)
from ddlbench_tpu_torch.serve.integrity import (CHECKSUM_BYTES, repair_ship,
                                                ship_checksums)
from ddlbench_tpu_torch.serve.workload import ServeRequest

PAYLOAD_KEYS = ("pool_k", "pool_v")
SIDECAR_KEYS = ("scale_k", "scale_v")


def ship_payload_bytes(ship: Dict[str, Any]) -> int:
    """K/V payload bytes in one ship: for an int8 pool exactly a quarter
    of the float32 pool's bytes for the same pages."""
    return sum(rows[k].nbytes for rows in ship["pages"]
               if rows is not None for k in PAYLOAD_KEYS)


def ship_sidecar_bytes(ship: Dict[str, Any]) -> int:
    """float32 scale-sidecar bytes in one ship (0 for unquantised
    pools)."""
    return sum(rows[k].nbytes for rows in ship["pages"]
               if rows is not None for k in SIDECAR_KEYS if k in rows)


def ship_checksum_bytes(ship: Dict[str, Any]) -> int:
    """Integrity-word bytes riding the wire with one ship: CHECKSUM_BYTES
    per attached (layer, page) word (0 when the exporter runs without
    integrity)."""
    return CHECKSUM_BYTES * sum(
        sum(1 for w in per_layer if w is not None)
        for per_layer in ship.get("checksums") or [] if per_layer is not None)


def export_request(engine: ServeEngine, rid: int) -> Optional[Dict[str, Any]]:
    """Pop ``rid`` off ``engine`` (ServeEngine.extract_request) and stamp
    the ship with its wire-byte accounting. Returns None when the export's
    verify caught a corrupt page: the request was quarantine-evicted onto
    the engine's local recompute path and nothing ships."""
    ship = engine.extract_request(rid)
    if ship is None:
        return None
    ship["payload_bytes"] = ship_payload_bytes(ship)
    ship["sidecar_bytes"] = ship_sidecar_bytes(ship)
    ship["checksum_bytes"] = ship_checksum_bytes(ship)
    return ship


class DisaggregatedServer:
    """A prefill ReplicatedServer feeding a decode ReplicatedServer.

    Driver-compatible with ReplicatedServer (submit/has_work/step and the
    record and event surfaces servebench and servechaos read), so the
    drivers run both layouts unchanged. Traffic enters the PREFILL fleet;
    after every global step, each prefill engine's decode-state requests
    (their prefill just finished; the first token rode the last chunk) are
    exported and imported least-loaded into the decode fleet. A ship that
    finds no decode capacity parks on the host and retries every step.
    """

    def __init__(self, prefill: ReplicatedServer,
                 decode: ReplicatedServer):
        self.prefill = prefill
        self.decode = decode
        self._pending: List[Dict[str, Any]] = []  # ships parked on the host
        self.shipped: Dict[str, int] = {
            "shipped_requests": 0, "shipped_pages": 0,
            "shipped_payload_bytes": 0, "shipped_sidecar_bytes": 0,
            "shipped_checksum_bytes": 0}
        # wire-transit SDC: ships whose host bytes failed their words at
        # the pre-import check (counted once here, not once per decode
        # engine tried), and how many retransmission repaired
        self.wire_sdc: Dict[str, int] = {
            "sdc_wire_detected": 0, "sdc_wire_repaired": 0}
        self.wire_events: List[Dict[str, Any]] = []
        # optional fault hook fired on every pending ship between export
        # and import: the one window that models wire-transit corruption.
        # servechaos --corrupt ...:ship arms it one-shot
        self.wire_fault_hook: Optional[Any] = None

    # -- the ReplicatedServer-compatible driver surface ---------------------

    def submit(self, req: ServeRequest,
               now: Optional[float] = None) -> bool:
        return self.prefill.submit(req, now=now)

    def has_work(self) -> bool:
        return (bool(self._pending) or self.prefill.has_work()
                or self.decode.has_work())

    def step(self, now: float = 0.0) -> StepReport:
        rep = StepReport()
        if self.prefill.has_work():
            rep.merge(self.prefill.step(now))
        if self.decode.has_work():
            rep.merge(self.decode.step(now))
        if rep.cost == 0 and self.has_work():
            rep.cost = 1  # parked ships alone still burn a time unit
        self._ship(now + rep.cost)
        return rep

    def _ship(self, now: float) -> None:
        """The handoff tick: export every prefill-side request whose
        prefill completed this step, then bind the pending ships into the
        decode fleet in (load, index) order, all or nothing per ship,
        parking what finds no room. It runs at the step's END, so a
        request always takes its first decode pass on the decode fleet."""
        for eng in self.prefill.engines:
            ready = sorted((a for a in eng._active()
                            if a.state == "decode"),
                           key=lambda a: a.admit_seq)
            for a in ready:
                ship = export_request(eng, a.req.rid)
                if ship is None:
                    # the export's verify caught corruption: the request
                    # re-ships after its local recompute
                    continue
                self.shipped["shipped_requests"] += 1
                self.shipped["shipped_pages"] += ship["n_pages"]
                self.shipped["shipped_payload_bytes"] += \
                    ship["payload_bytes"]
                self.shipped["shipped_sidecar_bytes"] += \
                    ship["sidecar_bytes"]
                self.shipped["shipped_checksum_bytes"] += \
                    ship["checksum_bytes"]
                self._pending.append(ship)
        for ship in self._pending:
            if self.wire_fault_hook is None:
                break  # one-shot hooks disarm themselves mid-iteration
            self.wire_fault_hook(ship)
        parked = []
        for ship in self._pending:
            verdict = self._wire_corrupt(ship, now)
            if verdict == "park":
                parked.append(ship)  # repaired; retransmission costs a step
                continue
            if verdict == "drop":
                continue  # unrepairable: re-routed through prefill
            order = sorted(enumerate(self.decode.engines),
                           key=lambda ie: (ie[1].load(), ie[0]))
            if not any(e.import_request(ship, now) for _, e in order):
                parked.append(ship)
        self._pending = parked

    def _wire_corrupt(self, ship: Dict[str, Any],
                      now: float) -> Optional[str]:
        """Pre-import wire check: re-checksum a pending ship's host bytes
        against the exporter's words. On a mismatch, count the detection
        ONCE and repair from the stashed original byte (the exporter
        retransmitting from its intact buffer), parking the ship one step
        ("park"). If nothing intact remains to retransmit, drop the ship
        and re-route the request through the PREFILL dispatcher, the
        decode-kill recovery path ("drop"). Ships without words (integrity
        off) pass untouched (None)."""
        want = ship.get("checksums")
        if want is None:
            return None
        calc = ship_checksums(ship["pages"])
        for li, per_layer in enumerate(want):
            if per_layer is None:
                continue
            for p, w in enumerate(per_layer):
                if w is not None and w != calc[li][p]:
                    self.wire_sdc["sdc_wire_detected"] += 1
                    repaired = repair_ship(ship)
                    if repaired:
                        self.wire_sdc["sdc_wire_repaired"] += 1
                    else:
                        self.prefill._dispatch(ship["req"], now)
                    self.wire_events.append({
                        "t": now, "slot": -1, "where": "wire",
                        "rid": ship["rid"], "layer": li, "page": p,
                        "repaired": repaired, "displaced": []})
                    return "park" if repaired else "drop"
        return None

    # -- chaos: per-fleet hard kills -----------------------------------------

    def fail_prefill(self, index: int, now: float = 0.0) -> Dict[str, Any]:
        """Kill the prefill replica at fleet index ``index``: its
        displaced requests (mid-prefill or queued; a ship already exported
        is on the host and unaffected) resubmit onto the surviving prefill
        replicas and re-prefill from scratch."""
        ev = self.prefill.fail(index, now)
        ev["fleet"] = "prefill"
        return ev

    def fail_decode(self, index: int, now: float = 0.0) -> Dict[str, Any]:
        """Kill the decode replica at fleet index ``index``: its imported
        pages die with it, so the displaced requests route back through
        the PREFILL fleet's dispatcher, where re-prefill regenerates the
        same bytes and the handoff ships them again."""
        ev = self.decode.fail(index, now, dispatch=self.prefill._dispatch)
        ev["fleet"] = "decode"
        return ev

    # -- autoscale (serve/autoscaler.py attaches one controller per fleet) ---

    def controllers(self, policy, start: float = 0.0):
        """Per-fleet autoscale controllers: prefill and decode scale
        INDEPENDENTLY, each fleet with a FleetController reading its own
        signals, clamped to the same [lo, hi] band. (A decode-side kill
        repairs on the decode fleet even though its displaced requests
        re-enter through the prefill dispatcher: the dead capacity was
        decode capacity.)"""
        from ddlbench_tpu_torch.serve.autoscaler import FleetController

        return [FleetController(self.prefill, policy, name="prefill",
                                start=start),
                FleetController(self.decode, policy, name="decode",
                                start=start)]

    # -- record and event surfaces (servebench and servechaos read them) -----

    @property
    def engines(self) -> List[ServeEngine]:
        return self.prefill.engines + self.decode.engines

    @property
    def retired(self) -> List[ServeEngine]:
        return self.prefill.retired + self.decode.retired

    @property
    def finished(self) -> List[Dict[str, Any]]:
        return self.prefill.finished + self.decode.finished

    @property
    def timed_out(self) -> List[Dict[str, Any]]:
        return self.prefill.timed_out + self.decode.timed_out

    @property
    def shed_records(self) -> List[Dict[str, Any]]:
        return self.prefill.shed_records + self.decode.shed_records

    @property
    def fail_events(self) -> List[Dict[str, Any]]:
        return self.prefill.fail_events + self.decode.fail_events

    @property
    def stall_events(self) -> List[Dict[str, Any]]:
        return self.prefill.stall_events + self.decode.stall_events

    @property
    def heartbeat_events(self) -> List[Dict[str, Any]]:
        return self.prefill.heartbeat_events + self.decode.heartbeat_events

    @property
    def resize_events(self) -> List[Dict[str, Any]]:
        return self.prefill.resize_events + self.decode.resize_events

    @property
    def sdc_events(self) -> List[Dict[str, Any]]:
        """Pool detections from both fleets plus the wire-transit
        detections of the pre-import check, time-ordered."""
        return sorted(self.prefill.sdc_events + self.decode.sdc_events
                      + self.wire_events, key=lambda ev: ev["t"])

    def snapshot(self) -> Dict[str, Any]:
        return {"prefill": self.prefill.snapshot(),
                "decode": self.decode.snapshot(),
                "pending_ships": len(self._pending), **self.shipped}

    def stats_summary(self) -> Dict[str, float]:
        s = fleet_stats(self.prefill.engines + self.decode.engines,
                        self.prefill.retired + self.decode.retired)
        s.update(self.shipped)
        s.update(self.wire_sdc)
        return s


def make_disaggregated(model: LayerModel, cfg: ServeConfig,
                       device: torch.device, prefill_replicas: int,
                       decode_replicas: int) -> DisaggregatedServer:
    """A P:D disaggregated server over one model (already on ``device``)
    and one config. Both fleets run the same model passes (disaggregation
    is a scheduling split, not a program split) on the one device and
    share the one copy of the weights; each replica has its own pool."""
    if prefill_replicas < 1 or decode_replicas < 1:
        raise ValueError(
            f"disaggregation needs >= 1 replica per fleet, got "
            f"{prefill_replicas}:{decode_replicas}")
    pre = make_server(model, cfg.replace(replicas=prefill_replicas), device)
    dec = make_server(model, cfg.replace(replicas=decode_replicas), device)
    return DisaggregatedServer(pre, dec)
