"""Silent-data-corruption defence for the serving data plane: a host-side
per-page checksum ledger over the shared KV pool.

The port's copy of ``ddlbench_tpu/serve/integrity.py``. A flipped bit in a
pool page, a scale sidecar or an in-flight handoff ship is invisible to
every other guard: the device attends over the poisoned bytes and the
stream diverges silently, prefix-cache full hits included. The ledger
detects the flip at a trust boundary, quarantines the page and recovers
the requests through the eviction-recompute path that already exists.

The ledger
----------
One checksum word per (layer, slot), chained over the slot's rows of every
per-slot pool tensor in sorted key order (``pool_checksum_keys`` in
ops/paged_decode.py: payload ``pool_k``/``pool_v`` plus the int8
``scale_k``/``scale_v`` sidecars; the layer's ``kv_seed`` and rounding
table stay out). Entries carry a WRITE GENERATION, so a re-stamp after a
legitimate overwrite is told apart from a stale expectation; ``verify``
compares against the latest generation only.

The word is crc32c when the ``crc32c`` wheel imports and ``zlib.crc32``
otherwise, the reference's rule. The bytes are the rows' host bytes: a
bfloat16 row is read through an int16 view (numpy has no bfloat16), which
holds the same bytes the reference's ``ml_dtypes`` array does, so both
compute the same word for the same bits.

Trust boundaries (serve/engine.py and serve/handoff.py make the calls):

* pool writes (decode, prefill chunk, verify span, copy-on-write) STAMP
  the written slots;
* ``export_request`` verifies the fetched pages against the ledger and
  attaches per-(layer, page) words to the ship; ``import_request``
  verifies the ship before any pool write and stamps the destination
  slots from the ship's words (all or nothing: a corrupt ship writes
  nothing and rides the parked-ship retry);
* prefix-hit binds (full and partial) verify the hit slots first;
* a budgeted scrubber (``cfg.scrub`` pages a step) walks the stamped
  slots round-robin, catching latent corruption on cold pages.

Detection -> quarantine -> recovery: the allocator retires the slot, the
prefix index drops its entry, and every request that holds the slot takes
the eviction-recompute path. Re-prefill regenerates the pages byte for
byte (int8 rounding is keyed by position) and a recovered request's whole
stream regenerates, so any detection before completion leaves the final
streams bitwise those of an unfaulted run.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ddlbench_tpu_torch.ops.paged_decode import (pool_checksum_keys,
                                                 slot_axis, slot_index)

try:  # hardware crc32c when the wheel is present; stdlib crc32 otherwise
    from crc32c import crc32c as _crc32c  # type: ignore
except ImportError:  # pragma: no cover - neither image ships crc32c
    _crc32c = None

# one checksum word per (layer, page) on the handoff wire
CHECKSUM_BYTES = 4


def host_rows(t: torch.Tensor) -> np.ndarray:
    """A pool tensor's bytes as a host numpy array, copied synchronously
    (so the bytes are those of every write already queued on the stream).
    bfloat16 goes through an int16 view: the same bytes, a dtype numpy
    has."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def checksum(data: bytes, crc: int = 0) -> int:
    """4-byte checksum of ``data`` chained onto ``crc`` (crc32c if
    available, zlib.crc32 otherwise), masked to an unsigned word."""
    if _crc32c is not None:
        return _crc32c(data, crc) & 0xFFFFFFFF
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def page_checksum(rows: Dict[str, np.ndarray]) -> int:
    """CRC of one pool slot's fetched rows, chained over sorted key order
    so payload and sidecar corruption both show in the one word."""
    crc = 0
    for key in sorted(rows):
        crc = checksum(np.ascontiguousarray(rows[key]).tobytes(), crc)
    return crc


def ship_checksums(pages: List[Optional[Dict[str, np.ndarray]]]
                   ) -> List[Optional[List[int]]]:
    """Per-(layer, page) checksums of a handoff ship's fetched rows: the
    words a local per-slot fetch would ledger, so an import can stamp its
    destination slots straight from the ship. A tensor-parallel engine's
    rows are [tp, pages, ...]: a page's word covers every shard's
    slice."""
    out: List[Optional[List[int]]] = []
    for per_layer in pages:
        if per_layer is None:  # layers with no pool ship nothing
            out.append(None)
            continue
        k0 = sorted(per_layer)[0]
        n = per_layer[k0].shape[slot_axis(k0, per_layer[k0])]
        out.append([page_checksum({k: v[slot_index(k, v, p)]
                                   for k, v in per_layer.items()})
                    for p in range(n)])
    return out


class PageLedger:
    """Host-side (layer, slot) -> (write generation, crc) ledger."""

    def __init__(self) -> None:
        self._crc: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.stamps = 0
        self.verifies = 0
        self.mismatches = 0

    def __len__(self) -> int:
        return len(self._crc)

    def stamp(self, layer: int, slot: int, crc: int) -> int:
        """Record ``crc`` as the latest contents of (layer, slot); bumps
        the write generation. Returns the new generation."""
        gen = self._crc.get((layer, slot), (0, 0))[0] + 1
        self._crc[(layer, slot)] = (gen, crc)
        self.stamps += 1
        return gen

    def expected(self, layer: int, slot: int) -> Optional[int]:
        ent = self._crc.get((layer, slot))
        return None if ent is None else ent[1]

    def generation(self, layer: int, slot: int) -> int:
        return self._crc.get((layer, slot), (0, 0))[0]

    def verify(self, layer: int, slot: int, crc: int) -> Optional[bool]:
        """Compare ``crc`` against the latest stamp. True = intact, False =
        MISMATCH (counted), None = never stamped (unwritten and partial
        pages carry no expectation)."""
        exp = self.expected(layer, slot)
        if exp is None:
            return None
        self.verifies += 1
        if crc != exp:
            self.mismatches += 1
            return False
        return True

    def drop_slot(self, slot: int) -> int:
        """Forget every layer's entry for ``slot`` (it returned to the free
        list or was quarantined; its next tenant re-stamps). Returns how
        many entries dropped."""
        dead = [k for k in self._crc if k[1] == slot]
        for k in dead:
            del self._crc[k]
        return len(dead)

    def stamped_slots(self) -> List[int]:
        """Distinct slots with at least one stamped layer, sorted: the
        scrubber's deterministic round-robin domain."""
        return sorted({s for (_, s) in self._crc})


# ---------------------------------------------------------------------------
# Fault injection (tools/servechaos.py and the tests). The flip is real: the
# device tensor (or the in-flight host ship) holds different bytes
# afterwards, and only checksum verification can tell.


def pool_layers(engine) -> List[int]:
    """Model-layer indices that own a KV pool (attention layers): the
    valid ``layer`` domain of ``flip_pool_bit`` and of servechaos's
    ``--corrupt`` @L suffix."""
    return [li for li, pool in enumerate(engine.pools) if pool is not None]


def stable_stamped_slots(engine) -> List[int]:
    """Stamped slots that are NOT any active row's write frontier, sorted:
    the deterministic injection domain of the chaos tooling.

    A flip into the page a row is about to append to races the next
    write's re-stamp, which checksums the whole page, corrupted residue
    included, and blesses the corruption: the honest time-of-check window
    of any write-boundary ledger. Targeting settled pages makes an
    injection experiment measure DETECTION, not the race."""
    if engine.integrity is None:
        return []
    hot = set()
    for a in engine._active():
        if a.state == "decode":
            p0 = a.decode_pos // engine.page
            pages = range(p0, min(a.n_pages, p0 + 2))
        else:  # prefill frontier page (partially written, not yet stamped)
            pages = range(a.prefill_done // engine.page,
                          min(a.n_pages, a.prefill_done // engine.page + 1))
        for idx in pages:
            hot.add(int(engine.table[a.row, idx]))
    return [s for s in engine.integrity.stamped_slots() if s not in hot]


@torch.no_grad()
def flip_pool_bit(engine, layer: int, slot: int,
                  key: Optional[str] = None, index: int = 0,
                  bit: int = 0) -> Dict[str, int]:
    """Flip ONE bit of pool tensor ``key`` inside ``slot``'s rows of layer
    ``layer``, in place on the device: a uint8 view of the slot's
    contiguous rows has one byte xor-ed (at tp > 1 the byte counts over
    the shards' rows in shard order, as the reference's [tp, ...] fetch
    lays them out). ``key`` None picks the first checksum-domain key
    (payload); pass ``"scale_k"`` to corrupt the int8 sidecar. Returns a
    record of what flipped."""
    pool = engine.pools[layer]
    if pool is None:
        raise ValueError(
            f"layer {layer} owns no KV pool (valid: {pool_layers(engine)})")
    if key is None:
        key = pool_checksum_keys(pool)[0]
    shards = ([pool[key]] if slot_axis(key, pool[key]) == 0
              else list(pool[key]))
    flats = [t[slot].view(torch.uint8).reshape(-1) for t in shards]
    per = flats[0].numel()
    byte = int(index) % (per * len(flats))
    flats[byte // per][byte % per:byte % per + 1].bitwise_xor_(1 << (bit % 8))
    return {"layer": int(layer), "slot": int(slot), "key": key,
            "byte": byte, "bit": bit % 8}


def flip_ship_bit(ship: dict, layer: int = 0, key: Optional[str] = None,
                  index: int = 0, bit: int = 0) -> Dict[str, int]:
    """Flip one bit of an in-flight handoff ship's page rows (host numpy:
    the wire-transit fault model). The original byte is stashed in
    ``ship["_wire_fault"]`` so the handoff retry can model retransmission
    from the exporter's intact source buffer."""
    pages = ship["pages"][layer]
    if key is None:
        key = sorted(pages)[0]
    arr = np.array(pages[key], copy=True)
    flat = arr.reshape(-1).view(np.uint8)
    byte = int(index) % flat.size
    orig = int(flat[byte])
    flat[byte] = orig ^ (1 << (bit % 8))
    pages[key] = arr
    ship["_wire_fault"] = {"layer": int(layer), "key": key, "byte": byte,
                           "orig": orig}
    return {"layer": int(layer), "key": key, "byte": byte, "bit": bit % 8}


def repair_ship(ship: dict) -> bool:
    """Undo a stashed wire fault: the model of the exporter retransmitting
    from its intact host buffer after the importer rejected the corrupt
    ship. Returns True if a fault was repaired."""
    fault = ship.pop("_wire_fault", None)
    if fault is None:
        return False
    arr = np.array(ship["pages"][fault["layer"]][fault["key"]], copy=True)
    arr.reshape(-1).view(np.uint8)[fault["byte"]] = fault["orig"]
    ship["pages"][fault["layer"]][fault["key"]] = arr
    return True
