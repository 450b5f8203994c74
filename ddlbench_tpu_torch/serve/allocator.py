"""Refcounted free-list page allocator for the shared serving KV pool.

The port's copy of ``ddlbench_tpu/serve/allocator.py`` (pure host code),
with the refcount calls the prefix cache and speculative rollback use, the
``on_event`` hook request tracing hangs off, and the SDC quarantine the
page-checksum ledger (serve/integrity.py) drives: a quarantined slot never
returns to the free list, and ``on_slot_free`` tells the ledger when a
slot's tenancy ends.

A serving engine cannot give every row a private stripe of the pool: a
request's KV history lives exactly as long as the request, and "pool
exhausted" must mean the card's cache memory is genuinely full. This
allocator is the host-side free list that turns the pool into per-request
page-granular memory: requests allocate pages as their streams grow, free
them all on completion or eviction, and admission backpressure falls out of
``alloc`` returning ``None``.

All decisions are plain Python on the host (the device only ever sees the
resulting page TABLE as an int32 input), so allocation order — and with it
every downstream scheduling decision — is deterministic: slots are handed
out lowest-first and freed slots are reused LIFO, exactly as in the
reference, so both engines schedule the same traffic identically.

Slot 0 is reserved as the SCRATCH page (ops/paged_decode.SCRATCH_SLOT):
inactive rows' table entries point at it so their masked writes land
somewhere harmless. It is never handed out and never counted as capacity.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

# ops/paged_decode.SCRATCH_SLOT, duplicated so this module stays torch-free
SCRATCH_SLOT = 0


class PageAllocator:
    """All-or-nothing page allocation with per-slot refcounts and exact
    occupancy accounting."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"pool needs >= 2 pages (1 scratch + 1 usable), got {n_pages}")
        self.n_pages = int(n_pages)
        # descending so .pop() hands out the lowest slot first; freed slots
        # are appended (LIFO reuse) — both choices only matter for
        # determinism, which they guarantee
        self._free: List[int] = [s for s in range(self.n_pages - 1, 0, -1)]
        self._owned: Dict[int, List[int]] = {}  # rid -> slots, alloc order
        self._ref: Dict[int, int] = {}  # slot -> refcount (live slots only)
        # slots pulled from circulation by SDC quarantine: when the last
        # reference drops they do NOT return to the free list, so a
        # corrupted page is never handed to another request. Quarantined
        # capacity stays counted as in_use: the pool genuinely shrank.
        self._quarantined: set = set()
        self.allocs = 0
        self.frees = 0
        self.peak_in_use = 0
        # optional (name, **args) sink for pool lifecycle instants: the
        # engine wires it to the virtual-time tracer when cfg.trace is on
        self.on_event: Optional[Callable[..., None]] = None
        # optional hook fired with the slot id whenever a slot PHYSICALLY
        # returns to the free list (never for a quarantined retire): the
        # engine wires it to the SDC ledger's drop_slot, so stale checksum
        # expectations die with the tenancy
        self.on_slot_free: Optional[Callable[[int], None]] = None

    @property
    def capacity(self) -> int:
        """Usable pages (the scratch slot is not capacity)."""
        return self.n_pages - 1

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def quarantined(self) -> int:
        """Slots pulled from circulation by SDC quarantine (live references
        may still be draining; the count never shrinks within a run)."""
        return len(self._quarantined)

    @property
    def shared_pages(self) -> int:
        """Slots referenced more than once right now (the prefix index's
        own reference counts, so a cached page one live request binds is
        shared)."""
        return sum(1 for c in self._ref.values() if c >= 2)

    def occupancy(self) -> float:
        return self.in_use / self.capacity

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, ()))

    def refcount(self, slot: int) -> int:
        return self._ref.get(slot, 0)

    def alloc(self, rid: int, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages for request ``rid``; all-or-nothing.

        Returns the slot list (each at refcount 1), or None when the pool
        cannot supply ``n`` pages (admission/step backpressure — nothing
        is allocated).
        """
        if n <= 0:
            raise ValueError(f"alloc n must be positive, got {n}")
        if n > len(self._free):
            return None
        slots = [self._free.pop() for _ in range(n)]
        assert SCRATCH_SLOT not in slots
        self._owned.setdefault(rid, []).extend(slots)
        for s in slots:
            self._ref[s] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        if self.on_event is not None:
            self.on_event("pool_alloc", rid=rid, pages=n,
                          free=len(self._free))
        return slots

    def bind(self, rid: int, slots: List[int]) -> None:
        """Take a reference on already-resident ``slots`` for request
        ``rid`` (the prefix-cache hit path). Binding a dead slot is a
        bookkeeping bug and raises."""
        for s in slots:
            if self._ref.get(s, 0) < 1:
                raise ValueError(f"bind of dead slot {s} for request {rid}")
        self._owned.setdefault(rid, []).extend(slots)
        for s in slots:
            self._ref[s] += 1

    def incref(self, slot: int) -> None:
        """Extra reference on a live slot (the prefix index pinning a page
        it caches; request-side references go through ``bind``)."""
        if self._ref.get(slot, 0) < 1:
            raise ValueError(f"incref of dead slot {slot}")
        self._ref[slot] += 1

    def holders(self, slot: int) -> List[int]:
        """Request ids currently holding a reference on ``slot``, in rid
        order: the quarantine walk of a corrupted SHARED page (every holder
        read poisoned bytes and must take the recompute path)."""
        return sorted(r for r, slots in self._owned.items() if slot in slots)

    def quarantine(self, slot: int) -> None:
        """Pull ``slot`` out of circulation (SDC detection): if it is on
        the free list it leaves at once; if references are still live it
        leaves when the last one drops (see ``decref``). Either way it is
        never allocated again this run. Idempotent; the scratch slot
        cannot be quarantined (it holds no real data)."""
        if slot == SCRATCH_SLOT:
            raise ValueError("cannot quarantine the scratch slot")
        if slot in self._quarantined:
            return
        self._quarantined.add(slot)
        if slot in self._free:
            self._free.remove(slot)
        if self.on_event is not None:
            self.on_event("pool_quarantine", slot=slot,
                          free=len(self._free))

    def decref(self, slot: int) -> bool:
        """Drop one reference; returns True when the slot actually
        returned to the free list (last reference dropped). A quarantined
        slot never returns: its last decref retires it for good (counted as
        freed: the holder genuinely let go). Dropping a reference a holder
        does not have is a double-free and raises."""
        c = self._ref.get(slot, 0)
        if c < 1:
            raise ValueError(f"double free: slot {slot} has no references")
        if c == 1:
            del self._ref[slot]
            self.frees += 1
            if slot not in self._quarantined:
                self._free.append(slot)
                if self.on_slot_free is not None:
                    self.on_slot_free(slot)
            return True
        self._ref[slot] = c - 1
        return False

    def release(self, rid: int, slots: List[int]) -> int:
        """Drop ``rid``'s reference on a SUBSET of its pages (the
        speculative rollback: pages allocated ahead for rejected drafts go
        back without retiring the request). Releasing a slot the request
        does not hold is a double-free and raises. A fully released rid
        keeps its empty ownership entry, so its eventual
        ``free_request`` is not a double-free. Returns how many pages
        physically freed."""
        owned = self._owned.get(rid)
        freed = 0
        for s in slots:
            if owned is None or s not in owned:
                raise ValueError(
                    f"double free: request {rid} does not hold slot {s}")
            owned.remove(s)
            freed += self.decref(s)
        if slots and self.on_event is not None:
            self.on_event("pool_rollback", rid=rid, held=len(slots),
                          freed=freed, free=len(self._free))
        return freed

    def free_request(self, rid: int) -> int:
        """Drop ``rid``'s reference on every page it holds (completion or
        eviction). Returns how many pages physically returned to the free
        list; shared pages survive until their last holder lets go.

        Freeing a request that owns nothing is a double-free — the engine
        frees exactly once per retirement — and raises.
        """
        slots = self._owned.pop(rid, None)
        if slots is None:
            raise ValueError(f"double free: request {rid} owns no pages")
        freed = sum(1 for s in slots if self.decref(s))
        if self.on_event is not None:
            self.on_event("pool_release", rid=rid, held=len(slots),
                          freed=freed, free=len(self._free))
        return freed
