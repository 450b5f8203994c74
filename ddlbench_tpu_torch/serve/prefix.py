"""Cross-request prefix cache: a host-side index over page-aligned prompt
blocks (the PagedAttention copy-on-write lineage of Kwon et al., SOSP'23).

The port's copy of ``ddlbench_tpu/serve/prefix.py`` (pure host code), less
the SDC quarantine's ``drop_slot``.

A newly admitted request CLAIMS the resident, immutable KV pages of its
longest cached prompt prefix: the engine binds those pool slots into the
request's table row (allocator refcounts make the sharing safe) and
chunk-prefills only the uncached tail.

One entry per fully prefilled PAGE of a prompt, keyed by the exact bytes
of the prompt up to and including that page, ``prompt[: (b + 1) *
page].tobytes()``: a key names the block's content and its whole left
context, with no collision risk. ``match`` walks keys block by block and
stops at the first miss, the longest-cached-prefix rule a trie would give.

The index holds its own allocator reference (``incref``) on every page it
caches, so a completed request's prompt pages outlive the request. Under
pool pressure the engine reclaims the cache before it evicts a live
request: ``reclaim`` drops entries newest-registered first, and only pages
whose sole reference is the cache's; pages a live request binds are
skipped. Children (longer prefixes) register after their parents, so
newest-first reclaim never strands an unreachable chain suffix.

Only pages every position of which is prompt content are registered; a
page that will still take decode writes never enters the index, and the
engine copies a bound page into a private slot before its one write into
it (the full-hit path).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ddlbench_tpu_torch.serve.allocator import PageAllocator


def _block_key(prompt: np.ndarray, block: int, page: int) -> bytes:
    """Key of prompt block ``block``: the token bytes of the whole prefix
    through that block."""
    return np.ascontiguousarray(
        prompt[: (block + 1) * page], dtype=np.int32).tobytes()


class PrefixIndex:
    """Host-side prefix index over one engine's shared pool."""

    def __init__(self, allocator: PageAllocator, page: int):
        self.allocator = allocator
        self.page = int(page)
        # block key -> pool slot; insertion order is registration order
        # (children after their parents), all reclaim's newest-first walk
        # needs
        self._slots: Dict[bytes, int] = {}
        self.lookups = 0
        self.hit_blocks = 0
        self.reclaimed = 0
        # optional (name, **args) sink for hit/reclaim instants, wired to
        # the tracer like PageAllocator.on_event
        self.on_event: Optional[Callable[..., None]] = None

    def __len__(self) -> int:
        return len(self._slots)

    def match(self, prompt: np.ndarray) -> List[int]:
        """Pool slots of the longest cached prefix of ``prompt`` (leading
        full pages only), in block order. Empty list = miss."""
        self.lookups += 1
        slots: List[int] = []
        for b in range(len(prompt) // self.page):
            slot = self._slots.get(_block_key(prompt, b, self.page))
            if slot is None:
                break
            slots.append(slot)
        self.hit_blocks += len(slots)
        if slots and self.on_event is not None:
            self.on_event("prefix_hit", blocks=len(slots),
                          tokens=len(slots) * self.page)
        return slots

    def register(self, prompt: np.ndarray, block: int, slot: int) -> bool:
        """Index ``slot`` as holding block ``block`` of ``prompt``; the
        index takes its own reference so the page outlives the request.
        Returns False (and takes nothing) if the key is already cached:
        two requests racing the same prefix keep the first copy."""
        key = _block_key(prompt, block, self.page)
        if key in self._slots:
            return False
        self.allocator.incref(slot)
        self._slots[key] = slot
        return True

    def reclaim(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pool pages by dropping cache entries,
        newest-registered first, skipping entries a live request still
        binds (their pages would not free, and the hit would be lost for
        nothing). Returns how many pages were freed."""
        freed = 0
        for key in list(reversed(self._slots)):
            if freed >= n_pages:
                break
            slot = self._slots[key]
            if self.allocator.refcount(slot) != 1:
                continue  # a live request still holds this page
            del self._slots[key]
            self.allocator.decref(slot)
            self.reclaimed += 1
            freed += 1
        if self.on_event is not None:
            self.on_event("prefix_reclaim", asked=n_pages, freed=freed,
                          entries=len(self._slots))
        return freed

    def drop_slot(self, slot: int) -> int:
        """Purge the entry (at most one: a slot appears in the index at
        most once) mapping to pool ``slot`` and drop the index's
        reference, whatever other holders remain: the SDC quarantine path,
        where the page's CONTENT is bad and must never be hit again.
        Returns how many entries were purged (0 or 1)."""
        dead = [k for k, s in self._slots.items() if s == slot]
        for key in dead:
            del self._slots[key]
            self.allocator.decref(slot)
        if dead and self.on_event is not None:
            self.on_event("prefix_drop", slot=slot, entries=len(self._slots))
        return len(dead)

    def drop_all(self) -> int:
        """Release every entry the cache can release."""
        return self.reclaim(len(self._slots))
