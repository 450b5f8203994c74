"""Continuous-batching serving engine over the paged KV pool (PyTorch port).

The port of ``ddlbench_tpu/serve/engine.py`` for one replica, tp = 1,
greedy decoding: float32, bfloat16 and int8 pools, the continuous policy
and the static baseline, the cross-request prefix cache and self-drafting
speculative verify. The scheduler is the reference's, line for line, so
both engines make the same decisions on the same traffic and — with the
same weights — emit the same token streams.

Structure (host schedules, device computes):

* The host owns the admission queue, the per-request bookkeeping, ONE page
  table ``[max_batch, npg_max] int32`` shared by every layer, and the
  free-list :class:`~ddlbench_tpu_torch.serve.allocator.PageAllocator`
  over the shared K/V pool (slot 0 scratch). The device only ever sees the
  table as an int32 input.
* Two model programs cover all traffic: a ``[max_batch, 1]`` decode step at
  per-row positions (inactive rows are masked by routing their table row to
  the scratch slot) and a ``[1, prefill_chunk]`` page-aligned prefill
  chunk. Each walks only ``npl`` live pages; PyTorch runs them eagerly, and
  the pools are updated in place (the reference donates them to jit).
* Int8 pools (``cfg.kv_dtype``) quantise at the page write with the
  reference's counter-based stochastic rounding: each layer's pool carries
  ``kv_seed`` = the layer's index in ``model.layers`` (the embedding is 0)
  and a table of its rounding uniforms for every position a write can
  name, computed once here (ops/paged_decode.kv_u_table).
* Prefix caching (``cfg.prefix_cache``; serve/prefix.py): fully prefilled
  prompt pages are registered as their chunk completes, and an admission
  BINDS the resident pages of its longest cached prefix and prefills only
  the tail. A full page-aligned hit skips prefill: the last cached page is
  copied into a private slot (ops/paged_decode.serve_page_copy; shared
  pages are immutable) and the request enters decode directly.
* Speculative verify (``cfg.speculative = ngram:N:K``): a host-side n-gram
  drafter proposes up to K tokens per decode row, and ONE [max_batch, K+1]
  verify pass scores them; the longest draft prefix matching greedy argmax
  is accepted, and pages past the accepted frontier roll back.
* Eviction closes the loop on pool exhaustion: when a growing request needs
  a page and the free list is empty, the engine first reclaims prefix-cache
  pages no live request holds, then evicts the NEWEST-admitted request (its
  references dropped, the request re-queued at the front for recomputation,
  which greedy decoding regenerates identically).
* ``policy="static"`` is the A/B baseline: admission only when every row is
  free, with full worst-case page reservation, draining the batch before
  the next fill.

Virtual time: one unit = one model pass (a decode step over max_batch rows
or one prefill chunk; a verify pass costs one unit, like the decode step it
replaces). All latency/goodput metrics are in these units — deterministic,
and framework-independent. The engine also keeps the host wall-clock
seconds of its decode, verify and prefill passes (``wall``), each ending in
the device-to-host copy of the emitted tokens, so on a card they are
device-synchronised step times.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.models.layers import LayerModel, ServeLayer
from ddlbench_tpu_torch.ops.paged_decode import (kv_u_table,
                                                 pool_page_bytes,
                                                 pool_quantized,
                                                 serve_page_copy)
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.draft import NgramDrafter
from ddlbench_tpu_torch.serve.prefix import PrefixIndex
from ddlbench_tpu_torch.serve.workload import ServeRequest

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


@dataclasses.dataclass
class _Active:
    """Host-side bookkeeping for one in-flight request on one engine row."""

    req: ServeRequest
    row: int
    admit_seq: int  # admission order; eviction victims are newest-first
    state: str = "prefill"  # "prefill" -> "decode"
    prefill_done: int = 0  # prompt positions already processed
    n_pages: int = 0  # table[row, :n_pages] hold this request's slots
    # prompt blocks already in the prefix index (bound blocks at admission,
    # then private blocks registered as their prefill completes)
    registered_blocks: int = 0
    pending_tok: int = -1  # next decode input token (= last emitted)
    first_token_t: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def decode_pos(self) -> int:
        """Stream position of the pending decode input token."""
        return self.req.prompt_len + len(self.out) - 1


@dataclasses.dataclass
class StepReport:
    """What one engine step did (host-observable; drives the load gen)."""

    cost: int = 0  # virtual time units = model passes this step
    prefill_calls: int = 0
    decode_rows: int = 0
    admitted: int = 0
    evicted: int = 0
    backpressure: int = 0
    completed: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """One serving replica: scheduler + allocator + the model passes.

    ``model`` must already live on ``device``; the pools are built there.
    """

    def __init__(self, model: LayerModel, cfg: ServeConfig,
                 device: torch.device):
        cfg.validate()
        if cfg.max_len > model.in_shape[0]:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's stream length "
                f"{model.in_shape[0]}")
        self.model = model
        self.cfg = cfg
        self.device = device
        self.page = cfg.page
        self.npg_max = cfg.npg_max()
        dtype = _KV_DTYPES[cfg.kv_dtype]
        # self-drafting speculative decoding (cfg.speculative: ngram:N:K)
        self._spec = cfg.spec_params()
        self._drafter = NgramDrafter(*self._spec) if self._spec else None
        # every stream position a pool write can name: prefill chunks pad
        # past max_len by up to one chunk, verify spans by up to K + 1
        width = max(cfg.resolved_prefill_chunk(),
                    self._spec[1] + 1 if self._spec else 1)
        self.n_write_pos = self.npg_max * self.page + width
        # one pool per serving layer that keeps K/V (None elsewhere)
        self.pools: List[Optional[dict]] = []
        self.bytes_per_page = 0  # K/V payload bytes per slot, summed
        for li, layer in enumerate(model.layers):
            pool = (layer.pool_init(cfg.pool_pages, cfg.page, dtype, device)
                    if isinstance(layer, ServeLayer) else None)
            if pool is not None:
                if pool_quantized(pool):
                    # the layer's counter seed for the write-boundary
                    # rounding — its index in model.layers, as in the
                    # reference — and the uniforms of every position
                    _, _, H, dh = pool["pool_k"].shape
                    pool["kv_seed"] = li
                    pool["kv_u"] = kv_u_table(li, self.n_write_pos, H, dh,
                                              device)
                self.bytes_per_page += pool_page_bytes(pool)
            self.pools.append(pool)
        # trailing pointwise layers (the LM head) run on the ONE chunk
        # position whose next token the scheduler wants — applying them to
        # all C positions would spend C head matmuls per chunk for 1 (or,
        # on non-last chunks, 0) useful rows
        self._n_body = len(model.layers)
        while self._n_body and not isinstance(
                model.layers[self._n_body - 1], ServeLayer):
            self._n_body -= 1
        self.table = np.zeros((cfg.max_batch, self.npg_max), np.int32)
        self.allocator = PageAllocator(cfg.pool_pages)
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(self.allocator, self.page)
            if cfg.prefix_cache else None)
        self.queue: deque = deque()
        self.rows: List[Optional[_Active]] = [None] * cfg.max_batch
        self.finished: List[Dict[str, Any]] = []
        self._admit_seq = 0
        self._filling = False  # static policy: whole-batch fill phase
        # prompt tokens served from the cache per request, accumulated
        # across re-admissions (eviction/recompute)
        self._cached_tokens: Dict[int, int] = {}
        self.stats: Dict[str, float] = {
            "steps": 0, "model_calls": 0, "prefill_calls": 0,
            "decode_calls": 0, "decode_row_slots": 0, "admitted": 0,
            "completed": 0, "evicted": 0, "backpressure": 0,
            "peak_occupancy": 0.0, "frag_sum": 0.0, "frag_samples": 0,
            # prefix-cache counters (0 with the cache off)
            "prefix_hits": 0, "prefix_tokens_saved": 0, "cow_copies": 0,
            "shared_pages": 0, "prefill_tokens": 0,
            # speculative counters (0 with speculation off); decode_tokens
            # = tokens emitted by decode/verify passes (prefill first
            # tokens excluded)
            "spec_passes": 0, "spec_drafted": 0, "spec_accepted": 0,
            "decode_tokens": 0,
        }
        # host seconds spent in model passes (synchronised by the token
        # copy-back at the end of each pass)
        self.wall: Dict[str, float] = {"decode_s": 0.0, "verify_s": 0.0,
                                       "prefill_s": 0.0}

    # -- model passes --------------------------------------------------------

    def _walk(self, layers, pools, table, h, op: str, *op_args):
        for layer, pool in zip(layers, pools):
            if isinstance(layer, ServeLayer):
                h = getattr(layer, op)(pool, table, h, *op_args, self.page)
            else:  # pointwise (the LM head)
                h = layer(h)
        return h

    @torch.no_grad()
    def _decode_pass(self, table: np.ndarray, toks: np.ndarray,
                     pos: np.ndarray, npl: int) -> np.ndarray:
        dev = self.device
        logits = self._walk(self.model.layers, self.pools,
                            torch.from_numpy(table).to(dev),
                            torch.from_numpy(toks).to(dev), "serve_decode",
                            torch.from_numpy(pos).to(dev), npl)
        return logits[:, 0, :].argmax(-1).cpu().numpy()

    @torch.no_grad()
    def _verify_pass(self, table: np.ndarray, toks: np.ndarray,
                     pos0: np.ndarray, npl: int) -> np.ndarray:
        dev = self.device
        logits = self._walk(self.model.layers, self.pools,
                            torch.from_numpy(table).to(dev),
                            torch.from_numpy(toks).to(dev), "serve_verify",
                            torch.from_numpy(pos0).to(dev), npl)
        return logits.argmax(-1).cpu().numpy()  # [B, W]

    @torch.no_grad()
    def _prefill_pass(self, table: np.ndarray, chunk: np.ndarray, start: int,
                      want: int, npl: int) -> int:
        dev = self.device
        nb = self._n_body
        layers = self.model.layers
        h = self._walk(layers[:nb], self.pools[:nb],
                       torch.from_numpy(table).to(dev),
                       torch.from_numpy(chunk).to(dev), "serve_prefill",
                       start, npl)
        h = h[:, want:want + 1]  # [1, 1, d]
        for layer in layers[nb:]:
            h = layer(h)
        return int(h[0, 0, :].argmax(-1).item())

    @torch.no_grad()
    def _page_copy(self, src: int, dst: int) -> None:
        """Copy-on-write of slot ``src`` into ``dst`` in every layer's
        pool (payload and scale sidecars)."""
        for pool in self.pools:
            if pool is not None:
                serve_page_copy(pool, src, dst)

    def _check_write_positions(self, hi: int) -> None:
        """The rounding table of an int8 pool covers positions
        [0, n_write_pos); a write past it raises before the pass runs."""
        if hi >= self.n_write_pos and any(
                p is not None and pool_quantized(p) for p in self.pools):
            raise ValueError(
                f"write position {hi} outside the int8 rounding table's "
                f"[0, {self.n_write_pos})")

    # -- request lifecycle -------------------------------------------------

    def _pages_for(self, n_positions: int) -> int:
        """Pages that hold stream positions [0, n_positions)."""
        return (n_positions - 1) // self.page + 1 if n_positions else 0

    def _written_positions(self, req: ServeRequest) -> int:
        # prompt S + decode writes (max_new - 1): the final emitted token
        # is never fed back, so its K/V is never written
        return req.prompt_len + req.max_new - 1

    def submit(self, req: ServeRequest, now: Optional[float] = None) -> bool:
        """Enqueue ``req``; always accepted (the port has no deadlines)."""
        if req.prompt_len < 1 or req.max_new < 1:
            raise ValueError("request needs a non-empty prompt and "
                             "max_new >= 1")
        if req.prompt_len + req.max_new > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new} exceeds max_len {self.cfg.max_len}")
        if self._pages_for(self._written_positions(req)) > \
                self.allocator.capacity:
            raise ValueError(
                f"request {req.rid} can never fit the pool "
                f"({self.allocator.capacity} usable pages)")
        self.queue.append(req)
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self.rows)

    def load(self) -> int:
        """Remaining token work (queued + in flight)."""
        tot = sum(r.prompt_len + r.max_new for r in self.queue)
        for a in self.rows:
            if a is not None:
                tot += (a.req.prompt_len - a.prefill_done) \
                    + (a.req.max_new - len(a.out))
        return tot

    def _free_row(self) -> Optional[int]:
        for i, a in enumerate(self.rows):
            if a is None:
                return i
        return None

    def _active(self) -> List[_Active]:
        return [a for a in self.rows if a is not None]

    def _alloc(self, rid: int, n: int) -> Optional[List[int]]:
        """``allocator.alloc`` preceded, on exhaustion, by reclaiming
        prefix-cache pages no live request references (newest-registered
        first): cached-but-unbound pages are free capacity, and spending
        them beats evicting a live request."""
        slots = self.allocator.alloc(rid, n)
        if slots is None and self.prefix is not None:
            self.prefix.reclaim(n - self.allocator.free_pages)
            slots = self.allocator.alloc(rid, n)
        return slots

    def _evict(self, victim: _Active, rep: StepReport) -> None:
        """Drop the victim's page references and re-queue it (front) for
        recomputation — greedy decode regenerates the same tokens (shared
        pages survive for their other holders)."""
        self.allocator.free_request(victim.req.rid)
        self.table[victim.row, :] = 0
        self.rows[victim.row] = None
        self.queue.appendleft(victim.req)
        rep.evicted += 1
        self.stats["evicted"] += 1

    def _evict_newest(self, rep: StepReport) -> Optional[_Active]:
        """Evict the newest-admitted in-flight request."""
        active = self._active()
        if not active:
            return None
        victim = max(active, key=lambda a: a.admit_seq)
        self._evict(victim, rep)
        return victim

    def _complete(self, a: _Active, t: float, rep: StepReport) -> None:
        self.allocator.free_request(a.req.rid)
        self.table[a.row, :] = 0
        self.rows[a.row] = None
        # static policy: a completion ends the fill phase (the drain
        # barrier of the A/B baseline)
        self._filling = False
        self.finished.append({
            "rid": a.req.rid,
            "arrival": a.req.arrival,
            "prompt_len": a.req.prompt_len,
            "tokens": list(a.out),
            "n_tokens": len(a.out),
            "first_token_t": a.first_token_t,
            "token_times": list(a.token_times),
            "completed_t": t,
            # prompt tokens served from the prefix cache, over all
            # admissions of this request
            "cached_tokens": self._cached_tokens.pop(a.req.rid, 0),
        })
        rep.completed.append(a.req.rid)
        self.stats["completed"] += 1

    # -- the step: ensure pages -> pack -> prefill/decode -> retire --------

    def _ensure_decode_pages(self, rep: StepReport) -> List[_Active]:
        """Give every decode row the page its next write needs, evicting
        newest-first when the pool is exhausted. Returns the surviving
        decode set."""
        out = []
        for a in [x for x in self.rows
                  if x is not None and x.state == "decode"]:
            if self.rows[a.row] is not a:  # evicted by an earlier victim hunt
                continue
            pgi = a.decode_pos // self.page
            alive = True
            while pgi >= a.n_pages:
                slots = self._alloc(a.req.rid, 1)
                if slots is not None:
                    self.table[a.row, a.n_pages] = slots[0]
                    a.n_pages += 1
                    continue
                victim = self._evict_newest(rep)
                assert victim is not None
                if victim is a:
                    alive = False
                    break
            if alive:
                out.append(a)
        # a victim can sit at a LOWER row index than its evictor (rows are
        # reused): a row already appended here may have been evicted by a
        # later iteration's victim hunt — never run it
        return [a for a in out if self.rows[a.row] is a]

    def _ensure_prefill_pages(self, a: _Active, end_real: int,
                              rep: StepReport, can_evict: bool) -> bool:
        need = self._pages_for(end_real) - a.n_pages
        while True:
            if need <= 0:
                return True
            slots = self._alloc(a.req.rid, need)
            if slots is not None:
                self.table[a.row, a.n_pages:a.n_pages + need] = slots
                a.n_pages += need
                return True
            if not can_evict:
                rep.backpressure += 1
                self.stats["backpressure"] += 1
                return False
            victim = self._evict_newest(rep)
            if victim is a:
                return False  # evicted ourselves; the queue will retry

    def _admit_full_hit(self, req: ServeRequest, hit: List[int],
                        rep: StepReport) -> Optional[_Active]:
        """Admit a request whose WHOLE (page-aligned) prompt is cached:
        bind every cached page, copy the last one into a private slot (the
        decode pass is about to re-derive position S-1's K/V into it, and
        a write into a shared page would couple the sibling streams), and
        enter decode directly with the last prompt token pending. Zero
        prefill calls; the first output token costs one decode pass."""
        S = req.prompt_len
        nblk = S // self.page
        # pin every matched page (the copy's source included) before
        # allocating: _alloc's reclaim frees index-only pages, which the
        # hit slots are once their owner completed
        for s in hit[:nblk]:
            self.allocator.incref(s)
        priv = self._alloc(req.rid, 1)
        if priv is None:
            for s in hit[:nblk]:
                self.allocator.decref(s)
            rep.backpressure += 1
            self.stats["backpressure"] += 1
            return None
        self.allocator.bind(req.rid, hit[:nblk - 1])
        self.queue.popleft()
        row = self._free_row()
        a = _Active(req=req, row=row, admit_seq=self._admit_seq)
        self._admit_seq += 1
        self.table[row, :] = 0
        self.table[row, :nblk - 1] = hit[:nblk - 1]
        self.table[row, nblk - 1] = priv[0]
        a.n_pages = nblk
        a.prefill_done = S
        a.registered_blocks = nblk  # every block is already in the index
        a.state = "decode"
        a.pending_tok = int(req.prompt[S - 1])
        self.rows[row] = a
        # the source page is pinned above, so the alloc's reclaim cannot
        # have freed it between match and this copy
        self._page_copy(int(hit[nblk - 1]), priv[0])
        # release the admission pins (the bind keeps its own references;
        # the copy's source drops back to its cache reference)
        for s in hit[:nblk]:
            self.allocator.decref(s)
        rep.admitted += 1
        self.stats["admitted"] += 1
        self.stats["prefix_hits"] += 1
        self.stats["cow_copies"] += 1
        # S - 1 prompt positions never recomputed (the last one re-runs
        # through the decode pass to produce the first-token logits)
        self.stats["prefix_tokens_saved"] += S - 1
        self._cached_tokens[req.rid] = \
            self._cached_tokens.get(req.rid, 0) + S - 1
        return a

    def _admission_open(self) -> bool:
        if self.cfg.policy == "continuous":
            return True
        # static: admit only during a whole-batch fill phase
        if not self._filling and not self._active():
            self._filling = True
        return self._filling

    def step(self, now: float = 0.0) -> StepReport:
        """One engine step. Returns what ran; emission/completion times are
        stamped at ``now + cost`` (the step's end in virtual time)."""
        rep = StepReport()
        C = self.cfg.resolved_prefill_chunk()

        # 1) decode set: every decode row gets its next page (evictions may
        #    shrink the set — or free rows the packer then refills)
        decode_set = self._ensure_decode_pages(rep)
        # 1b) speculative drafts, planned BEFORE the budget so the packer
        #     charges a verify pass at its true token width; nothing later
        #     in a step with live decode rows can evict, so the plan cannot
        #     go stale
        draft_plan = (self._plan_drafts(decode_set)
                      if self._spec is not None and decode_set else None)
        spec_tokens = (sum(len(d) for _, d, _ in draft_plan)
                       if draft_plan else 0)
        budget = (self.cfg.resolved_token_budget() - len(decode_set)
                  - spec_tokens)

        # 2) continue in-flight prefills, admission order
        prefill_calls: List[_Active] = []
        for a in sorted((x for x in self.rows
                         if x is not None and x.state == "prefill"),
                        key=lambda x: x.admit_seq):
            if self.rows[a.row] is not a:
                continue  # evicted by an earlier iteration's victim hunt
            if budget < C:
                break
            end_real = min(a.prefill_done + C, a.req.prompt_len)
            # waiting only helps if running requests will free pages;
            # with no decode rows in flight, evict to guarantee progress
            if self._ensure_prefill_pages(a, end_real, rep,
                                          can_evict=not decode_set):
                prefill_calls.append(a)
                budget -= C

        # 3) admit new requests while the packer has budget. With the
        #    prefix cache on, an admission binds the pages of its longest
        #    cached prefix and prefills only the tail; a FULL page-aligned
        #    hit skips prefill (budget 1, the bookkeeping slot).
        while (self.queue and self._free_row() is not None
               and self._admission_open()):
            req = self.queue[0]
            hit = self.prefix.match(req.prompt) if self.prefix else []
            S = req.prompt_len
            full_hit = bool(hit) and len(hit) * self.page >= S
            if budget < (1 if full_hit else C):
                break
            if full_hit:
                if self._admit_full_hit(req, hit, rep) is None:
                    break  # backpressure: not even one copy page
                budget -= 1
                continue
            # partial hit: never bind the page holding position S-1 — the
            # first-token logits need the last prompt position to run
            # through a prefill chunk anyway
            nbind = min(len(hit), (S - 1) // self.page)
            cached = nbind * self.page
            end0 = min(cached + C, S)  # first tail chunk's frontier
            if self.cfg.policy == "static":
                # static baseline reserves the full worst case up front
                # (prefix_cache is continuous-only, so nbind == 0 here)
                need = self._pages_for(self._written_positions(req))
            else:
                need = self._pages_for(end0) - nbind
            # pin the matched pages BEFORE allocating the tail: _alloc's
            # reclaim frees index-only pages, which the not-yet-bound hit
            # slots are once their owner completed — unpinned, a hit page
            # could come back as this request's own (writable) tail slot
            for s in hit[:nbind]:
                self.allocator.incref(s)
            slots = self._alloc(req.rid, need) if need else []
            for s in hit[:nbind]:
                self.allocator.decref(s)
            if slots is None:
                rep.backpressure += 1
                self.stats["backpressure"] += 1
                self._filling = False  # static: close the fill phase
                break
            if nbind:
                self.allocator.bind(req.rid, hit[:nbind])
            self.queue.popleft()
            row = self._free_row()
            a = _Active(req=req, row=row, admit_seq=self._admit_seq)
            self._admit_seq += 1
            self.table[row, :] = 0
            self.table[row, :nbind] = hit[:nbind]
            self.table[row, nbind:nbind + need] = slots
            a.n_pages = nbind + need
            a.prefill_done = cached
            a.registered_blocks = nbind
            self.rows[row] = a
            if nbind:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_saved"] += cached
                self._cached_tokens[req.rid] = \
                    self._cached_tokens.get(req.rid, 0) + cached
            prefill_calls.append(a)
            budget -= C
            rep.admitted += 1
            self.stats["admitted"] += 1
        if self.cfg.policy == "static" and (
                self._free_row() is None or not self.queue):
            self._filling = False

        # 4) price the step, then run it. A verify pass is ONE model pass,
        #    the price of the decode step it replaces
        cost = len(prefill_calls) + (1 if decode_set else 0)
        t_end = now + cost
        for a in prefill_calls:
            self._run_prefill_chunk(a, C, t_end, rep)
        if decode_set:
            if draft_plan is not None and any(d for _, d, _ in draft_plan):
                self._run_verify(draft_plan, t_end, rep)
            else:
                self._run_decode(decode_set, t_end, rep)

        # 5) occupancy / fragmentation accounting
        self.stats["steps"] += 1
        self.stats["model_calls"] += cost
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"],
                                           self.allocator.occupancy())
        self.stats["shared_pages"] = max(self.stats["shared_pages"],
                                         self.allocator.shared_pages)
        live = cap = 0
        for a in self._active():
            live += a.prefill_done + max(0, len(a.out) - 1)
            cap += a.n_pages * self.page
        if cap:
            self.stats["frag_sum"] += 1.0 - live / cap
            self.stats["frag_samples"] += 1
        rep.cost = cost
        return rep

    def _plan_drafts(self, decode_set: List[_Active]):
        """Per decode row: draft up to K tokens from the row's own stream
        (prompt + emitted tokens) and pre-allocate the pages the span write
        needs. Speculation never evicts and never reclaims prefix-cache
        pages: draft headroom comes straight off the free list, and a
        shortfall truncates the drafts to what the row's pages hold.
        Entries are ``(active, drafts, pre_pages)``; ``pre_pages`` (the
        row's page count before planning) bounds the rollback to the pages
        this planner added, so the static policy's up-front reservation
        survives a verify pass."""
        plan = []
        for a in decode_set:
            pre_pages = a.n_pages
            # never draft past max_new: the verify pass emits at most
            # 1 + len(drafts) tokens, and the final token's K/V is never
            # written, so the pages stay inside the plain worst case
            k_max = a.req.max_new - len(a.out) - 1
            drafts: List[int] = []
            if k_max > 0:
                ctx = list(a.req.prompt.tolist()) + a.out
                drafts = self._drafter.propose(ctx, k_max)
            if drafts:
                need = self._pages_for(
                    a.decode_pos + len(drafts) + 1) - a.n_pages
                while need > 0:
                    slots = self.allocator.alloc(a.req.rid, need)
                    if slots is not None:
                        self.table[a.row,
                                   a.n_pages:a.n_pages + need] = slots
                        a.n_pages += need
                        break
                    need -= 1
                # positions [decode_pos, n_pages * page) are writable
                fit = a.n_pages * self.page - 1 - a.decode_pos
                drafts = drafts[:max(0, fit)]
            if drafts:
                self.stats["spec_drafted"] += len(drafts)
            plan.append((a, drafts, pre_pages))
        return plan

    def _run_verify(self, plan, t_end: float, rep: StepReport) -> None:
        """One speculative verify pass over the decode set: score every
        row's pending token + drafts at span positions [decode_pos,
        decode_pos + W) in ONE [max_batch, W] pass, accept the longest
        draft prefix matching greedy argmax (so the stream is that of
        plain decoding), keep the accepted K/V the span write already put
        in place, and roll back pages past the accepted frontier."""
        assert all(self.rows[a.row] is a for a, _, _ in plan), \
            "scheduled a dead (evicted) row"
        W = self._spec[1] + 1
        B = self.cfg.max_batch
        toks = np.zeros((B, W), np.int32)
        pos0 = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for a, drafts, _ in plan:
            toks[a.row, 0] = a.pending_tok
            if drafts:
                toks[a.row, 1:1 + len(drafts)] = drafts
            pos0[a.row] = a.decode_pos
            mask[a.row] = True
        # inactive rows route to scratch exactly like the decode pass; a
        # row's padded draft tail lands in its page headroom (never
        # attended: key pos > every live query pos) or on scratch
        ver_table = np.where(mask[:, None], self.table, 0).astype(np.int32)
        npl = max((int(a.decode_pos) + len(d)) // self.page + 1
                  for a, d, _ in plan)
        self._check_write_positions(int(pos0.max()) + W - 1)
        t0 = time.perf_counter()
        nxt = self._verify_pass(ver_table, toks, pos0, npl)
        self.wall["verify_s"] += time.perf_counter() - t0
        rep.decode_rows = len(plan)
        self.stats["spec_passes"] += 1
        self.stats["decode_row_slots"] += len(plan)
        for a, drafts, pre_pages in plan:
            y = nxt[a.row]  # y[j] = greedy token after span slot j
            emitted = [int(y[0])]  # slot 0 (the pending token) is exact
            for j in range(1, len(drafts) + 1):
                # draft j-1 sits in slot j; it was the right input iff it
                # equals the token the model emitted after slot j-1
                if int(drafts[j - 1]) != emitted[j - 1]:
                    break
                emitted.append(int(y[j]))
            self.stats["spec_accepted"] += len(emitted) - 1
            self.stats["decode_tokens"] += len(emitted)
            for tok in emitted:
                a.out.append(tok)
                a.token_times.append(t_end)
            if a.first_token_t is None:
                # a full-hit admission's first token comes from this pass
                a.first_token_t = t_end
            if len(a.out) >= a.req.max_new:
                self._complete(a, t_end, rep)
            else:
                a.pending_tok = emitted[-1]
                # rollback: pages past the new frontier (rejected-draft
                # territory) return to the pool; their stale K/V is never
                # attended and re-writes overwrite it. Bounded below by
                # pre_pages: only pages _plan_drafts added are released
                keep = max(self._pages_for(a.decode_pos + 1), pre_pages)
                if a.n_pages > keep:
                    extra = [int(s)
                             for s in self.table[a.row, keep:a.n_pages]]
                    self.allocator.release(a.req.rid, extra)
                    self.table[a.row, keep:a.n_pages] = 0
                    a.n_pages = keep

    def _run_prefill_chunk(self, a: _Active, C: int, t_end: float,
                           rep: StepReport) -> None:
        assert self.rows[a.row] is a, "scheduled a dead (evicted) row"
        S = a.req.prompt_len
        start = a.prefill_done
        end_real = min(start + C, S)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :end_real - start] = a.req.prompt[start:end_real]
        last = end_real == S
        want = (S - 1 - start) if last else 0
        npl = self._pages_for(end_real)
        self._check_write_positions(start + C - 1)
        t0 = time.perf_counter()
        tok = self._prefill_pass(self.table[a.row:a.row + 1], chunk, start,
                                 want, npl)
        self.wall["prefill_s"] += time.perf_counter() - t0
        a.prefill_done = end_real
        rep.prefill_calls += 1
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += end_real - start
        if self.prefix is not None:
            # register newly completed prompt pages (every position prompt
            # content, never written again)
            for b in range(a.registered_blocks, end_real // self.page):
                self.prefix.register(a.req.prompt, b,
                                     int(self.table[a.row, b]))
            a.registered_blocks = max(a.registered_blocks,
                                      end_real // self.page)
        if last:
            a.out.append(tok)
            a.token_times.append(t_end)
            a.first_token_t = t_end
            if len(a.out) >= a.req.max_new:
                self._complete(a, t_end, rep)
            else:
                a.state = "decode"
                a.pending_tok = tok

    def _run_decode(self, decode_set: List[_Active], t_end: float,
                    rep: StepReport) -> None:
        assert all(self.rows[a.row] is a for a in decode_set), \
            "scheduled a dead (evicted) row"
        B = self.cfg.max_batch
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for a in decode_set:
            toks[a.row, 0] = a.pending_tok
            pos[a.row] = a.decode_pos
            mask[a.row] = True
        # inactive rows (free, or mid-prefill) are routed to the scratch
        # slot so their masked writes cannot touch a live page; the kernel
        # reads slot 0 for them harmlessly
        dec_table = np.where(mask[:, None], self.table, 0).astype(np.int32)
        npl = max(int(a.decode_pos) // self.page + 1 for a in decode_set)
        self._check_write_positions(int(pos.max()))
        t0 = time.perf_counter()
        nxt = self._decode_pass(dec_table, toks, pos, npl)
        self.wall["decode_s"] += time.perf_counter() - t0
        rep.decode_rows = len(decode_set)
        self.stats["decode_calls"] += 1
        self.stats["decode_row_slots"] += len(decode_set)
        self.stats["decode_tokens"] += len(decode_set)
        for a in decode_set:
            tok = int(nxt[a.row])
            a.out.append(tok)
            a.token_times.append(t_end)
            if a.first_token_t is None:
                # a full-hit admission skips prefill: its first token
                # comes from this decode pass
                a.first_token_t = t_end
            if len(a.out) >= a.req.max_new:
                self._complete(a, t_end, rep)
            else:
                a.pending_tok = tok

    def stats_summary(self) -> Dict[str, float]:
        s = dict(self.stats)
        calls = s.pop("decode_calls")
        slots = s.pop("decode_row_slots")
        frag_sum, frag_n = s.pop("frag_sum"), s.pop("frag_samples")
        s["decode_calls"] = calls
        # verify passes fill batch rows like decode passes: the
        # utilisation denominator counts both
        passes = calls + s["spec_passes"]
        s["decode_batch_util"] = (
            slots / (passes * self.cfg.max_batch) if passes else 0.0)
        s["mean_page_fragmentation"] = frag_sum / frag_n if frag_n else 0.0
        # HBM accounting: peak_occupancy * pool_bytes = peak cache bytes
        # (payload only: the int8 scale sidecars are excluded)
        s["bytes_per_page"] = self.bytes_per_page
        s["pool_bytes"] = self.bytes_per_page * self.cfg.pool_pages
        # speculative rates: accept rate over drafted tokens, and tokens a
        # request gains per decode/verify row-pass (1 + mean accepted)
        s["spec_accept_rate"] = (
            s["spec_accepted"] / s["spec_drafted"]
            if s["spec_drafted"] else 0.0)
        s["tokens_per_pass"] = (
            s["decode_tokens"] / slots if slots else 0.0)
        return s


class ReplicatedServer:
    """The reference's fleet interface (``submit``/``step``/``finished``/
    ``stats_summary``), which servebench drives, over exactly one replica:
    multi-replica serving is not ported yet."""

    def __init__(self, engines: List[ServeEngine]):
        if len(engines) != 1:
            raise NotImplementedError(
                "multi-replica serving is not ported yet (one engine)")
        self.engines = list(engines)

    def submit(self, req: ServeRequest, now: Optional[float] = None) -> bool:
        return self.engines[0].submit(req, now=now)

    def has_work(self) -> bool:
        return self.engines[0].has_work()

    def step(self, now: float = 0.0) -> StepReport:
        return self.engines[0].step(now)

    @property
    def finished(self) -> List[Dict[str, Any]]:
        return list(self.engines[0].finished)

    def stats_summary(self) -> Dict[str, float]:
        return self.engines[0].stats_summary()


def make_server(model: LayerModel, cfg: ServeConfig,
                device: torch.device) -> ReplicatedServer:
    """A one-replica server for ``model`` (already on ``device``)."""
    return ReplicatedServer([ServeEngine(model, cfg, device)])
