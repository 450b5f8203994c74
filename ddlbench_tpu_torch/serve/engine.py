"""Continuous-batching serving engine over the paged KV pool (PyTorch port).

The port of ``ddlbench_tpu/serve/engine.py`` trimmed to the serving slice:
one replica, tp = 1, greedy decoding, f32/bf16 pools, the continuous policy
and the static baseline. The scheduler is the reference's, line for line,
so both engines make the same decisions on the same traffic and — with the
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
* Eviction closes the loop on pool exhaustion: when a growing request needs
  a page and the free list is empty, the engine evicts the NEWEST-admitted
  request (its pages freed, the request re-queued at the front for
  recomputation, which greedy decoding regenerates identically).
* ``policy="static"`` is the A/B baseline: admission only when every row is
  free, with full worst-case page reservation, draining the batch before
  the next fill.

Virtual time: one unit = one model pass (a decode step over max_batch rows
or one prefill chunk). All latency/goodput metrics are in these units —
deterministic, and framework-independent. The engine also keeps the host
wall-clock seconds of its decode and prefill passes (``wall``), each ending
in the device-to-host copy of the emitted tokens, so on a card they are
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
from ddlbench_tpu_torch.ops.paged_decode import pool_page_bytes
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.workload import ServeRequest

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class _Active:
    """Host-side bookkeeping for one in-flight request on one engine row."""

    req: ServeRequest
    row: int
    admit_seq: int  # admission order; eviction victims are newest-first
    state: str = "prefill"  # "prefill" -> "decode"
    prefill_done: int = 0  # prompt positions already processed
    n_pages: int = 0  # table[row, :n_pages] hold this request's slots
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
    """One serving replica: scheduler + allocator + the two model passes.

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
        # one pool per serving layer that keeps K/V (None elsewhere)
        self.pools: List[Optional[dict]] = []
        self.bytes_per_page = 0  # K/V payload bytes per slot, summed
        for layer in model.layers:
            pool = (layer.pool_init(cfg.pool_pages, cfg.page, dtype, device)
                    if isinstance(layer, ServeLayer) else None)
            if pool is not None:
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
        self.queue: deque = deque()
        self.rows: List[Optional[_Active]] = [None] * cfg.max_batch
        self.finished: List[Dict[str, Any]] = []
        self._admit_seq = 0
        self._filling = False  # static policy: whole-batch fill phase
        self.stats: Dict[str, float] = {
            "steps": 0, "model_calls": 0, "prefill_calls": 0,
            "decode_calls": 0, "decode_row_slots": 0, "admitted": 0,
            "completed": 0, "evicted": 0, "backpressure": 0,
            "peak_occupancy": 0.0, "frag_sum": 0.0, "frag_samples": 0,
            # prefix-cache counters: always 0 (the port has no prefix
            # cache yet), kept so the servebench row's key set matches
            # the reference's
            "prefix_hits": 0, "prefix_tokens_saved": 0, "cow_copies": 0,
            "shared_pages": 0, "prefill_tokens": 0,
        }
        # host seconds spent in model passes (synchronised by the token
        # copy-back at the end of each pass)
        self.wall: Dict[str, float] = {"decode_s": 0.0, "prefill_s": 0.0}

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
        return self.allocator.alloc(rid, n)

    def _evict(self, victim: _Active, rep: StepReport) -> None:
        """Free the victim's pages and re-queue it (front) for
        recomputation — greedy decode regenerates the same tokens."""
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
        budget = self.cfg.resolved_token_budget() - len(decode_set)

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

        # 3) admit new requests while the packer has budget
        while (self.queue and self._free_row() is not None
               and self._admission_open()):
            req = self.queue[0]
            if budget < C:
                break
            end0 = min(C, req.prompt_len)  # first chunk's frontier
            if self.cfg.policy == "static":
                # static baseline reserves the full worst case up front
                need = self._pages_for(self._written_positions(req))
            else:
                need = self._pages_for(end0)
            slots = self._alloc(req.rid, need)
            if slots is None:
                rep.backpressure += 1
                self.stats["backpressure"] += 1
                self._filling = False  # static: close the fill phase
                break
            self.queue.popleft()
            row = self._free_row()
            a = _Active(req=req, row=row, admit_seq=self._admit_seq)
            self._admit_seq += 1
            self.table[row, :] = 0
            self.table[row, :need] = slots
            a.n_pages = need
            self.rows[row] = a
            prefill_calls.append(a)
            budget -= C
            rep.admitted += 1
            self.stats["admitted"] += 1
        if self.cfg.policy == "static" and (
                self._free_row() is None or not self.queue):
            self._filling = False

        # 4) price the step, then run it
        cost = len(prefill_calls) + (1 if decode_set else 0)
        t_end = now + cost
        for a in prefill_calls:
            self._run_prefill_chunk(a, C, t_end, rep)
        if decode_set:
            self._run_decode(decode_set, t_end, rep)

        # 5) occupancy / fragmentation accounting
        self.stats["steps"] += 1
        self.stats["model_calls"] += cost
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"],
                                           self.allocator.occupancy())
        live = cap = 0
        for a in self._active():
            live += a.prefill_done + max(0, len(a.out) - 1)
            cap += a.n_pages * self.page
        if cap:
            self.stats["frag_sum"] += 1.0 - live / cap
            self.stats["frag_samples"] += 1
        rep.cost = cost
        return rep

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
        t0 = time.perf_counter()
        tok = self._prefill_pass(self.table[a.row:a.row + 1], chunk, start,
                                 want, npl)
        self.wall["prefill_s"] += time.perf_counter() - t0
        a.prefill_done = end_real
        rep.prefill_calls += 1
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += end_real - start
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
        t0 = time.perf_counter()
        nxt = self._decode_pass(dec_table, toks, pos, npl)
        self.wall["decode_s"] += time.perf_counter() - t0
        rep.decode_rows = len(decode_set)
        self.stats["decode_calls"] += 1
        self.stats["decode_row_slots"] += len(decode_set)
        for a in decode_set:
            tok = int(nxt[a.row])
            a.out.append(tok)
            a.token_times.append(t_end)
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
        s["decode_batch_util"] = (
            slots / (calls * self.cfg.max_batch) if calls else 0.0)
        s["mean_page_fragmentation"] = frag_sum / frag_n if frag_n else 0.0
        # HBM accounting: peak_occupancy * pool_bytes = peak cache bytes
        s["bytes_per_page"] = self.bytes_per_page
        s["pool_bytes"] = self.bytes_per_page * self.cfg.pool_pages
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
