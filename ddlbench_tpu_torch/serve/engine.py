"""Continuous-batching serving engine over the paged KV pool (PyTorch port).

The port of ``ddlbench_tpu/serve/engine.py``: float32, bfloat16 and int8
pools, tensor-parallel replicas (``cfg.tp``), the continuous policy and
the static baseline, the cross-request prefix cache, self-drafting
speculative verify, sampling, deadlines with shedding and timeouts, SLO
tiers, request-lifecycle tracing and the flight recorder, the SDC
checksum ledger with quarantine and scrub, page shipping between engines
(serve/handoff.py builds the disaggregated server on it), and the
replicated fleet over them (:class:`ReplicatedServer`: least-loaded
dispatch, live resize, replica kill and stall, the heartbeat drain).
The scheduler is the reference's, line for line, so both engines make
the same decisions on the same traffic and — with the same weights —
emit the same token streams.

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
* Tensor parallelism (``cfg.tp`` > 1): a tp group is ONE replica. Each
  dense block's parameters are split by Megatron's slicing
  (models/transformer.tp_split_layer_params, the splitter training
  uses), and its pool holds each shard's [n_pages, page, H/tp, dh] slice
  stacked on a leading [tp] axis (the page axis moves to 1, as in the
  reference; ops/paged_decode.slot_axis reads it from the rank). The
  engine walks its shards in one process on its one device: each shard
  writes and attends its heads (the paged kernels on the shard's
  contiguous pool slice) and the row-parallel products are
  summed in shard order; embeddings and the LM head run once. The page
  table, the allocator and every scheduler decision stay per engine, so
  a tp group schedules exactly as a tp = 1 replica does. The reference
  asks for tp devices; here one device holds every shard.
* Int8 pools (``cfg.kv_dtype``) quantise at the page write with the
  reference's counter-based stochastic rounding: each layer's pool carries
  ``kv_seed`` = the layer's index in ``model.layers`` (the embedding is 0)
  and a table of its rounding uniforms for every position a write can
  name, computed once here (ops/paged_decode.kv_u_table); at tp > 1
  every shard rounds its own head slice with the layer's key, drawn over
  the shard's [H/tp, dh] shape, as the reference's shards do.
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
* Sampling (``cfg.temperature > 0``): the decode and prefill passes copy
  the float32 logits to the host (one synchronous copy per pass) in place
  of the on-device argmax, and the host draws each token from the float64
  softmax with a seed keyed by (sample_seed, request id, token index), so
  streams are reproducible and eviction/recompute regenerates them.
  Speculative verify stays greedy-only.
* Eviction closes the loop on pool exhaustion: when a growing request needs
  a page and the free list is empty, the engine first reclaims prefix-cache
  pages no live request holds, then evicts the NEWEST-admitted request —
  a batch-tier one first — (its references dropped, the request re-queued
  at the front for recomputation, which greedy decoding and seeded sampling
  both regenerate identically).
* Deadlines and SLO tiers: a request whose projected completion already
  misses its deadline is SHED at submit (``submit`` returns False, the
  named rejection the driver retries), and one whose deadline passes is
  cancelled into the ``timeout`` terminal state with every page freed.
  Interactive requests admit ahead of batch ones. Plain traffic (no
  deadlines, one tier) schedules as before.
* Observability (``cfg.trace``): the engine emits its lifecycle decisions
  into the process-global tracer (telemetry/tracer.py) in virtual time —
  one track per request, pool and prefix instants on a pool track, per-step
  counters — and keeps a ring of recent step states (``cfg.
  flight_recorder``) for :meth:`ServeEngine.snapshot`. Tracing only
  records decisions already made: streams and virtual times are the same
  traced or not.
* The SDC ledger (``cfg.integrity``; serve/integrity.py): every pool write
  stamps the written (layer, slot) with a checksum of its rows, copied to
  the host synchronously; prefix-hit binds, exports and the scrubber
  (``cfg.scrub`` slots a step) verify against it. A mismatch quarantines
  the slot for good and evicts every request that holds it onto the
  recompute path, whose re-prefill is itself held to the words the
  evicted pages had.
* Page shipping: :meth:`ServeEngine.extract_request` copies a decode-state
  request's pages to the host and frees them; :meth:`ServeEngine.
  import_request` writes them into another engine's pool verbatim and
  resumes the request there.
* The fleet: every replica of a server is built on the one device and
  shares the one model object (its weights live there once); each has its
  own KV pool, allocator, scheduler and flight recorder. A global step runs
  the replicas one after another on the device's stream and costs the
  maximum of their costs in virtual time, as if they ran in parallel, as
  the reference's replicas do on devices of their own.
* ``policy="static"`` is the A/B baseline: admission only when every row is
  free, with full worst-case page reservation, draining the batch before
  the next fill.

Virtual time: one unit = one model pass (a decode step over max_batch rows
or one prefill chunk; a verify pass costs one unit, like the decode step it
replaces). All latency/goodput metrics are in these units — deterministic,
and framework-independent. The engine also keeps the host wall-clock
seconds of its decode, verify and prefill passes (``wall``), each ending in
the device-to-host copy of the emitted tokens (or logits), so on a card
they are device-synchronised step times.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.models.layers import LayerModel, ServeLayer
from ddlbench_tpu_torch.models.transformer import tp_split_layer_params
from ddlbench_tpu_torch.ops.paged_decode import (kv_u_table,
                                                 pool_checksum_keys,
                                                 pool_page_bytes,
                                                 pool_quantized,
                                                 serve_page_copy, slot_index)
from ddlbench_tpu_torch.serve.allocator import PageAllocator
from ddlbench_tpu_torch.serve.draft import NgramDrafter
from ddlbench_tpu_torch.serve.integrity import (PageLedger, host_rows,
                                                page_checksum,
                                                ship_checksums)
from ddlbench_tpu_torch.serve.prefix import PrefixIndex
from ddlbench_tpu_torch.serve.workload import TIERS, ServeRequest
from ddlbench_tpu_torch.telemetry.stats import request_slo_ok
from ddlbench_tpu_torch.telemetry.tracer import get_tracer
from ddlbench_tpu_torch.train.watchdog import ProgressMonitor

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _vns(t: float) -> int:
    """Virtual time -> trace 'nanoseconds': one model pass is 1000 ns, so
    the exporter's /1e3 renders it as 1 µs and every timestamp is an exact
    integer (serveview's decompositions tile without float drift)."""
    return int(round(t * 1000.0))


def sample_token(logits: np.ndarray, temperature: float, top_k: int,
                 sample_seed: int, rid: int, token_index: int) -> int:
    """Temperature/top-k sampling with a counter-based seed: one uniform
    from ``random.Random(f"{sample_seed}:{rid}:{token_index}")`` (CPython
    seeds strings through SHA-512), inverse-transformed over the float64
    softmax CDF. Keyed by TOKEN INDEX, not engine step, so
    eviction/recompute re-draws the same stream. Deterministic given the
    logits' bytes."""
    scaled = logits.astype(np.float64) / temperature
    if top_k:
        # ties broken by vocab index (stable sort)
        order = np.argsort(-scaled, kind="stable")
        mask = np.full_like(scaled, -np.inf)
        keep = order[:top_k]
        mask[keep] = scaled[keep]
        scaled = mask
    scaled -= scaled.max()
    probs = np.exp(scaled)
    probs /= probs.sum()
    u = random.Random(f"{sample_seed}:{rid}:{token_index}").random()
    idx = int(np.searchsorted(np.cumsum(probs), u, side="right"))
    return min(idx, len(probs) - 1)


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
    # rids cancelled into the `timeout` terminal state this step (the
    # closed-loop driver releases the next request on these too)
    timed_out: List[int] = dataclasses.field(default_factory=list)

    def merge(self, other: "StepReport") -> None:
        """Fold one replica's report into the fleet's global step: the
        replicas run in parallel in virtual time, so the cost is the
        maximum; the counts add up."""
        self.cost = max(self.cost, other.cost)
        self.prefill_calls += other.prefill_calls
        self.decode_rows += other.decode_rows
        self.admitted += other.admitted
        self.evicted += other.evicted
        self.backpressure += other.backpressure
        self.completed.extend(other.completed)
        self.timed_out.extend(other.timed_out)


def unservable_layers(model: LayerModel) -> List[str]:
    """The names of ``model``'s layers without serving ops (neither a
    ServeLayer nor pointwise): an MoE model's blocks, as in the
    reference. The engine refuses a model with any."""
    return [type(l).__name__ for l in model.layers
            if not (isinstance(l, ServeLayer)
                    or getattr(l, "pointwise", False))]


class ServeEngine:
    """One serving replica: scheduler + allocator + the model passes.

    ``model`` must already live on ``device``; the pools are built there.
    ``replica`` is the replica's id in its fleet: its trace tracks are
    ``r{replica}/...``.
    """

    def __init__(self, model: LayerModel, cfg: ServeConfig,
                 device: torch.device, replica: int = 0):
        cfg.validate()
        missing = unservable_layers(model)
        if missing:
            raise NotImplementedError(
                f"{model.name} has layers without serving support: "
                f"{missing}; the serving engine is wired for causal-LM "
                "transformer stacks")
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
        # tensor parallelism: each dense block's shards (None for a layer
        # left whole); its pool is stacked on a leading [tp] axis
        self.tp = cfg.tp
        self._shards: List[Optional[List[dict]]] = [
            self._split(layer) for layer in model.layers]
        # one pool per serving layer that keeps K/V (None elsewhere)
        self.pools: List[Optional[dict]] = []
        self.bytes_per_page = 0  # K/V payload bytes per slot, summed
        for li, layer in enumerate(model.layers):
            pool = None
            if isinstance(layer, ServeLayer):
                pool = (layer.pool_init(cfg.pool_pages, cfg.page, dtype,
                                        device)
                        if self._shards[li] is None else
                        layer.pool_init(cfg.pool_pages, cfg.page, dtype,
                                        device, tp=cfg.tp))
            if pool is not None:
                if pool_quantized(pool):
                    # the layer's counter seed for the write-boundary
                    # rounding — its index in model.layers, as in the
                    # reference — and the uniforms of every position,
                    # over one shard's heads at tp > 1
                    H, dh = pool["pool_k"].shape[-2:]
                    pool["kv_seed"] = li
                    pool["kv_u"] = kv_u_table(li, self.n_write_pos, H, dh,
                                              device)
                # at tp > 1 the shards' slices sum to the whole page
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
        self._sampling = cfg.temperature > 0.0
        self.queue: deque = deque()
        self.rows: List[Optional[_Active]] = [None] * cfg.max_batch
        self.finished: List[Dict[str, Any]] = []
        self._admit_seq = 0
        self._filling = False  # static policy: whole-batch fill phase
        # observability: host bookkeeping the scheduler never reads
        self.replica = replica
        self._trk = f"r{replica}"  # per-replica trace-track prefix
        self._now = 0.0  # current step's start (mid-schedule instants)
        self._last_t = 0.0  # last step's end: snapshot()'s clock
        # when each queued request entered the queue (arrival, or the
        # eviction instant): the queue_wait span's left edge
        self._queued_at: Dict[int, float] = {}
        # rids evicted and not yet re-admitted (the `recompute` instant)
        self._evicted_rids: set = set()
        self._flight: Optional[deque] = (
            deque(maxlen=cfg.flight_recorder) if cfg.flight_recorder
            else None)
        if cfg.trace:
            # pool/prefix lifecycle instants ride the same virtual clock
            self.allocator.on_event = self._pool_event
            if self.prefix is not None:
                self.prefix.on_event = self._pool_event
        # deadlines: the expiry scan only runs once a deadlined request
        # has been accepted
        self._has_deadlines = False
        # `timeout` terminal records (rid/t/deadline/state/out_tokens/
        # tier) and `shed` admission rejections (rid/t/deadline/tier)
        self.timed_out: List[Dict[str, Any]] = []
        self.shed: List[Dict[str, Any]] = []
        # every eviction (rid/t/tier/batch_active): the tier-order ledger
        self.evicted_log: List[Dict[str, Any]] = []
        # straggler injection: ReplicatedServer.stall sets this; while it
        # is positive the server skips this replica's steps (it holds its
        # requests but makes no progress), one tick per global step
        self._stall_ticks = 0
        # serve-side heartbeat (cfg.heartbeat > 0): the server kicks this
        # monitor every step it schedules the replica, on the virtual
        # clock; an expired monitor on a replica that holds work is the
        # straggler verdict
        self.monitor: Optional[ProgressMonitor] = (
            ProgressMonitor(cfg.heartbeat) if cfg.heartbeat > 0 else None)
        # prompt tokens served from the cache per request, accumulated
        # across re-admissions (eviction/recompute)
        self._cached_tokens: Dict[int, int] = {}
        # SDC defence (serve/integrity.py): with cfg.integrity off there is
        # no ledger, no stamp and no verify
        self.integrity: Optional[PageLedger] = (
            PageLedger() if cfg.integrity else None)
        # detection/quarantine records (t/slot/where/displaced rids):
        # servechaos derives time-to-detect and recovery from them
        self.sdc_events: List[Dict[str, Any]] = []
        self._scrub_cursor = 0
        # eviction-recompute expectations: rid -> {(layer, page index):
        # crc} of the fully written prompt pages at eviction; the replayed
        # prefill must regenerate the same bytes
        self._recompute_expect: Dict[int, Dict[Tuple[int, int], int]] = {}
        if self.integrity is not None:
            # a slot returning to the free list drops its ledger entries
            # (the next tenant re-stamps at its own write)
            self.allocator.on_slot_free = self.integrity.drop_slot
        self.stats: Dict[str, float] = {
            "steps": 0, "model_calls": 0, "prefill_calls": 0,
            "decode_calls": 0, "decode_row_slots": 0, "admitted": 0,
            "completed": 0, "evicted": 0, "backpressure": 0,
            # deadline counters (0 without deadlines)
            "shed": 0, "timeouts": 0,
            "peak_occupancy": 0.0, "frag_sum": 0.0, "frag_samples": 0,
            # prefix-cache counters (0 with the cache off)
            "prefix_hits": 0, "prefix_tokens_saved": 0, "cow_copies": 0,
            "shared_pages": 0, "prefill_tokens": 0,
            # speculative counters (0 with speculation off); decode_tokens
            # = tokens emitted by decode/verify passes (prefill first
            # tokens excluded)
            "spec_passes": 0, "spec_drafted": 0, "spec_accepted": 0,
            "decode_tokens": 0,
            # SDC counters (0 with integrity off)
            "sdc_injected": 0, "sdc_detected": 0, "sdc_quarantined": 0,
            "sdc_recovered": 0, "sdc_scrubbed": 0,
            "sdc_recompute_checks": 0,
        }
        # host seconds spent in model passes (synchronised by the token or
        # logits copy-back at the end of each pass), in host sampling
        # (``sampled`` draws), and in the SDC ledger's slot reads (the
        # device-to-host copies and checksums of its stamps and verifies)
        self.wall: Dict[str, float] = {"decode_s": 0.0, "verify_s": 0.0,
                                       "prefill_s": 0.0, "sample_s": 0.0,
                                       "sampled": 0, "ledger_s": 0.0}

    def _split(self, layer) -> Optional[List[dict]]:
        """A dense serving block's tp shards (contiguous copies of its
        sliced leaves), or None at tp 1 and for a layer left whole."""
        if self.tp == 1 or not isinstance(layer, ServeLayer):
            return None
        shards, _ = tp_split_layer_params(
            {k: p.detach() for k, p in layer.named_parameters()}, self.tp)
        if not shards[0]:
            return None
        if layer.n_heads % self.tp:
            raise ValueError(f"ServeConfig.tp={self.tp}: n_heads="
                             f"{layer.n_heads} not divisible by tp")
        return [{k: t.contiguous() for k, t in sh.items()} for sh in shards]

    # -- model passes --------------------------------------------------------

    def _walk(self, layers, pools, table, h, op: str, *op_args):
        for li, (layer, pool) in enumerate(zip(layers, pools)):
            if not isinstance(layer, ServeLayer):  # pointwise (the LM head)
                h = layer(h)
            elif self._shards[li] is None:
                h = getattr(layer, op)(pool, table, h, *op_args, self.page)
            else:
                h = getattr(layer, op)(pool, table, h, *op_args, self.page,
                                       shards=self._shards[li])
        return h

    @torch.no_grad()
    def _decode_pass(self, table: np.ndarray, toks: np.ndarray,
                     pos: np.ndarray, npl: int) -> np.ndarray:
        """Greedy: each row's argmax token [B]; sampling: the float32
        logits [B, V], one copy to the host for the whole pass."""
        dev = self.device
        logits = self._walk(self.model.layers, self.pools,
                            torch.from_numpy(table).to(dev),
                            torch.from_numpy(toks).to(dev), "serve_decode",
                            torch.from_numpy(pos).to(dev), npl)
        if self._sampling:
            return logits[:, 0, :].float().cpu().numpy()
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
                      want: int, npl: int):
        """Greedy: the argmax token at chunk position ``want``; sampling:
        that position's float32 logits [V] on the host."""
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
        if self._sampling:
            return h[0, 0, :].float().cpu().numpy()
        return int(h[0, 0, :].argmax(-1).item())

    def _emit_token(self, raw, rid: int, token_index: int) -> int:
        """One emitted token from a pass's output: the argmax in greedy
        mode, a host-sampled draw from the logits otherwise."""
        if self._sampling:
            t0 = time.perf_counter()
            tok = sample_token(raw, self.cfg.temperature, self.cfg.top_k,
                               self.cfg.sample_seed, rid, token_index)
            self.wall["sample_s"] += time.perf_counter() - t0
            self.wall["sampled"] += 1
            return tok
        return int(raw)

    @torch.no_grad()
    def _page_copy(self, src: int, dst: int) -> None:
        """Copy-on-write of slot ``src`` into ``dst`` in every layer's
        pool (payload and scale sidecars)."""
        for pool in self.pools:
            if pool is not None:
                serve_page_copy(pool, src, dst)

    # -- SDC defence: stamp / verify / quarantine (serve/integrity.py) -----

    def _slot_crc(self, li: int, slot: int) -> int:
        """Checksum of (layer, slot)'s current device bytes: the payload
        and sidecar rows copied to the host, chained in sorted key order
        (ops/paged_decode.pool_checksum_keys)."""
        t0 = time.perf_counter()
        pool = self.pools[li]
        crc = page_checksum({
            k: host_rows(pool[k][slot_index(k, pool[k], slot)])
            for k in pool_checksum_keys(pool)})
        self.wall["ledger_s"] += time.perf_counter() - t0
        return crc

    def _stamp_slot(self, slot: int) -> None:
        """Stamp every serving layer's ledger entry for ``slot`` from the
        bytes just written: the pool-write hook."""
        for li, pool in enumerate(self.pools):
            if pool is not None:
                self.integrity.stamp(li, slot, self._slot_crc(li, slot))

    def _verify_slot(self, slot: int, where: str,
                     rep: Optional[StepReport] = None) -> bool:
        """Trust-boundary check of ``slot`` against the ledger. True =
        intact (or never stamped); on any layer's mismatch the slot is
        quarantined, every holder recovered, and False returns: the caller
        must not serve it."""
        for li, pool in enumerate(self.pools):
            if pool is None:
                continue
            if self.integrity.verify(li, slot,
                                     self._slot_crc(li, slot)) is False:
                self._quarantine_slot(slot, where, rep)
                return False
        return True

    def _quarantine_slot(self, slot: int, where: str,
                         rep: Optional[StepReport] = None) -> None:
        """Detection -> quarantine -> recovery: retire the slot for good,
        purge its prefix-index entry, and EVICT every request that holds
        it (a corrupted SHARED page walks its refcounts) onto the
        recompute path, which regenerates the pages and the streams."""
        if rep is None:
            rep = StepReport()  # a detection outside step() (export)
        holders = self.allocator.holders(slot)
        self.allocator.quarantine(slot)
        if self.prefix is not None:
            self.prefix.drop_slot(slot)
        displaced: List[int] = []
        for rid in holders:
            victim = next((x for x in self._active()
                           if x.req.rid == rid), None)
            if victim is not None and self.rows[victim.row] is victim:
                self._evict(victim, rep)
                displaced.append(rid)
        self.integrity.drop_slot(slot)
        self.stats["sdc_detected"] += 1
        self.stats["sdc_quarantined"] += 1
        self.stats["sdc_recovered"] += len(displaced)
        self.sdc_events.append({"t": self._now, "slot": int(slot),
                                "where": where, "displaced": displaced})
        self._sdc_trace("detect", slot=int(slot), where=where)
        self._sdc_trace("quarantine", slot=int(slot),
                        displaced=len(displaced))

    def _sdc_trace(self, kind: str, **args: Any) -> None:
        """``sdc:*`` instants on the replica's sdc track (the
        telemetry/export.sdc_events reducer reads them)."""
        tr = self._tr()
        if tr is not None:
            tr.emit("i", f"sdc:{kind}", _vns(self._now),
                    track=f"{self._trk}/sdc", args=args)

    def _capture_recompute_expect(self, victim: _Active) -> None:
        """At eviction, keep the ledger words of the victim's FULLY
        prefilled prompt pages: the recompute replay's chunk writes must
        regenerate exactly these bytes (:meth:`_stamp_prefill_pages`)."""
        exp: Dict[Tuple[int, int], int] = {}
        full = min(victim.prefill_done, victim.req.prompt_len) // self.page
        for idx in range(full):
            slot = int(self.table[victim.row, idx])
            if not slot:
                continue
            for li, pool in enumerate(self.pools):
                if pool is None:
                    continue
                crc = self.integrity.expected(li, slot)
                if crc is not None:
                    exp[(li, idx)] = crc
        if exp:
            self._recompute_expect[victim.req.rid] = exp

    def _stamp_prefill_pages(self, a: _Active, start: int,
                             end_real: int) -> None:
        """Stamp the pages a prefill chunk wrote ([start, end_real) plus
        the padded tail inside the last allocated page) and hold every
        FULLY rewritten page to its eviction-recompute expectation."""
        exp = self._recompute_expect.get(a.req.rid)
        full_end = end_real // self.page
        for idx in range(start // self.page, self._pages_for(end_real)):
            slot = int(self.table[a.row, idx])
            if not slot:
                continue
            for li, pool in enumerate(self.pools):
                if pool is None:
                    continue
                crc = self._slot_crc(li, slot)
                self.integrity.stamp(li, slot, crc)
                if exp is None or idx >= full_end:
                    continue
                want = exp.pop((li, idx), None)
                if want is None:
                    continue
                self.stats["sdc_recompute_checks"] += 1
                if crc != want:
                    # the replay did NOT regenerate the original bytes:
                    # the original write was corrupt, or re-derivation is
                    # not deterministic. Recorded as a detection, not
                    # quarantined: the fresh bytes are the re-derived truth
                    self.stats["sdc_detected"] += 1
                    self.sdc_events.append({
                        "t": self._now, "slot": slot,
                        "where": "recompute", "displaced": []})
                    self._sdc_trace("recompute_mismatch", slot=slot,
                                    layer=li, page=idx)

    def _scrub(self, rep: StepReport) -> None:
        """Budgeted background scrubber: verify up to ``cfg.scrub`` stamped
        slots a step, round-robin over the sorted stamped slots, so latent
        corruption on cold pages is caught before a hit or a ship serves
        it."""
        for _ in range(self.cfg.scrub):
            slots = self.integrity.stamped_slots()
            if not slots:
                return
            slot = slots[self._scrub_cursor % len(slots)]
            self._scrub_cursor += 1
            self.stats["sdc_scrubbed"] += 1
            self._verify_slot(slot, "scrub", rep)

    def _check_write_positions(self, hi: int) -> None:
        """The rounding table of an int8 pool covers positions
        [0, n_write_pos); a write past it raises before the pass runs."""
        if hi >= self.n_write_pos and any(
                p is not None and pool_quantized(p) for p in self.pools):
            raise ValueError(
                f"write position {hi} outside the int8 rounding table's "
                f"[0, {self.n_write_pos})")

    # -- request-lifecycle tracing (virtual time, metrics-neutral) ---------

    def _tr(self):
        """The live tracer, or None (``cfg.trace`` off, or the process
        tracer disabled)."""
        if not self.cfg.trace:
            return None
        tr = get_tracer()
        return tr if tr.enabled else None

    def _req_track(self, rid: int) -> str:
        """One Chrome-trace track per request per replica."""
        return f"{self._trk}/req{rid}"

    def _pool_event(self, name: str, **args: Any) -> None:
        """Allocator/prefix hook target: pool lifecycle instants on the
        replica's pool track, stamped at the current step's start."""
        tr = self._tr()
        if tr is not None:
            tr.emit("i", name, _vns(self._now), track=f"{self._trk}/pool",
                    args=args)

    def _trace_admit(self, a: _Active, cached: int) -> None:
        """Close the request's queue_wait span and mark the admission (and
        the recompute marker on a re-admission after eviction). Also runs
        the queue bookkeeping snapshot()'s ages use, so it is called on
        EVERY admission, traced or not."""
        rid = a.req.rid
        q0 = self._queued_at.pop(rid, self._now)
        recompute = rid in self._evicted_rids
        self._evicted_rids.discard(rid)
        tr = self._tr()
        if tr is None:
            return
        trk = self._req_track(rid)
        t_ns = _vns(self._now)
        tr.emit("X", "queue_wait", _vns(q0), t_ns - _vns(q0), track=trk,
                args={"rid": rid,
                      "reason": "recompute" if recompute else "arrival"})
        if recompute:
            tr.emit("i", "recompute", t_ns, track=trk, args={"rid": rid})
        tr.emit("i", "admit", t_ns, track=trk,
                args={"rid": rid, "row": a.row, "seq": a.admit_seq,
                      "cached_tokens": cached})

    # -- request lifecycle -------------------------------------------------

    def _pages_for(self, n_positions: int) -> int:
        """Pages that hold stream positions [0, n_positions)."""
        return (n_positions - 1) // self.page + 1 if n_positions else 0

    def _written_positions(self, req: ServeRequest) -> int:
        # prompt S + decode writes (max_new - 1): the final emitted token
        # is never fed back, so its K/V is never written
        return req.prompt_len + req.max_new - 1

    def min_service_passes(self, req: ServeRequest) -> int:
        """Lower bound on the model passes ``req`` needs end to end on an
        IDLE engine: one prefill call per chunk of the uncached prompt
        tail (the first token rides the last chunk) plus one decode pass
        per remaining token. With the prefix cache, a full page-aligned hit
        needs ``max_new`` decode passes, a partial hit prefills the tail."""
        C = self.cfg.resolved_prefill_chunk()
        S = req.prompt_len
        if self.prefix is not None:
            hit = self.prefix.match(req.prompt)
            if hit and len(hit) * self.page >= S:
                return req.max_new  # full hit: straight to decode
            cached = min(len(hit), (S - 1) // self.page) * self.page
            S -= cached
        return -(-S // C) + req.max_new - 1

    def projected_finish(self, req: ServeRequest, now: float) -> float:
        """Deterministic completion projection for admission control:
        ``now + max(congestion_delay, own_min_passes)``. The own term is
        an exact lower bound (a request hopeless even on an idle engine is
        always shed); the congestion term — token work ahead of this
        request (in flight, plus queued requests that admit before it: not
        queued batch ones when this request is interactive, not queued
        ones already past their deadline) over the per-step token budget —
        is a heuristic that may over-shed under contention, a reported
        policy choice (shed_rate; the driver's retry is the recourse)."""
        ahead = 0
        for a in self.rows:
            if a is not None:
                ahead += (a.req.prompt_len - a.prefill_done) \
                    + (a.req.max_new - len(a.out))
        for r in self.queue:
            if r.deadline is not None and now >= r.deadline:
                continue  # expires before it could consume budget
            if req.tier != "batch" and r.tier == "batch":
                continue  # this submission admits ahead of queued batch
            ahead += r.prompt_len + r.max_new
        congestion = ahead // self.cfg.resolved_token_budget()
        return now + max(congestion, self.min_service_passes(req))

    def submit(self, req: ServeRequest, now: Optional[float] = None) -> bool:
        """Enqueue ``req``; returns True when accepted. A request with a
        deadline whose projected completion (:meth:`projected_finish`)
        already misses it is SHED: recorded in ``shed`` and refused with
        False, the driver's retry policy owning what happens next.
        Deadline-free requests are always accepted."""
        if req.prompt_len < 1 or req.max_new < 1:
            raise ValueError("request needs a non-empty prompt and "
                             "max_new >= 1")
        if req.tier not in TIERS:
            raise ValueError(
                f"request {req.rid}: tier must be one of {TIERS}, got "
                f"{req.tier!r}")
        if req.prompt_len + req.max_new > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new} exceeds max_len {self.cfg.max_len}")
        if self._pages_for(self._written_positions(req)) > \
                self.allocator.capacity:
            raise ValueError(
                f"request {req.rid} can never fit the pool "
                f"({self.allocator.capacity} usable pages)")
        t0 = req.arrival if req.arrival is not None else 0.0
        if req.deadline is not None:
            t_sub = now if now is not None else t0
            if self.projected_finish(req, t_sub) > req.deadline:
                self.stats["shed"] += 1
                self.shed.append({"rid": req.rid, "t": t_sub,
                                  "deadline": req.deadline,
                                  "tier": req.tier})
                tr = self._tr()
                if tr is not None:
                    tr.emit("i", "shed", _vns(t_sub),
                            track=self._req_track(req.rid),
                            args={"rid": req.rid, "deadline": req.deadline,
                                  "tier": req.tier})
                return False
            self._has_deadlines = True
        self.queue.append(req)
        self._queued_at[req.rid] = t0
        tr = self._tr()
        if tr is not None:
            tr.emit("i", "submit", _vns(t0), track=self._req_track(req.rid),
                    args={"rid": req.rid, "prompt_len": req.prompt_len,
                          "max_new": req.max_new})
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self.rows)

    def load(self) -> int:
        """Remaining token work (queued + in flight): the least-loaded
        dispatch key."""
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
        recomputation — greedy decode and seeded sampling regenerate the
        same tokens (shared pages survive for their other holders)."""
        if self.integrity is not None:
            # before the frees drop the ledger entries: the recompute
            # replay is held to these words
            self._capture_recompute_expect(victim)
        self.allocator.free_request(victim.req.rid)
        self.table[victim.row, :] = 0
        self.rows[victim.row] = None
        self.queue.appendleft(victim.req)
        rep.evicted += 1
        self.stats["evicted"] += 1
        rid = victim.req.rid
        # batch_active = co-resident batch-tier actives the victim hunt
        # passed over: > 0 with an interactive victim would break the tier
        # preemption order
        self.evicted_log.append({
            "rid": rid, "t": self._now, "tier": victim.req.tier,
            "batch_active": sum(1 for a in self._active()
                                if a is not victim
                                and a.req.tier == "batch")})
        self._queued_at[rid] = self._now  # requeued: the wait restarts now
        self._evicted_rids.add(rid)
        tr = self._tr()
        if tr is not None:
            tr.emit("i", "evict", _vns(self._now), track=self._req_track(rid),
                    args={"rid": rid, "prefill_done": victim.prefill_done,
                          "out_tokens": len(victim.out)})

    def _evict_newest(self, rep: StepReport) -> Optional[_Active]:
        """Preemption order: BATCH-tier actives go first, newest-admitted
        first within the tier; only with no batch request in flight does
        an interactive one go (newest first, which all-interactive traffic
        reduces to)."""
        active = self._active()
        if not active:
            return None
        batch = [a for a in active if a.req.tier == "batch"]
        victim = max(batch or active, key=lambda a: a.admit_seq)
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
            # SLO tier: serve_summary's per-tier split keys on it
            "tier": a.req.tier,
        })
        rep.completed.append(a.req.rid)
        self.stats["completed"] += 1
        tr = self._tr()
        if tr is not None:
            f = self.finished[-1]
            tr.emit("i", "finish", _vns(t), track=self._req_track(a.req.rid),
                    args={"rid": a.req.rid, "n_tokens": f["n_tokens"],
                          "arrival": f["arrival"],
                          "first_token_t": f["first_token_t"],
                          "cached_tokens": f["cached_tokens"]})

    # -- deadlines: expiry cancellation (the `timeout` terminal state) -----

    def _record_timeout(self, rid: int, now: float, deadline: float,
                        state: str, out_tokens: int, tier: str,
                        rep: StepReport) -> None:
        self.timed_out.append({"rid": rid, "t": now, "deadline": deadline,
                               "state": state, "out_tokens": out_tokens,
                               "tier": tier})
        self.stats["timeouts"] += 1
        rep.timed_out.append(rid)
        self._queued_at.pop(rid, None)
        self._evicted_rids.discard(rid)
        self._cached_tokens.pop(rid, None)
        tr = self._tr()
        if tr is not None:
            tr.emit("i", "timeout", _vns(now), track=self._req_track(rid),
                    args={"rid": rid, "deadline": deadline, "state": state,
                          "out_tokens": out_tokens})

    def _cancel_expired(self, now: float, rep: StepReport) -> None:
        """Deadline enforcement at step boundaries: a request whose
        deadline has passed can no longer complete in time (this step's
        emissions stamp at ``now + cost``), so it cancels into the
        ``timeout`` terminal state — queued entries leave the queue,
        in-flight ones free every page (prefix-registered pages survive on
        the index's own references). A request that completed late in an
        earlier step stays completed."""
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = {id(r) for r in expired}  # identity, never dataclass ==
            kept = [r for r in self.queue if id(r) not in dead]
            self.queue.clear()
            self.queue.extend(kept)
            for r in expired:
                self._record_timeout(r.rid, now, r.deadline, "queued", 0,
                                     r.tier, rep)
        for a in [a for a in self._active()
                  if a.req.deadline is not None and now >= a.req.deadline]:
            self.allocator.free_request(a.req.rid)
            self.table[a.row, :] = 0
            self.rows[a.row] = None
            # static policy: a freed row ends the fill phase like a
            # completion does
            self._filling = False
            self._record_timeout(a.req.rid, now, a.req.deadline, a.state,
                                 len(a.out), a.req.tier, rep)

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
                        rep: StepReport, qi: int = 0) -> Optional[_Active]:
        """Admit a request whose WHOLE (page-aligned) prompt is cached:
        bind every cached page, copy the last one into a private slot (the
        decode pass is about to re-derive position S-1's K/V into it, and
        a write into a shared page would couple the sibling streams), and
        enter decode directly with the last prompt token pending. Zero
        prefill calls; the first output token costs one decode pass."""
        S = req.prompt_len
        nblk = S // self.page
        # trust boundary: a full hit serves these pages without any
        # recompute, so verify them first. A mismatch quarantines the slot
        # (its index entry purged, holders recovered) and the admission
        # bails; the next step's match misses the purged block
        if self.integrity is not None:
            for s in hit[:nblk]:
                if not self._verify_slot(int(s), "prefix_hit", rep):
                    return None
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
        del self.queue[qi]
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
        if self.integrity is not None:
            # the copy moves bytes verbatim: the destination inherits the
            # just-verified source's words without another fetch
            src = int(hit[nblk - 1])
            for li, pool in enumerate(self.pools):
                if pool is None:
                    continue
                crc = self.integrity.expected(li, src)
                if crc is not None:
                    self.integrity.stamp(li, priv[0], crc)
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
        self._trace_admit(a, S - 1)
        return a

    def _next_admission_index(self) -> int:
        """Queue position of the next request to admit: INTERACTIVE
        admits ahead of batch (FIFO within a tier); with no interactive
        request waiting, the head batch request goes. All-interactive
        traffic always returns 0, the FIFO order."""
        for i, r in enumerate(self.queue):
            if r.tier != "batch":
                return i
        return 0

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
        self._now = now  # mid-schedule instants (evict, pool, admit)
        # deadline expiry first: freed pages and rows are capacity this
        # very step (the scan arms once a deadlined request was accepted)
        if self._has_deadlines:
            self._cancel_expired(now, rep)
        # budgeted scrub BEFORE any pass reads the pool this step: a flip
        # on a settled page is caught ahead of the pass that would attend
        # over it (detection evicts its holders onto the recompute path)
        if self.integrity is not None and self.cfg.scrub:
            self._scrub(rep)
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
            qi = self._next_admission_index()
            req = self.queue[qi]
            hit = self.prefix.match(req.prompt) if self.prefix else []
            S = req.prompt_len
            full_hit = bool(hit) and len(hit) * self.page >= S
            if budget < (1 if full_hit else C):
                break
            if full_hit:
                if self._admit_full_hit(req, hit, rep, qi) is None:
                    break  # backpressure: not even one copy page
                budget -= 1
                continue
            # partial hit: never bind the page holding position S-1 — the
            # first-token logits need the last prompt position to run
            # through a prefill chunk anyway
            nbind = min(len(hit), (S - 1) // self.page)
            # trust boundary: verify the hit pages before binding. A
            # mismatch quarantines the slot (possibly evicting holders to
            # the queue front, which shifts qi), so admission stops for
            # this step; the next match misses the purged block
            if nbind and self.integrity is not None and not all(
                    self._verify_slot(int(s), "prefix_hit", rep)
                    for s in hit[:nbind]):
                break
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
            del self.queue[qi]
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
            self._trace_admit(a, cached if nbind else 0)
        if self.cfg.policy == "static" and (
                self._free_row() is None or not self.queue):
            self._filling = False

        # 4) price the step, then run it. A verify pass is ONE model pass,
        #    the price of the decode step it replaces
        if self.integrity is not None:
            # an admission-time check may have quarantined a shared page
            # and evicted a holder already scheduled this step: never run
            # a dead row
            prefill_calls = [a for a in prefill_calls
                             if self.rows[a.row] is a]
            decode_set = [a for a in decode_set if self.rows[a.row] is a]
            if draft_plan is not None:
                draft_plan = [p for p in draft_plan
                              if self.rows[p[0].row] is p[0]]
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

        # 6) flight recorder + counter tracks (host-only observability:
        #    nothing below feeds back into scheduling)
        self._last_t = t_end
        occ = self.allocator.occupancy()
        if self._flight is not None:
            self._flight.append({
                "step": int(self.stats["steps"]), "t": t_end, "cost": cost,
                "occupancy": occ, "free_pages": self.allocator.free_pages,
                "queue_depth": len(self.queue),
                "active": sum(1 for x in self.rows if x is not None),
                "decode_rows": len(decode_set),
                "prefill_calls": len(prefill_calls),
                "admitted": rep.admitted, "evicted": rep.evicted,
                "backpressure": rep.backpressure,
            })
        tr = self._tr()
        if tr is not None:
            t_ns = _vns(t_end)
            trk = f"{self._trk}/engine"
            B = self.cfg.resolved_token_budget()
            used = B - budget  # decode rows + admitted/continued chunks
            for cname, v in (
                    ("pool_occupancy", occ),
                    ("free_pages", float(self.allocator.free_pages)),
                    ("decode_batch_util",
                     len(decode_set) / self.cfg.max_batch),
                    ("token_budget_fill", min(1.0, max(0.0, used / B))),
                    ("prefix_hits", float(self.stats["prefix_hits"])),
                    ("shared_pages", float(self.allocator.shared_pages)),
                    ("queue_depth", float(len(self.queue))),
            ):
                tr.emit("C", f"{cname}[{self._trk}]", t_ns, track=trk,
                        args={"value": v})
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
                tr = self._tr()
                if tr is not None:
                    tr.emit("i", "draft", _vns(self._now),
                            track=self._req_track(a.req.rid),
                            args={"rid": a.req.rid,
                                  "proposed": len(drafts),
                                  "tok": len(a.out)})
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
        tr = self._tr()
        d0, d1 = _vns(self._now), _vns(t_end)
        for a, drafts, pre_pages in plan:
            y = nxt[a.row]  # y[j] = greedy token after span slot j
            emitted = [int(y[0])]  # slot 0 (the pending token) is exact
            for j in range(1, len(drafts) + 1):
                # draft j-1 sits in slot j; it was the right input iff it
                # equals the token the model emitted after slot j-1
                if int(drafts[j - 1]) != emitted[j - 1]:
                    break
                emitted.append(int(y[j]))
            accepted = len(emitted) - 1
            self.stats["spec_accepted"] += accepted
            self.stats["decode_tokens"] += len(emitted)
            if self.integrity is not None:
                # the span write touched every allocated page under
                # [pos0, pos0 + W): stamp them (rejected-tail bytes are
                # real device state too) before completion or rollback
                # can free any of them
                p0 = int(pos0[a.row]) // self.page
                p1 = min(a.n_pages,
                         (int(pos0[a.row]) + W - 1) // self.page + 1)
                for idx in range(p0, p1):
                    slot = int(self.table[a.row, idx])
                    if slot:
                        self._stamp_slot(slot)
            if tr is not None:
                trk = self._req_track(a.req.rid)
                tr.emit("X", "verify", d0, d1 - d0, track=trk,
                        args={"rid": a.req.rid, "tok": len(a.out),
                              "pos": int(a.decode_pos),
                              "drafted": len(drafts),
                              "emitted": len(emitted),
                              "step": int(self.stats["steps"])})
                tr.emit("i", "accept", d1, track=trk,
                        args={"rid": a.req.rid, "accepted": accepted,
                              "drafted": len(drafts)})
            first = a.first_token_t is None
            for tok in emitted:
                a.out.append(tok)
                a.token_times.append(t_end)
            if first:
                # a full-hit admission's first token comes from this pass
                a.first_token_t = t_end
                if tr is not None:
                    tr.emit("i", "first_token", d1,
                            track=self._req_track(a.req.rid),
                            args={"rid": a.req.rid, "t": t_end})
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
        nxt = self._prefill_pass(self.table[a.row:a.row + 1], chunk, start,
                                 want, npl)
        self.wall["prefill_s"] += time.perf_counter() - t0
        a.prefill_done = end_real
        if self.integrity is not None:
            self._stamp_prefill_pages(a, start, end_real)
        rep.prefill_calls += 1
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += end_real - start
        tr = self._tr()
        if tr is not None:
            # the span covers the whole step window [now, t_end): in the
            # virtual cost model the request is being prefilled for the
            # step it is packed into
            tr.emit("X", "prefill_chunk", _vns(self._now),
                    _vns(t_end) - _vns(self._now),
                    track=self._req_track(a.req.rid),
                    args={"rid": a.req.rid, "chunk": start // max(C, 1),
                          "start": start, "tokens": end_real - start,
                          "cached_tokens":
                              self._cached_tokens.get(a.req.rid, 0),
                          "step": int(self.stats["steps"])})
        if self.prefix is not None:
            # register newly completed prompt pages (every position prompt
            # content, never written again)
            for b in range(a.registered_blocks, end_real // self.page):
                self.prefix.register(a.req.prompt, b,
                                     int(self.table[a.row, b]))
            a.registered_blocks = max(a.registered_blocks,
                                      end_real // self.page)
        if last:
            tok = self._emit_token(nxt, a.req.rid, len(a.out))
            a.out.append(tok)
            a.token_times.append(t_end)
            a.first_token_t = t_end
            if tr is not None:
                tr.emit("i", "first_token", _vns(t_end),
                        track=self._req_track(a.req.rid),
                        args={"rid": a.req.rid, "t": t_end})
            if len(a.out) >= a.req.max_new:
                self._complete(a, t_end, rep)
            else:
                a.state = "decode"
                a.pending_tok = tok

    def _run_decode(self, decode_set: List[_Active], t_end: float,
                    rep: StepReport) -> None:
        assert all(self.rows[a.row] is a for a in decode_set), \
            "scheduled a dead (evicted) row"
        tr = self._tr()
        if tr is not None:
            # one span per participating request over the step window;
            # `tok` is the index of the token this pass emits, so
            # serveview can rebuild per-token times
            d0, d1 = _vns(self._now), _vns(t_end)
            for a in decode_set:
                tr.emit("X", "decode", d0, d1 - d0,
                        track=self._req_track(a.req.rid),
                        args={"rid": a.req.rid, "tok": len(a.out),
                              "pos": int(a.decode_pos),
                              "step": int(self.stats["steps"])})
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
        if self.integrity is not None:
            # stamp each row's written page from the saved positions,
            # before the emission loop can complete (and free) a request
            for a in decode_set:
                slot = int(self.table[a.row, pos[a.row] // self.page])
                if slot:
                    self._stamp_slot(slot)
        rep.decode_rows = len(decode_set)
        self.stats["decode_calls"] += 1
        self.stats["decode_row_slots"] += len(decode_set)
        self.stats["decode_tokens"] += len(decode_set)
        for a in decode_set:
            tok = self._emit_token(nxt[a.row], a.req.rid, len(a.out))
            a.out.append(tok)
            a.token_times.append(t_end)
            if a.first_token_t is None:
                # a full-hit admission skips prefill: its first token
                # comes from this decode pass
                a.first_token_t = t_end
                if tr is not None:
                    tr.emit("i", "first_token", _vns(t_end),
                            track=self._req_track(a.req.rid),
                            args={"rid": a.req.rid, "t": t_end})
            if len(a.out) >= a.req.max_new:
                self._complete(a, t_end, rep)
            else:
                a.pending_tok = tok

    def drain(self, now: float = 0.0):
        """Retire this replica under live load (a resize's scale-down, a
        heartbeat drain): every in-flight request is EVICTED onto the
        recompute path, oldest-admitted first (pages freed; its tokens
        regenerate identically on whichever replica re-admits it), and the
        whole queue is handed back for least-loaded redistribution.
        Finished records stay on the engine, which the server keeps among
        its retired engines. Returns ``(requests, evicted_count,
        handoff)``: ``handoff[rid] = (queued_at, evicted)`` lets the
        receiving engine keep the queue-wait baseline and the recompute
        marker."""
        self._now = now
        rep = StepReport()
        for a in sorted(self._active(), key=lambda x: x.admit_seq):
            if self.rows[a.row] is a:
                self._evict(a, rep)
        reqs = list(self.queue)
        self.queue.clear()
        handoff = {r.rid: (self._queued_at.get(r.rid, now),
                           r.rid in self._evicted_rids) for r in reqs}
        self._queued_at.clear()
        return reqs, rep.evicted, handoff

    # -- cross-engine page shipping (serve/handoff.py) ---------------------

    @torch.no_grad()
    def fetch_pages(self, slots: List[int]) -> List[Optional[Dict[str,
                                                                  Any]]]:
        """Device-to-host copy of the given pool slots: payload and scale
        sidecar rows (bfloat16 as its int16 bytes), one dict per serving
        layer (None for layers with no pool); at tp > 1 the [tp, ...]
        stacked rows, so the whole head width ships. The layer's
        ``kv_seed`` and rounding table never ship: they are the layer's
        own and the same on every engine of the model, which is what
        makes re-quantisation after a decode-fleet failover bitwise."""
        out: List[Optional[Dict[str, Any]]] = []
        for pool in self.pools:
            if pool is None:
                out.append(None)
                continue
            idx = torch.tensor(slots, dtype=torch.long,
                               device=pool["pool_k"].device)
            out.append({k: host_rows(pool[k][slot_index(k, pool[k], idx)])
                        for k in pool_checksum_keys(pool)})
        return out

    @torch.no_grad()
    def write_pages(self, slots: List[int], pages) -> None:
        """Host-to-device import of :meth:`fetch_pages` rows into this
        engine's pool at ``slots`` (the importer's own allocator grants),
        in place. The bytes land verbatim: int8 payload and float32 scale
        sidecars are bit-identical to the exporter's, so later decode
        reads match the aggregated engine exactly."""
        for pool, rows in zip(self.pools, pages):
            if pool is None:
                continue
            idx = torch.tensor(slots, dtype=torch.long,
                               device=pool["pool_k"].device)
            for k, v in rows.items():
                dst = pool[k]
                t = torch.from_numpy(np.ascontiguousarray(v)).to(dst.device)
                dst[slot_index(k, dst, idx)] = t.view(dst.dtype)

    def extract_request(self, rid: int) -> Optional[Dict[str, Any]]:
        """Pop an in-flight DECODE-state request off this engine for
        shipping: copy its table-row pages to the host
        (:meth:`fetch_pages`), then free the row and its page references
        (prefix-registered blocks survive on the index's own references,
        as on eviction). Returns the ship :meth:`import_request` takes.
        Extraction is not a terminal state: nothing lands in ``finished``.

        With integrity on, export is a trust boundary: every page is
        verified against the ledger BEFORE it can ship. A mismatch
        quarantines the slot, which evicts this very request onto the
        local recompute path, and returns None: corrupt bytes never leave
        the engine. Clean ships carry per-(layer, page) ``checksums`` the
        importer re-verifies and stamps from."""
        a = next((x for x in self._active() if x.req.rid == rid), None)
        if a is None or a.state != "decode":
            raise ValueError(
                f"extract_request: rid {rid} is not an in-flight decode "
                "request")
        slots = [int(s) for s in self.table[a.row, :a.n_pages]]
        if self.integrity is not None:
            for s in slots:
                if not self._verify_slot(s, "export"):
                    return None  # quarantined and evicted: nothing ships
        ship = {
            "rid": rid, "req": a.req, "out": list(a.out),
            "token_times": list(a.token_times),
            "first_token_t": a.first_token_t,
            "pending_tok": a.pending_tok,
            "prefill_done": a.prefill_done,
            "n_pages": a.n_pages,
            "cached_tokens": self._cached_tokens.pop(rid, 0),
            "pages": self.fetch_pages(slots),
        }
        if self.integrity is not None:
            # wire words straight from the just-verified ledger: one per
            # (layer, page); None for poolless layers and for partial
            # tail pages not stamped yet
            ship["checksums"] = [
                None if pool is None else
                [self.integrity.expected(li, s) for s in slots]
                for li, pool in enumerate(self.pools)]
        self.allocator.free_request(rid)
        self.table[a.row, :] = 0
        self.rows[a.row] = None
        self._queued_at.pop(rid, None)
        self._evicted_rids.discard(rid)
        return ship

    def import_request(self, ship: Dict[str, Any], now: float) -> bool:
        """Bind a shipped request's pages into this engine and resume it
        mid-stream in decode state. All or nothing: returns False (engine
        unchanged) when there is no free row or not enough free pages, or
        when the ship fails its checksums; the caller parks the ship and
        retries next step. The imported request joins the admission order
        at the tail, like any admission."""
        row = self._free_row()
        if row is None:
            return False
        req: ServeRequest = ship["req"]
        if self.integrity is not None and \
                ship.get("checksums") is not None:
            # trust boundary: re-checksum the ship's host bytes against the
            # exporter's words BEFORE any allocation or pool write
            self._now = now
            calc = ship_checksums(ship["pages"])
            for li, want in enumerate(ship["checksums"]):
                if want is None:
                    continue
                for p, w in enumerate(want):
                    if w is not None and w != calc[li][p]:
                        self.stats["sdc_detected"] += 1
                        self._sdc_trace("ship_reject", rid=req.rid,
                                        layer=li, page=p)
                        return False
        slots = self._alloc(req.rid, ship["n_pages"])
        if slots is None:
            return False
        self._now = now
        self.write_pages(slots, ship["pages"])
        if self.integrity is not None and \
                ship.get("checksums") is not None:
            # the scatter is verbatim: the destination slots inherit the
            # ship's verified words without a fresh device fetch
            for li, want in enumerate(ship["checksums"]):
                if want is None:
                    continue
                for p, w in enumerate(want):
                    if w is not None:
                        self.integrity.stamp(li, slots[p], w)
        a = _Active(req=req, row=row, admit_seq=self._admit_seq)
        self._admit_seq += 1
        a.state = "decode"
        a.prefill_done = ship["prefill_done"]
        a.n_pages = ship["n_pages"]
        a.pending_tok = ship["pending_tok"]
        a.out = list(ship["out"])
        a.token_times = list(ship["token_times"])
        a.first_token_t = ship["first_token_t"]
        self.table[row, :] = 0
        self.table[row, :a.n_pages] = slots
        self.rows[row] = a
        if ship["cached_tokens"]:
            self._cached_tokens[req.rid] = ship["cached_tokens"]
        if req.deadline is not None:
            self._has_deadlines = True
        self.stats["admitted"] += 1
        self._trace_admit(a, ship["cached_tokens"])
        return True

    def release_pools(self) -> None:
        """Drop a retired engine's KV pools, so their device memory goes
        back to the allocator: the replicas of a fleet share one card,
        and the fleet's ``pool_bytes`` counts the live engines only. The
        engine keeps its records and counters, and is never stepped
        again."""
        self.pools = [None] * len(self.pools)

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

    def snapshot(self) -> Dict[str, Any]:
        """Live state of this replica, host work only (no device traffic):
        occupancy, queue depth, per-request ages at the engine's virtual
        clock, SLO attainment so far (``cfg.slo_ttft``/``slo_itl``; 0 = no
        SLO) and the ring of recent per-step states."""
        now = self._last_t
        reqs: List[Dict[str, Any]] = []
        for a in sorted(self._active(), key=lambda x: x.admit_seq):
            reqs.append({
                "rid": a.req.rid, "state": a.state,
                "age": now - (a.req.arrival if a.req.arrival is not None
                              else 0.0),
                "prefill_done": a.prefill_done,
                "out_tokens": len(a.out), "pages": a.n_pages,
            })
        for r in self.queue:
            # queued age = time since (re)enqueue: the arrival, or for a
            # requeued victim its current wait (the queue_wait span's)
            q0 = self._queued_at.get(
                r.rid, r.arrival if r.arrival is not None else 0.0)
            reqs.append({
                "rid": r.rid, "state": "queued", "age": now - q0,
                "prefill_done": 0, "out_tokens": 0, "pages": 0,
            })
        slo_t = self.cfg.slo_ttft or None
        slo_i = self.cfg.slo_itl or None
        ok = sum(1 for f in self.finished
                 if request_slo_ok(f, slo_t, slo_i))
        return {
            "t": now, "replica": self.replica,
            "occupancy": self.allocator.occupancy(),
            "free_pages": self.allocator.free_pages,
            "shared_pages": self.allocator.shared_pages,
            "queue_depth": len(self.queue),
            "active": len(self._active()),
            "completed": len(self.finished),
            "evicted": int(self.stats["evicted"]),
            "slo_attainment": ok / len(self.finished)
            if self.finished else 0.0,
            "requests": reqs,
            "recent_steps": (list(self._flight)
                             if self._flight is not None else []),
        }




class ReplicatedServer:
    """N independent replicas with a least-loaded dispatcher. Replicas step
    in lockstep; a global step costs the maximum of the replicas' costs
    (they run in parallel in virtual time; on the card the port runs them
    one after another on one device).

    LIVE RESIZE (:meth:`resize`): scale-down drains the highest-index
    replicas — in-flight requests are evicted onto the recompute path and
    the drained queues redistribute least-loaded over the survivors — so
    no request is lost and the token streams stay those of an un-resized
    run (greedy and seeded sampling are pure functions of (weights,
    prompt, rid, token index)). Scale-up spawns replicas through the
    ``engine_factory`` :func:`make_server` installs, sharing the one model.
    Drained engines are retired, not discarded: their finished records and
    counters stay in ``finished`` and ``stats_summary``.

    CHAOS: :meth:`fail` hard-kills a replica (its pool is lost, its
    requests fail over), :meth:`stall` makes one stop progressing, and
    with ``cfg.heartbeat > 0`` a replica that holds work without progress
    for longer than the window is drained like a scale-down.
    """

    def __init__(self, engines: List[ServeEngine], engine_factory=None):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        self._factory = engine_factory
        self._retired: List[ServeEngine] = []
        self._next_replica = len(engines)
        # (t, from, to, evicted, redistributed, shed)
        self.resize_events: List[Dict[str, Any]] = []
        # chaos ledgers: hard kills, injected stalls and heartbeat drains
        self.fail_events: List[Dict[str, Any]] = []
        self.stall_events: List[Dict[str, Any]] = []
        self.heartbeat_events: List[Dict[str, Any]] = []

    @property
    def retired(self) -> List[ServeEngine]:
        """Engines drained, failed or resized away, in retirement order."""
        return list(self._retired)

    def _retire(self, eng: ServeEngine) -> None:
        eng.release_pools()
        self._retired.append(eng)

    def _least_loaded(self) -> ServeEngine:
        return min(enumerate(self.engines), key=lambda ie: (ie[1].load(),
                                                            ie[0]))[1]

    def _dispatch(self, req: ServeRequest,
                  now: Optional[float] = None) -> Optional[ServeEngine]:
        """Fleet dispatch returning the ACCEPTING engine (None = shed).
        For a DEADLINED request the fleet sheds only when NO replica
        projects the deadline as makeable: replicas are probed in (load,
        index) order and the first whose projection fits takes the
        request; if none fits, the least-loaded replica records the ONE
        shed. Deadline-free requests go straight to the least-loaded
        replica. Every fleet-side submission (driver traffic and the
        resubmissions of fail, the heartbeat drain and resize) routes
        through here."""
        if req.deadline is not None:
            order = sorted(enumerate(self.engines),
                           key=lambda ie: (ie[1].load(), ie[0]))
            t_sub = now if now is not None else (
                req.arrival if req.arrival is not None else 0.0)
            for _, e in order:
                if e.projected_finish(req, t_sub) <= req.deadline:
                    return e if e.submit(req, now=now) else None
            order[0][1].submit(req, now=now)  # records the one shed
            return None
        e = self._least_loaded()
        return e if e.submit(req, now=now) else None

    def submit(self, req: ServeRequest, now: Optional[float] = None) -> bool:
        """Least-loaded dispatch with the fleet-wide deadline probe
        (:meth:`_dispatch`): False means the request was SHED."""
        return self._dispatch(req, now=now) is not None

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def step(self, now: float = 0.0) -> StepReport:
        rep = StepReport()
        stalled_work = False
        progressed: List[ServeEngine] = []
        for e in self.engines:
            if e._stall_ticks > 0:
                # straggler injection: the replica holds its requests but
                # schedules nothing this global step, and its monitor is
                # NOT kicked
                e._stall_ticks -= 1
                stalled_work = stalled_work or e.has_work()
                continue
            if e.has_work():
                rep.merge(e.step(now))
            progressed.append(e)
        if rep.cost == 0 and stalled_work:
            # every replica holding work is stalled: the fleet still burns
            # a virtual time unit, or the clock would freeze and the
            # heartbeat could never fire
            rep.cost = 1
        t_end = now + rep.cost
        for e in progressed:
            if e.monitor is not None:
                # scheduled (or idle: an empty replica is healthy) counts
                # as progress as of the step's END, where expiry is judged
                e.monitor.kick(t_end)
        if self.engines[0].cfg.heartbeat > 0:
            for e in [x for x in self.engines
                      if x.monitor is not None and x.has_work()
                      and x.monitor.expired(t_end)]:
                if len(self.engines) == 1:
                    break  # no survivor to redistribute onto
                self._drain_straggler(e, t_end)
        return rep

    # -- serving-fleet chaos: hard kill, straggler stall, heartbeat --------

    def fail(self, replica: int, now: float = 0.0,
             dispatch=None) -> Dict[str, Any]:
        """HARD-KILL the replica at fleet index ``replica``: the engine is
        discarded with its pool (all resident KV, prefix cache included),
        and only host state survives. Its finished records are SALVAGED
        (the engine retires into the summary), and every request it still
        held is RESUBMITTED through the dispatcher onto the survivors:
        in-flight requests oldest-admitted first, then the queue in order.
        The recompute path regenerates their streams from scratch. A
        resubmission the survivors shed by deadline is counted in the
        event's ``shed_on_failover``. ``dispatch`` overrides where the
        displaced requests go."""
        if not 0 <= replica < len(self.engines):
            raise IndexError(
                f"fail: no replica at fleet index {replica} "
                f"(fleet size {len(self.engines)})")
        if len(self.engines) == 1 and dispatch is None:
            raise ValueError(
                "cannot fail the last replica — no survivor to fail over "
                "to (the fleet analog of losing the whole pod)")
        eng = self.engines.pop(replica)
        inflight = sorted(eng._active(), key=lambda a: a.admit_seq)
        queued = list(eng.queue)
        # queued requests' wait baselines and recompute markers are host
        # state and survive the kill (drain()'s handoff convention)
        handoff = {r.rid: (eng._queued_at.get(r.rid, now),
                           r.rid in eng._evicted_rids) for r in queued}
        # the engine is dead: clear its live bookkeeping (its pool is
        # garbage with it) but keep its finished records and counters
        eng.queue.clear()
        for a in inflight:
            eng.rows[a.row] = None
        eng._queued_at.clear()
        eng._evicted_rids.clear()
        eng._cached_tokens.clear()
        eng._stall_ticks = 0
        self._retire(eng)
        resubmitted = shed_n = 0
        dispatch = dispatch if dispatch is not None else self._dispatch
        moves = [(a.req, True) for a in inflight] \
            + [(r, False) for r in queued]
        for r, was_active in moves:
            tgt = dispatch(r, now=now)
            if tgt is not None:
                resubmitted += 1
                if was_active:
                    # the failover is the eviction analog: the wait
                    # restarts at the kill, the re-admission is a recompute
                    tgt._queued_at[r.rid] = now
                    tgt._evicted_rids.add(r.rid)
                else:
                    q0, was_evicted = handoff[r.rid]
                    tgt._queued_at[r.rid] = q0
                    if was_evicted:
                        tgt._evicted_rids.add(r.rid)
            else:
                shed_n += 1
        ev = {"t": now, "replica_id": eng.replica, "fleet_index": replica,
              "salvaged": len(eng.finished),
              "displaced_inflight": [a.req.rid for a in inflight],
              "displaced_queued": len(queued),
              "resubmitted": resubmitted, "shed_on_failover": shed_n}
        self.fail_events.append(ev)
        return ev

    def stall(self, replica: int, ticks: int, now: float = 0.0) -> None:
        """Inject a STRAGGLER: the replica at fleet index ``replica`` makes
        no progress for ``ticks`` global steps while holding its requests.
        With ``cfg.heartbeat > 0`` the no-progress detector drains it
        within the window; without, the stall just delays its requests."""
        if not 0 <= replica < len(self.engines):
            raise IndexError(
                f"stall: no replica at fleet index {replica} "
                f"(fleet size {len(self.engines)})")
        if ticks < 1:
            raise ValueError(f"stall needs ticks >= 1, got {ticks}")
        eng = self.engines[replica]
        eng._stall_ticks = ticks
        self.stall_events.append({"t": now, "replica_id": eng.replica,
                                  "fleet_index": replica, "ticks": ticks})

    def _drain_straggler(self, eng: ServeEngine, now: float) -> None:
        """Heartbeat verdict: drain a no-progress replica like a
        scale-down (unlike :meth:`fail`, its host state is intact, so its
        pages free cleanly) and retire it with its records."""
        idx = self.engines.index(eng)
        self.engines.remove(eng)
        reqs, evicted, handoff = eng.drain(now)
        self._retire(eng)
        shed_n = 0
        for r in reqs:
            tgt = self._dispatch(r, now=now)
            if tgt is not None:
                q0, was_evicted = handoff[r.rid]
                tgt._queued_at[r.rid] = q0
                if was_evicted:
                    tgt._evicted_rids.add(r.rid)
            else:
                shed_n += 1
        self.heartbeat_events.append({
            "t": now, "replica_id": eng.replica, "fleet_index": idx,
            "stalled_for": eng.monitor.stalled_for(now),
            "evicted": evicted, "redistributed": len(reqs) - shed_n,
            "shed": shed_n})

    def resize(self, n: int, now: float = 0.0) -> Dict[str, Any]:
        """Scale the live fleet to ``n`` replicas under load. Scale-down
        drains the highest-index replicas first and resubmits every
        displaced request through the dispatcher; scale-up appends
        factory-built replicas. Returns the event's report."""
        if n < 1:
            raise ValueError(f"resize needs >= 1 replica, got {n}")
        before = len(self.engines)
        drained: List[ServeEngine] = []
        while len(self.engines) > n:
            drained.append(self.engines.pop())
        reqs: List[ServeRequest] = []
        evicted = 0
        handoff: Dict[int, Any] = {}
        # drain in ascending replica order for a deterministic resubmit
        # sequence; within one engine the evicted actives come newest-first
        # (the eviction requeue stacks them at the queue's front), then
        # the waiting queue in order
        for eng in reversed(drained):
            r, ev, h = eng.drain(now)
            reqs.extend(r)
            evicted += ev
            handoff.update(h)
        for eng in reversed(drained):
            self._retire(eng)
        shed_n = 0
        for r in reqs:
            eng = self._dispatch(r, now=now)
            if eng is None:
                shed_n += 1  # deadline admission control shed the move
                continue
            # keep the queue-wait baseline and the recompute marker across
            # the replica move
            q0, was_evicted = handoff[r.rid]
            eng._queued_at[r.rid] = q0
            if was_evicted:
                eng._evicted_rids.add(r.rid)
        while len(self.engines) < n:
            if self._factory is None:
                raise RuntimeError(
                    "resize: scale-up needs the engine factory make_server "
                    "installs (this server was built from bare engines)")
            # replica ids grow monotonically (unique trace tracks)
            eng = self._factory(self._next_replica, n, len(self.engines))
            if eng.monitor is not None:
                # the heartbeat baseline starts at the grow instant, not 0
                eng.monitor.kick(now)
            self.engines.append(eng)
            self._next_replica += 1
        report = {"t": now, "from": before, "to": n, "evicted": evicted,
                  "redistributed": len(reqs) - shed_n, "shed": shed_n}
        self.resize_events.append(report)
        return report

    @property
    def finished(self) -> List[Dict[str, Any]]:
        out = []
        for e in self.engines + self._retired:
            out.extend(e.finished)
        return out

    @property
    def timed_out(self) -> List[Dict[str, Any]]:
        """Every ``timeout`` terminal record across the fleet, retired
        replicas included."""
        out = []
        for e in self.engines + self._retired:
            out.extend(e.timed_out)
        return out

    @property
    def shed_records(self) -> List[Dict[str, Any]]:
        """Every ``shed`` admission rejection across the fleet."""
        out = []
        for e in self.engines + self._retired:
            out.extend(e.shed)
        return out

    @property
    def sdc_events(self) -> List[Dict[str, Any]]:
        """Every SDC detection/quarantine record across the fleet
        (retired replicas included), time-ordered."""
        out = []
        for e in self.engines + self._retired:
            out.extend(e.sdc_events)
        return sorted(out, key=lambda ev: ev["t"])

    def snapshot(self) -> Dict[str, Any]:
        """Fleet snapshot: the replicas' snapshots plus the aggregates a
        dispatcher or autoscaler reads — total queue depth and active
        count, the WORST replica's occupancy, and fleet-wide SLO
        attainment so far."""
        snaps = [e.snapshot() for e in self.engines]
        fin = self.finished
        slo_t = self.engines[0].cfg.slo_ttft or None
        slo_i = self.engines[0].cfg.slo_itl or None
        ok = sum(1 for f in fin if request_slo_ok(f, slo_t, slo_i))
        return {
            "t": max(s["t"] for s in snaps),
            "replicas": snaps,
            "queue_depth": sum(s["queue_depth"] for s in snaps),
            "active": sum(s["active"] for s in snaps),
            "completed": len(fin),
            "occupancy": max(s["occupancy"] for s in snaps),
            "slo_attainment": ok / len(fin) if fin else 0.0,
        }

    def stats_summary(self) -> Dict[str, float]:
        return fleet_stats(self.engines, self._retired)


def fleet_stats(live: List[ServeEngine],
                retired: List[ServeEngine]) -> Dict[str, float]:
    """Fleet-wide summary over live and retired engines: counters add up,
    ``decode_batch_util`` and ``mean_page_fragmentation`` are averaged,
    the peaks take the maximum, ``pool_bytes`` counts the live fleet's
    pools only (a retired engine's pool is released with it), and the
    rates are re-derived from the summed counters."""
    sums: Dict[str, float] = {}
    fleet = live + retired  # resize and failure never lose counters
    for e in fleet:
        for k, v in e.stats_summary().items():
            sums[k] = sums.get(k, 0) + v
    for k in ("decode_batch_util", "mean_page_fragmentation"):
        sums[k] /= len(fleet)
    sums["peak_occupancy"] = max(
        e.stats["peak_occupancy"] for e in fleet)
    sums["shared_pages"] = max(
        e.stats["shared_pages"] for e in fleet)
    sums["bytes_per_page"] = fleet[0].bytes_per_page
    sums["pool_bytes"] = sum(
        e.bytes_per_page * e.cfg.pool_pages for e in live)
    row_passes = sum(e.stats["decode_row_slots"] for e in fleet)
    sums["spec_accept_rate"] = (
        sums["spec_accepted"] / sums["spec_drafted"]
        if sums["spec_drafted"] else 0.0)
    sums["tokens_per_pass"] = (
        sums["decode_tokens"] / row_passes if row_passes else 0.0)
    return sums


def make_server(model: LayerModel, cfg: ServeConfig,
                device: torch.device) -> ReplicatedServer:
    """A server of ``cfg.replicas`` replicas for ``model`` (already on
    ``device``). Every replica is built on ``device`` and shares ``model``:
    the weights live there once, and each replica adds only its KV pool.
    The server carries an ENGINE FACTORY so ``resize`` (and the
    autoscaler's repairs) can grow the fleet under live load the same
    way."""
    cfg.validate()
    rep_cfg = cfg.replace(replicas=1)

    def factory(replica: int, fleet_size: int, slot: int) -> ServeEngine:
        return ServeEngine(model, rep_cfg, device, replica=replica)

    return ReplicatedServer([factory(i, cfg.replicas, i)
                             for i in range(cfg.replicas)],
                            engine_factory=factory)
