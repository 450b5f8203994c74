"""Hierarchical pipeline partitioner of the port (the reference's
``partition/optimizer.py``, whose choices it makes exactly on the same
graph and constants).

A dynamic program that, given per-layer profiled compute times and sizes,
chooses contiguous pipeline stages and per-stage data-parallel
replication minimizing the steady-state pipeline bottleneck, solved per
interconnect level (NVLink within a host, then the network across hosts:
:class:`HardwareModel`'s ``ici``/``dcn`` fields), the lower level's
solutions becoming the upper level's compute times. The C++ core
(native/partitioner.cpp, bound by partition/native.py) solves each level
when it builds; otherwise the Python DP below does, after saying why
(PartitionResult.core names the one that ran).

Cost model:
* stage compute: sum of layer fwd+bwd times / replication r
* intra-stage DP sync: ring allreduce, 2 (r-1)/r * param_bytes / bandwidth
* inter-stage edge: boundary activation bytes / bandwidth (both per minibatch)
* memory: (1 + versions) * param_bytes <= hbm_bytes, versions bounded by
  the machine count at the level (weight stashing keeps <= num_stages
  versions)

Models here are chains, or branchy DAGs chainized at node granularity
(profiler/profile.packed_chain_graph), so the DP runs over the
topological node order directly.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ddlbench_tpu_torch.config import HardwareModel
from ddlbench_tpu_torch.graph.graph import Graph, Node

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class StagePlan:
    start: int  # node index span [start, end)
    end: int
    replication: int  # chips running this stage data-parallel

    @property
    def num_chips(self) -> int:
        return self.replication


@dataclasses.dataclass
class PartitionResult:
    stages: List[StagePlan]
    pipeline_time_ms: float  # bottleneck (steady-state time per minibatch)
    num_chips_used: int
    core: str = "python"  # which DP solved it: "c++" or "python"

    def stage_bounds(self) -> List[int]:
        return [self.stages[0].start] + [s.end for s in self.stages]

    def replication_map(self) -> Dict[int, int]:
        return {i: s.replication for i, s in enumerate(self.stages)}


def _ms(bytes_: float, bandwidth: float) -> float:
    return 1000.0 * bytes_ / bandwidth if bandwidth > 0 else 0.0


def _allreduce_ms(param_bytes: float, r: int, bandwidth: float) -> float:
    if r <= 1:
        return 0.0
    return _ms(2.0 * (r - 1) / r * param_bytes, bandwidth)


class _LevelDP:
    """One level of the hierarchical DP over a chain of n nodes and m units."""

    def __init__(self, n: int, max_units: int):
        self.n = n
        self.max_units = max_units
        # A[(i, j, m)] = (time, choice); choice is None for a single
        # (replicated) stage or (k, m_last) for a split.
        self.A: Dict[Tuple[int, int, int], Tuple[float, Optional[Tuple[int, int]]]] = {}

    def solve(self, stage_cost, edge_cost):
        n, M = self.n, self.max_units
        for j in range(1, n + 1):
            for i in range(j - 1, -1, -1):
                for m in range(1, M + 1):
                    best = (stage_cost(i, j, m), None)
                    for m_last in range(1, m):
                        last = None
                        for k in range(i + 1, j):
                            t_last = stage_cost(k, j, m_last)
                            t_rest = self.A[(i, k, m - m_last)][0]
                            t = max(t_rest, edge_cost(k), t_last)
                            if t < best[0]:
                                best = (t, (k, m_last))
                    self.A[(i, j, m)] = best
        return self.A

    def backtrack(self, i: int, j: int, m: int) -> List[Tuple[int, int, int]]:
        """Return [(start, end, units)] stage spans for span (i, j] on m units."""
        time, choice = self.A[(i, j, m)]
        if choice is None:
            return [(i, j, m)]
        k, m_last = choice
        return self.backtrack(i, k, m - m_last) + [(k, j, m_last)]


def partition_hierarchical(
    graph: Graph,
    num_chips: int,
    hw: Optional[HardwareModel] = None,
    num_hosts: int = 1,
    memory_check: bool = True,
    use_native: bool = True,
    forward_only: bool = False,
) -> PartitionResult:
    """Partition a (chain) profile graph over num_chips, optionally across hosts.

    Level 0: chips within a host/slice over ICI; level 1 (if num_hosts > 1):
    hosts over DCN. With use_native (default), the DP levels run in the C++
    core (native/partitioner.cpp via ctypes) when it is buildable, falling
    back to this module's pure-Python DP otherwise; both implement the same
    recurrence and cost model.

    ``forward_only=True`` is the inference variant (reference
    optimizer/inference_optimizer_graph.py, SURVEY.md §2 C6): only forward
    compute times count, replication pays no gradient allreduce, and memory
    holds one weight copy (no stashing versions).
    """
    hw = hw or HardwareModel()
    if use_native:
        from ddlbench_tpu_torch.partition import native

        if native.available():
            return _partition_native(graph, num_chips, hw, num_hosts,
                                     memory_check, forward_only)
        print(f"partitioner: the C++ core did not build "
              f"({native.build_error()}); solving with the Python DP",
              file=sys.stderr, flush=True)
    order = graph.topological_sort()
    n = len(order)
    times = [
        nd.forward_compute_time
        + (0.0 if forward_only else nd.backward_compute_time)
        for nd in order
    ]
    params = [nd.parameter_size for nd in order]
    acts = [nd.activation_size for nd in order]
    pre_t = [0.0]
    pre_p = [0.0]
    for t, p in zip(times, params):
        pre_t.append(pre_t[-1] + t)
        pre_p.append(pre_p[-1] + p)

    if num_hosts > 1:
        if num_chips % num_hosts:
            raise ValueError("num_chips must divide evenly across hosts")
        chips_per_host = num_chips // num_hosts
    else:
        chips_per_host = num_chips

    def span_time(i, j):
        return pre_t[j] - pre_t[i]

    def span_params(i, j):
        return pre_p[j] - pre_p[i]

    def mem_ok(i, j, r, versions_bound):
        if not memory_check:
            return True
        # DP replication copies the full stage parameters onto every replica
        # (it shards the batch, not the weights), so r does not divide memory.
        need = (1 + versions_bound) * span_params(i, j)
        return need <= hw.hbm_bytes

    versions0 = 0 if forward_only else chips_per_host

    # ---- level 0: chips over ICI ----
    def stage_cost0(i, j, r):
        if not mem_ok(i, j, r, versions_bound=versions0):
            return INF
        t = span_time(i, j) / r
        if forward_only:
            return t
        return t + _allreduce_ms(span_params(i, j), r, hw.ici_bandwidth)

    def edge_cost0(k):
        return _ms(acts[k - 1], hw.ici_bandwidth)

    dp0 = _LevelDP(n, chips_per_host)
    dp0.solve(stage_cost0, edge_cost0)

    if num_hosts == 1:
        spans = dp0.backtrack(0, n, chips_per_host)
        stages = [StagePlan(i, j, r) for i, j, r in spans]
        time = dp0.A[(0, n, chips_per_host)][0]
        return PartitionResult(stages, time, sum(s.replication for s in stages))

    # ---- level 1: hosts over DCN; a "unit" is one full host ----
    def stage_cost1(i, j, r):
        base = dp0.A[(i, j, chips_per_host)][0]
        if base == INF:
            return INF
        t = base / r
        if forward_only:
            return t
        return t + _allreduce_ms(span_params(i, j), r, hw.dcn_bandwidth)

    def edge_cost1(k):
        return _ms(acts[k - 1], hw.dcn_bandwidth)

    dp1 = _LevelDP(n, num_hosts)
    dp1.solve(stage_cost1, edge_cost1)

    stages: List[StagePlan] = []
    for (i, j, r_hosts) in dp1.backtrack(0, n, num_hosts):
        # expand each host-level stage into its chip-level sub-pipeline
        for (a, b, r_chips) in dp0.backtrack(i, j, chips_per_host):
            stages.append(StagePlan(a, b, r_chips * r_hosts))
    time = dp1.A[(0, n, num_hosts)][0]
    return PartitionResult(stages, time, sum(s.replication for s in stages))


def _partition_native(graph: Graph, num_chips: int, hw: HardwareModel,
                      num_hosts: int, memory_check: bool,
                      forward_only: bool = False) -> PartitionResult:
    import numpy as np

    from ddlbench_tpu_torch.partition import native

    order = graph.topological_sort()
    n = len(order)
    times = np.array([
        nd.forward_compute_time
        + (0.0 if forward_only else nd.backward_compute_time)
        for nd in order
    ])
    params = np.array([nd.parameter_size for nd in order])
    acts = np.array([nd.activation_size for nd in order])
    if num_hosts > 1:
        if num_chips % num_hosts:
            raise ValueError("num_chips must divide evenly across hosts")
        chips_per_host = num_chips // num_hosts
    else:
        chips_per_host = num_chips

    A0, ck0, cm0 = native.solve_level_native(
        times, params, acts, chips_per_host, hw.ici_bandwidth, hw.hbm_bytes,
        versions_bound=0 if forward_only else chips_per_host,
        memory_check=memory_check, sync_grads=not forward_only,
    )
    if num_hosts == 1:
        spans = native.backtrack(A0, ck0, cm0, 0, n, chips_per_host)
        stages = [StagePlan(i, j, r) for i, j, r in spans]
        return PartitionResult(
            stages, float(A0[0, n, chips_per_host]),
            sum(s.replication for s in stages), core="c++",
        )

    base = A0[:, :, chips_per_host].copy()
    A1, ck1, cm1 = native.solve_level_native(
        times, params, acts, num_hosts, hw.dcn_bandwidth, hw.hbm_bytes,
        versions_bound=num_hosts, memory_check=False,
        sync_grads=not forward_only, base_time=base,
    )
    stages: List[StagePlan] = []
    for (i, j, r_hosts) in native.backtrack(A1, ck1, cm1, 0, n, num_hosts):
        for (a, b, r_chips) in native.backtrack(A0, ck0, cm0, i, j, chips_per_host):
            stages.append(StagePlan(a, b, r_chips * r_hosts))
    return PartitionResult(
        stages, float(A1[0, n, num_hosts]),
        sum(s.replication for s in stages), core="c++")


@dataclasses.dataclass
class InterleavedPlan:
    """An interleaved (virtual-stage) plan — always executable by the grid
    runtime: C = num_stages * virtual_stages balanced chunks, device-stage s
    owning chunks {s, s+S, ...}, with UNIFORM replication.

    The hetero strategies (uneven replication) run no interleaved layout,
    so for V > 1 the search space is restricted to uniform plans, which
    the hybrid pipeline runs: the optimizer's output always executes.
    """

    bounds: List[int]  # C+1 chunk bounds
    num_stages: int
    replication: int
    virtual_stages: int
    pipeline_time_ms: float


def partition_interleaved(
    graph: Graph,
    num_chips: int,
    virtual_stages: int,
    hw: Optional[HardwareModel] = None,
    num_hosts: int = 1,
    memory_check: bool = True,
    num_microbatches: Optional[int] = None,
    micro_batch: Optional[int] = None,
) -> InterleavedPlan:
    """Best executable interleaved plan: search uniform replication factors
    r | num_chips (S = num_chips/r device stages, C = S*V chunks), score each
    with the same cost model as partition_hierarchical (bottleneck of
    per-stage compute + DP allreduce vs chunk-boundary transfer), return the
    minimum. Chunk bounds are the balanced min-max split of profiled times.
    ``num_microbatches`` (when known) filters out stage counts the
    interleaved timetable cannot schedule (it groups microbatches by S);
    ``micro_batch`` filters out replication factors that cannot split the
    microbatch's rows evenly (replication = intra-microbatch row splitting,
    keeping the caller's global batch unchanged — the same convention as the
    uniform-plan rewrite in parallel/api.py).
    """
    hw = hw or HardwareModel()
    from ddlbench_tpu_torch.parallel.packing import balanced_stage_bounds

    order = graph.topological_sort()
    n = len(order)
    times = [nd.forward_compute_time + nd.backward_compute_time
             for nd in order]
    params = [nd.parameter_size for nd in order]
    acts = [nd.activation_size for nd in order]
    if num_hosts > 1 and num_chips % num_hosts:
        raise ValueError("num_chips must divide evenly across hosts")
    chips_per_host = (num_chips // num_hosts if num_hosts > 1 else num_chips)

    best: Optional[InterleavedPlan] = None
    for r in range(1, num_chips + 1):
        if num_chips % r:
            continue
        S = num_chips // r
        C = S * virtual_stages
        if C > n:
            continue
        if num_microbatches is not None and num_microbatches % S:
            continue
        if micro_batch is not None and micro_batch % r:
            continue
        bounds = balanced_stage_bounds(times, C)
        # replicas within a host sync over ICI; wider groups pay DCN. When
        # replication spans whole hosts (r >= chips/host) every pipeline
        # fits inside one host and boundaries ride ICI; otherwise the
        # pipeline itself crosses hosts and boundary transfers pay DCN
        # (partition_hierarchical's edge_cost1, conservatively applied to
        # every boundary)
        bw = hw.ici_bandwidth if r <= chips_per_host else hw.dcn_bandwidth
        edge_bw = (hw.ici_bandwidth
                   if num_hosts == 1 or r >= chips_per_host
                   else hw.dcn_bandwidth)
        stage_ok = True
        bottleneck = 0.0
        for s in range(S):
            t = p = 0.0
            for c in range(s, C, S):
                t += sum(times[bounds[c]:bounds[c + 1]])
                p += sum(params[bounds[c]:bounds[c + 1]])
            if memory_check and (1 + S) * p > hw.hbm_bytes:
                stage_ok = False
                break
            bottleneck = max(bottleneck, t / r + _allreduce_ms(p, r, bw))
        if not stage_ok:
            continue
        for c in range(C - 1):
            bottleneck = max(bottleneck, _ms(acts[bounds[c + 1] - 1],
                                             edge_bw))
        plan = InterleavedPlan(bounds, S, r, virtual_stages, bottleneck)
        if best is None or plan.pipeline_time_ms < best.pipeline_time_ms:
            best = plan
    if best is None:
        raise ValueError(
            f"no executable interleaved plan: {num_chips} chips x "
            f"{virtual_stages} virtual stages needs some S*V <= {n} layers")
    return best


def capped_balanced_split(n: int, num_stages: int, span_cost, edge_cost,
                          span_ok) -> Optional[List[int]]:
    """Contiguous split of nodes [0, n) into EXACTLY ``num_stages`` spans
    minimizing the bottleneck ``max(span costs, cut-edge costs)`` subject to
    a per-span feasibility predicate (the memory cap).

    This is the fixed-replication specialization of :class:`_LevelDP`'s
    recurrence — replication is decided OUTSIDE (the --plan auto solver
    enumerates uniform (pp, dp, tp) factorizations, so every stage runs the
    same unit count) which collapses the unit dimension and leaves the
    classic O(n^2 * stages) min-max chain partition:

        A[j][k] = min over i of max(A[i][k-1], edge_cost(i), span_cost(i, j))
                  where span_ok(i, j)

    ``span_cost(i, j)``/``span_ok(i, j)`` see the half-open node span
    [i, j); ``edge_cost(i)`` prices the cut before node i. Returns the
    ``num_stages + 1`` bounds, or None when no feasible split exists (some
    span every split must contain violates ``span_ok``)."""
    if num_stages < 1 or num_stages > n:
        return None
    A = [[INF] * (num_stages + 1) for _ in range(n + 1)]
    choice = [[-1] * (num_stages + 1) for _ in range(n + 1)]
    A[0][0] = 0.0
    for k in range(1, num_stages + 1):
        for j in range(k, n - (num_stages - k) + 1):
            best, arg = INF, -1
            for i in range(k - 1, j):
                prev = A[i][k - 1]
                if prev == INF or not span_ok(i, j):
                    continue
                t = max(prev, span_cost(i, j),
                        edge_cost(i) if i > 0 else 0.0)
                if t < best:
                    best, arg = t, i
            A[j][k], choice[j][k] = best, arg
    if A[n][num_stages] == INF:
        return None
    bounds = [n]
    j, k = n, num_stages
    while k > 0:
        j = choice[j][k]
        bounds.append(j)
        k -= 1
    return bounds[::-1]


def stage_bounds_from_graph(graph: Graph, num_stages: int) -> List[int]:
    """Uniform-mesh helper: contiguous min-max split of measured per-node
    times into num_stages (the profiled replacement for torchgpipe's
    balance_by_time). Use partition_hierarchical for replicated plans."""
    from ddlbench_tpu_torch.parallel.packing import balanced_stage_bounds

    order = graph.topological_sort()
    times = [nd.forward_compute_time + nd.backward_compute_time for nd in order]
    return balanced_stage_bounds(times, num_stages)


def stamp_stage_ids(graph: Graph, result: PartitionResult) -> None:
    """Write stage_id onto graph nodes (gpus=N.txt parity,
    optimizer_graph_hierarchical.py:334-346)."""
    order = graph.topological_sort()
    for sid, plan in enumerate(result.stages):
        for idx in range(plan.start, plan.end):
            order[idx].stage_id = sid
