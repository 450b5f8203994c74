"""Strategy factory of the port (``ddlbench_tpu/parallel/api.py``
``make_strategy``), for the strategies it carries: ``single``, ``dp``,
``gpipe`` (fill-drain, or an event schedule of the timetable runtime, or
with ``tp_size`` > 1 tpp's Megatron-sliced stages, 3-D with
``dp_replicas`` > 1), ``pipedream``,
``sp``, ``ep``, ``fsdp`` and ``tp``; a pipeline with ``dp_replicas`` > 1
is one replica of the hybrid, an uneven ``stage_replication`` the hetero
strategies (parallel/hetero.py), a branchy arch under a manual pipeline
the node-granular packed chain (models/branchy.py).

``plan="auto"`` (partition/planner.py) rewrites the config onto the
solved mix first. ``auto_partition`` on gpipe and pipedream runs the
reference's profile -> partition -> plan loop (:func:`auto_partition`):
profile the model (profiler/profile.py; the branchy arches' DAG, chained
at node granularity), partition it (partition/optimizer.py), and run the
plan: a uniform one as the hybrid, an uneven one on the hetero
strategies, one that cannot run at the balanced split of the profile;
with ``pipe_costs="profile"`` the event timetable is weighted by the
plan's per-chunk costs."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from ddlbench_tpu_torch.config import (PIPELINE_STRATEGIES, RANK_STRATEGIES,
                                      RunConfig)
from ddlbench_tpu_torch.distributed import (Comm, hybrid_stage_devices,
                                            stage_devices, tp_stage_devices,
                                            tpp3d_comms, tpp3d_stage_devices)
from ddlbench_tpu_torch.models.branchy import get_dag, to_packed_chain
from ddlbench_tpu_torch.models.transformer import set_attention_backend
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.parallel.dp import DPStrategy
from ddlbench_tpu_torch.parallel.ep import EPStrategy
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
from ddlbench_tpu_torch.parallel.hetero import (HeteroGPipeStrategy,
                                                HeteroPipeDreamStrategy)
from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy
from ddlbench_tpu_torch.parallel.pipeline_rt import ScheduledPipelineStrategy
from ddlbench_tpu_torch.parallel.sharded import FSDPStrategy, TPStrategy
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.parallel.sp import SPStrategy
from ddlbench_tpu_torch.parallel.tpp import TPGPipeStrategy
from ddlbench_tpu_torch.graph.graph import Graph
from ddlbench_tpu_torch.partition.schedule import (recommend_schedule,
                                                   recommend_virtual_stages)

Strategy = Union[SingleStrategy, DPStrategy, GPipeStrategy, SPStrategy,
                 EPStrategy, FSDPStrategy, TPStrategy]
RANK_CLASSES = {"dp": DPStrategy, "sp": SPStrategy, "ep": EPStrategy,
                "fsdp": FSDPStrategy, "tp": TPStrategy}


def schedule_advice(cfg: RunConfig, num_layers: int) -> str:
    """The reference's two schedule-advisor lines for a gpipe run: the
    interleaving factors at (S, M) and the best timetable at the run's
    V."""
    S = cfg.resolved_stages()
    _, chunks = cfg.resolved_batches()
    table = recommend_virtual_stages(S, chunks, num_layers)
    sched = recommend_schedule(S, chunks, cfg.virtual_stages,
                               costs=cfg.pipe_cost_vectors)
    best = sched[0]
    tail = ("" if best["schedule"] == cfg.pipe_schedule else
            f" (run has --pipe-schedule {cfg.pipe_schedule})")
    basis = "weighted" if cfg.pipe_cost_vectors else "analytic"
    return (f"schedule advisor (S={S}, M={chunks}): {table}\n"
            f"schedule advisor: best schedule at V={cfg.virtual_stages} is "
            f"{best['schedule']} ({basis} bubble {best['bubble']}){tail}: "
            f"{sched}")


@dataclasses.dataclass
class AutoPartition:
    """An --auto-partition plan, ready to build: ``cfg`` carries the
    plan's stages, replication, batch split and cost vectors; ``bounds``
    are the chunk bounds over the model the strategy runs (the chain's
    layers, or the packed chain's spans of a branchy arch, cut at the
    DAG nodes ``cuts``); ``graph`` is the profile the DP solved over."""

    cfg: RunConfig
    bounds: List[int]
    graph: Graph
    cuts: Optional[List[int]] = None


def auto_partition(cfg: RunConfig, device: torch.device,
                   input_time_ms: float = 0.0) -> AutoPartition:
    """Profile -> partition -> plan: the reference's PipeDream phases 1-3
    (its ``make_strategy`` auto-partition branch). ``input_time_ms``: the
    measured per-microbatch data-loading cost, priced into the stage of
    layer 0. A "time" profile runs on ``device``."""
    from ddlbench_tpu_torch.partition.optimizer import (
        partition_hierarchical, partition_interleaved,
        stage_bounds_from_graph)
    from ddlbench_tpu_torch.partition.schedule import (
        quantize_cost_vectors_clipped)
    from ddlbench_tpu_torch.profiler.profile import (chunk_cost_ms,
                                                     fold_input_node,
                                                     packed_chain_graph,
                                                     profile_dag,
                                                     profile_model)

    cfg.validate()
    set_attention_backend(cfg.attention_backend)
    mb, chunks = cfg.resolved_batches()
    spec = cfg.dataset()
    dag = get_dag(cfg.arch, spec.image_size, spec.num_classes,
                  seed=cfg.seed)
    on = device if cfg.profile_mode == "time" else torch.device("cpu")
    branchy = dag is not None
    if branchy:
        # branchy arch: profile the real dataflow DAG, then chainize it at
        # node granularity with packed-crossing boundary sizes — the
        # partitioner may cut at any position and the chosen cuts run
        # through branchy.to_packed_chain
        cdtype = getattr(torch, cfg.compute_dtype)
        for layer in dag.layers:
            layer.to(on)
        dag_graph = profile_dag(dag, mb, mode=cfg.profile_mode, dtype=cdtype,
                                hw=cfg.hardware)
        # one itemsize everywhere: the profile's activation sizes and the
        # input-crossing bytes must share units for the DP's cut comparison
        graph = packed_chain_graph(dag_graph, dag, mb,
                                   itemsize=torch.empty(
                                       (), dtype=cdtype).element_size())
        if input_time_ms > 0.0:
            # fold_input_node semantics: data loading prices into the
            # stage hosting block 0
            graph.topological_sort()[0].forward_compute_time += (
                input_time_ms)
        del dag
    else:
        model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed,
                          moe_capacity_factor=cfg.moe_capacity_factor)
        graph = profile_model(model.to(on), mb, mode=cfg.profile_mode,
                              hw=cfg.hardware, input_time_ms=input_time_ms)
        del model
        # the Input node folds into layer 0's stage: a device cannot run
        # "just data loading", so Input must never form its own stage
        graph = fold_input_node(graph)

    if cfg.virtual_stages > 1:
        # interleaved layouts run on uniform plans only: search that
        # executable family and run the winner
        iplan = partition_interleaved(
            graph, cfg.num_devices, cfg.virtual_stages, cfg.hardware,
            num_hosts=cfg.num_hosts, num_microbatches=chunks,
            micro_batch=mb)
        bounds = list(iplan.bounds)
        # replicas split each microbatch's rows: the global batch M*mb is
        # unchanged
        cfg = cfg.replace(
            num_stages=iplan.num_stages, dp_replicas=iplan.replication,
            stage_replication=None,
            micro_batch_size=mb // iplan.replication,
            num_microbatches=chunks)
        print(f"auto-partition (interleaved): executing "
              f"S={iplan.num_stages} x V={iplan.virtual_stages} "
              f"(replication={iplan.replication}, bounds={bounds}, "
              f"bottleneck {iplan.pipeline_time_ms:.3f} ms)", flush=True)
    else:
        plan = partition_hierarchical(graph, cfg.num_devices, cfg.hardware,
                                      num_hosts=cfg.num_hosts)
        print(f"auto-partition: the {plan.core} DP core solved the plan",
              flush=True)
        repl = tuple(s.replication for s in plan.stages)
        if repl and len(set(repl)) == 1 and mb % repl[0] == 0:
            # uniform plan: the hybrid runs it at the plan's bounds
            planned = cfg.replace(
                num_stages=len(repl), dp_replicas=repl[0],
                stage_replication=None, micro_batch_size=mb // repl[0],
                num_microbatches=chunks)
        else:
            planned = cfg.replace(num_stages=None, dp_replicas=1,
                                  stage_replication=repl)
        try:
            planned.validate()
            bounds = plan.stage_bounds()
            cfg = planned
            print(f"auto-partition: executing plan "
                  f"{[(s.start, s.end, s.replication) for s in plan.stages]}"
                  f" (bounds={bounds}, replication={repl}, "
                  f"bottleneck {plan.pipeline_time_ms:.3f} ms)", flush=True)
        except ValueError as e:
            # e.g. micro-batch not divisible by a replication factor: keep
            # the profiled balanced split rather than fail the run
            bounds = stage_bounds_from_graph(graph, cfg.resolved_stages())
            print(f"auto-partition: plan {repl} not executable ({e}); "
                  f"falling back to balanced bounds {bounds}", flush=True)
    if cfg.pipe_costs == "profile":
        # cost-weighted timetables: the profile's per-node times summed
        # over the chosen chunk bounds, quantized onto the half-tick grid
        f_ms, b_ms = chunk_cost_ms(graph, bounds)
        # the searched packer needs to see the real unevenness: an
        # 8-half-tick cap flattens extreme profiles
        max_units = 64 if cfg.pipe_schedule == "searched" else 8
        vectors, clipped = quantize_cost_vectors_clipped(
            f_ms, b_ms, max_units=max_units)
        cfg = cfg.replace(pipe_cost_vectors=vectors)
        print(f"auto-partition: cost-weighted timetable vectors "
              f"(f/b/w half-ticks per chunk) {vectors}", flush=True)
        if clipped:
            print(f"auto-partition: WARNING {clipped} event cost(s) "
                  f"clipped at the {max_units}-half-tick "
                  f"quantization cap — the timetable underweights "
                  f"the most expensive chunks (profile is more "
                  f"uneven than the grid can express)", flush=True)
    cfg.validate()
    cuts = None
    if branchy:
        # the chosen node cuts run as one packed span per chunk
        cuts, bounds = list(bounds[1:-1]), list(range(len(bounds)))
        print(f"auto-partition: packed-boundary chain, {len(bounds) - 1} "
              f"spans", flush=True)
    return AutoPartition(cfg, bounds, graph, cuts)


def _pipeline(cfg: RunConfig, model, device: torch.device,
              shared_card: bool, comm: Optional[Comm],
              bounds: Optional[List[int]] = None) -> GPipeStrategy:
    """A gpipe or pipedream strategy over ``cfg``'s stages on ``device``
    (distributed.stage_devices), split at ``cfg.plan_bounds`` when set,
    else at the balanced default split (a branchy arch's over its
    node-granular packed chain, the reference's manual-pipeline form);
    with ``tp_size`` > 1 rank ``comm``'s shard of tpp
    (distributed.tp_stage_devices), and with ``dp_replicas`` > 1 as well
    rank ``comm.rank`` = d * tp + t of 3-D tpp, its tp and data groups
    made here (distributed.tpp3d_comms, tpp3d_stage_devices); with only
    ``dp_replicas`` > 1 replica
    ``comm.rank`` of the hybrid (distributed.hybrid_stage_devices). A
    uniform ``stage_replication`` (r, ..., r) runs as that hybrid at
    ``dp_replicas`` r and micro_batch_size // r (the global batch stays
    M x micro_batch_size); an uneven one runs the hetero strategies in
    this process over sum(r) devices. ``bounds``: an auto-partition
    plan's chunk bounds (AutoPartition.bounds), over ``model``."""
    if bounds is None and cfg.plan_bounds is not None:
        if cfg.plan_bounds[-1] != len(model.layers):
            raise ValueError(
                f"--plan-bounds {list(cfg.plan_bounds)} must end at the "
                f"model's layer count ({cfg.arch} has "
                f"{len(model.layers)} layers)")
        bounds = [int(b) for b in cfg.plan_bounds]
    rank0 = comm is None or comm.rank == 0
    if bounds is None and not cfg.auto_partition:
        spec = cfg.dataset()
        dag = get_dag(cfg.arch, spec.image_size, spec.num_classes,
                      seed=cfg.seed)
        if dag is not None:
            model = to_packed_chain(dag, range(1, len(dag.layers)))
            if rank0:
                print(f"branchy arch: node-granular packed chain "
                      f"({len(model.layers)} layers) for the stage split",
                      flush=True)
    repl = tuple(cfg.stage_replication or ())
    if repl and len(set(repl)) == 1:
        mb, chunks = cfg.resolved_batches()
        cfg = dataclasses.replace(cfg, stage_replication=None,
                                  dp_replicas=repl[0], num_stages=len(repl),
                                  micro_batch_size=mb // repl[0],
                                  num_microbatches=chunks)
        repl = ()
    if cfg.strategy == "gpipe" and rank0:
        print(schedule_advice(cfg, len(model.layers)), flush=True)
    if repl:
        devices = stage_devices(str(device), sum(repl), shared_card)
        model = model.to(devices[0])
        if devices[0].type == "cuda" and cfg.dataset().kind == "image":
            model = model.to(memory_format=torch.channels_last)
        cls = (HeteroPipeDreamStrategy if cfg.strategy == "pipedream"
               else HeteroGPipeStrategy)
        return cls(model, cfg, devices, stage_bounds=bounds)
    tp_comm, dp_comm = comm, None
    if cfg.tp_size > 1 and cfg.dp_replicas > 1:
        tp_comm, dp_comm = tpp3d_comms(comm, cfg.dp_replicas, cfg.tp_size)
        devices = tpp3d_stage_devices(str(device), cfg.resolved_stages(),
                                      cfg.tp_size, cfg.dp_replicas,
                                      comm.rank, shared_card)
    elif cfg.tp_size > 1:
        devices = tp_stage_devices(str(device), cfg.resolved_stages(),
                                   cfg.tp_size, comm.rank, shared_card)
    elif cfg.dp_replicas > 1:
        devices = hybrid_stage_devices(str(device), cfg.resolved_stages(),
                                       cfg.dp_replicas, comm.rank,
                                       shared_card)
    else:
        devices = stage_devices(str(device), cfg.resolved_stages(),
                                shared_card)
    # on the first stage's device until the strategy has read the layers'
    # shapes and split them; it then moves each chunk to its own
    model = model.to(devices[0])
    if devices[0].type == "cuda" and cfg.dataset().kind == "image":
        model = model.to(memory_format=torch.channels_last)
    if cfg.tp_size > 1:
        return TPGPipeStrategy(model, cfg, devices, tp_comm,
                               stage_bounds=bounds, dp_comm=dp_comm)
    if cfg.strategy == "pipedream":
        cls = PipeDreamStrategy
    elif cfg.pipe_schedule != "fill-drain":
        cls = ScheduledPipelineStrategy
    else:
        cls = GPipeStrategy
    return cls(model, cfg, devices, stage_bounds=bounds,
               dp_comm=comm if cfg.dp_replicas > 1 else None)


def make_strategy(cfg: RunConfig, device: torch.device,
                  comm: Optional[Comm] = None,
                  shared_card: bool = False, input_time_ms: float = 0.0,
                  partition: Optional[AutoPartition] = None) -> Strategy:
    """Validate ``cfg``, set the attention backend (which image models do
    not read), build ``cfg.arch`` for ``cfg.benchmark`` with random weights
    from ``cfg.seed`` on ``device``, and return its strategy with fresh
    optimizer state. On the card an image model's convolution kernels are
    channels_last, the layout cuDNN runs fastest, as the data's images
    are. ``dp``, ``sp``, ``ep``, ``fsdp`` and ``tp`` run on the rank
    ``comm`` (distributed.spawn gives each rank its own), whose world must
    be ``cfg.num_devices``; rank 0's weights are broadcast to the others.
    A gpipe with ``tp_size`` > 1 runs shard ``comm.rank`` of ``tp_size``
    (every rank builds the same weights from ``cfg.seed``), with
    ``dp_replicas`` > 1 as well rank ``comm.rank`` of 3-D tpp; a hybrid
    pipeline (``cfg.spawned_ranks()`` replicas) replica ``comm.rank``.
    ``gpipe`` and ``pipedream`` run
    their stages on ``cfg.resolved_stages()`` devices of ``device``'s
    type: one card each, or with ``shared_card`` every stage on one card
    (distributed.stage_devices); the model's chunks are moved there.

    ``plan="auto"`` resolves the plan first (partition/planner.py; on the
    ranks of ``comm`` rank 0 solves it). With ``auto_partition`` a
    pipeline runs ``partition`` (an :func:`auto_partition` plan, made
    here when None, ``input_time_ms`` priced into stage 0); a plan whose
    replicas are ranks needs its ``comm``, so the CLI makes the plan
    before it spawns them."""
    if cfg.plan == "auto":
        from ddlbench_tpu_torch.partition.planner import resolve_auto_plan

        cfg = resolve_auto_plan(cfg, input_time_ms=input_time_ms,
                                device=device, comm=comm)
    cfg.validate()
    bounds = None
    if cfg.auto_partition and cfg.strategy in PIPELINE_STRATEGIES:
        partition = partition or auto_partition(cfg, device, input_time_ms)
        cfg, bounds = partition.cfg, partition.bounds
    if cfg.spawned_ranks() and comm is None:
        raise ValueError(f"strategy {cfg.strategy!r} runs on a rank of a "
                         "process group: pass its Comm (distributed.spawn "
                         "makes them)")
    set_attention_backend(cfg.attention_backend)
    if partition is not None and partition.cuts is not None:
        spec = cfg.dataset()
        model = to_packed_chain(get_dag(cfg.arch, spec.image_size,
                                        spec.num_classes, seed=cfg.seed),
                                partition.cuts)
    else:
        model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed,
                          moe_capacity_factor=cfg.moe_capacity_factor)
    if cfg.strategy in PIPELINE_STRATEGIES:
        strategy = _pipeline(cfg, model, device, shared_card, comm, bounds)
        strategy.init()
        return strategy
    model = model.to(device)
    if device.type == "cuda" and cfg.dataset().kind == "image":
        model = model.to(memory_format=torch.channels_last)
    if cfg.strategy in RANK_STRATEGIES:
        strategy = RANK_CLASSES[cfg.strategy](model, cfg, comm)
    else:
        strategy = SingleStrategy(model, cfg)
    strategy.init()
    return strategy
