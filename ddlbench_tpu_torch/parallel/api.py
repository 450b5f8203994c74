"""Strategy factory of the port (``ddlbench_tpu/parallel/api.py``
``make_strategy``), for the strategies it carries: ``single``, ``dp``,
``gpipe`` (fill-drain, or an event schedule of the timetable runtime, or
with ``tp_size`` > 1 tpp's Megatron-sliced stages, 3-D with
``dp_replicas`` > 1), ``pipedream``,
``sp``, ``ep``, ``fsdp`` and ``tp``; a pipeline with ``dp_replicas`` > 1
is one replica of the hybrid, an uneven ``stage_replication`` the hetero
strategies (parallel/hetero.py), a branchy arch under a manual pipeline
the node-granular packed chain (models/branchy.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

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
    sched = recommend_schedule(S, chunks, cfg.virtual_stages)
    best = sched[0]
    tail = ("" if best["schedule"] == cfg.pipe_schedule else
            f" (run has --pipe-schedule {cfg.pipe_schedule})")
    return (f"schedule advisor (S={S}, M={chunks}): {table}\n"
            f"schedule advisor: best schedule at V={cfg.virtual_stages} is "
            f"{best['schedule']} (analytic bubble {best['bubble']}){tail}: "
            f"{sched}")


def _pipeline(cfg: RunConfig, model, device: torch.device,
              shared_card: bool, comm: Optional[Comm]) -> GPipeStrategy:
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
    this process over sum(r) devices."""
    bounds = None
    if cfg.plan_bounds is not None:
        if cfg.plan_bounds[-1] != len(model.layers):
            raise ValueError(
                f"--plan-bounds {list(cfg.plan_bounds)} must end at the "
                f"model's layer count ({cfg.arch} has "
                f"{len(model.layers)} layers)")
        bounds = [int(b) for b in cfg.plan_bounds]
    rank0 = comm is None or comm.rank == 0
    if bounds is None:
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
                  shared_card: bool = False) -> Strategy:
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
    (distributed.stage_devices); the model's chunks are moved there."""
    cfg.validate()
    if cfg.spawned_ranks() and comm is None:
        raise ValueError(f"strategy {cfg.strategy!r} runs on a rank of a "
                         "process group: pass its Comm (distributed.spawn "
                         "makes them)")
    set_attention_backend(cfg.attention_backend)
    model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed,
                      moe_capacity_factor=cfg.moe_capacity_factor)
    if cfg.strategy in PIPELINE_STRATEGIES:
        strategy = _pipeline(cfg, model, device, shared_card, comm)
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
