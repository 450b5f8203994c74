"""Rank cases of the port's ``--plan auto`` for tests/torch_dp_ranks.RankPool
("torch_plan_ranks:<case>"). This module imports no JAX: the ranks run
the port only. Importing it registers the tiny token benchmark
("tinylm": T 32, vocab 64) in the port's config (the ranks')."""

from __future__ import annotations

import numpy as np
import torch

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, HardwareModel, RunConfig

TINY = DatasetSpec("tinylm", (32,), 64, 1000, 100, kind="tokens")
tconfig.DATASETS.setdefault("tinylm", TINY)
CPU = torch.device("cpu")


def _quiet_run(cfg: RunConfig, comm):
    """run_benchmark of ``cfg`` from its seed on ``comm`` (None for a
    one-process strategy), no warm-up; returns the final parameters."""
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import run_benchmark
    from ddlbench_tpu_torch.train.metrics import MetricLogger

    strategy = make_strategy(cfg, CPU, comm if cfg.spawned_ranks() else None)
    logger = MetricLogger(cfg.epochs, cfg.log_interval, device=CPU,
                          rank=1)  # records only: no lines from the ranks
    out = run_benchmark(cfg, strategy, logger, warmup_steps=0)
    sync = getattr(strategy, "sync_params", None)
    if sync is not None:
        sync()
    materialize = getattr(strategy, "materialize_params", None)
    if materialize is not None:
        materialize()
    return ([p.detach().numpy().copy() for p in strategy.model.parameters()],
            out["valid_accuracy"])


def plan_auto_vs_explicit(comm, graph: str, auto: dict, explicit: dict,
                          hbm_bytes: float):
    """``--plan auto`` on ``auto`` (RunConfig kwargs) with the profile
    stubbed to the graph text ``graph`` (the reference's fixture, which
    stubs its profiler the same way): (the resolved config equals
    ``explicit``, the run's final parameters bitwise equal the explicit
    run's, the winner's strategy)."""
    import ddlbench_tpu_torch.profiler.profile as prof
    from ddlbench_tpu_torch.graph.graph import Graph
    from ddlbench_tpu_torch.partition.planner import resolve_auto_plan

    hw = HardwareModel(hbm_bytes=hbm_bytes)
    cfg = RunConfig(**auto, hardware=hw)
    want = RunConfig(**explicit, hardware=hw)
    real = prof.profile_model
    prof.profile_model = lambda *a, **k: Graph.from_str(graph)
    try:
        resolved = resolve_auto_plan(cfg, comm=comm)
    finally:
        prof.profile_model = real
    p_auto, acc_auto = _quiet_run(resolved, comm)
    p_manual, acc_manual = _quiet_run(want, comm)
    bitwise = (len(p_auto) == len(p_manual)
               and all(np.array_equal(a, b)
                       for a, b in zip(p_auto, p_manual)))
    return (resolved == want, bitwise and acc_auto == acc_manual,
            resolved.strategy)


def uniform_plan_trains(comm, part):
    """An --auto-partition plan made in the parent (the CLI's
    prepare_run), pickled to the ranks its replicas need: each rank
    builds it (make_strategy(..., partition=part)) and takes one float32
    step. Returns (strategy class, bounds, dp, mb, loss)."""
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy

    s = make_strategy(part.cfg, CPU, comm, partition=part)
    x, y = make_synthetic(part.cfg.dataset(), part.cfg.global_batch(), CPU,
                          seed=2).batch(0, 0)
    loss = float(s.train_step(x, y, 0.05)["loss"])
    return type(s).__name__, list(s.bounds), s.cfg.dp_replicas, s.mb, loss
