"""Rank cases of the port's hybrid pipelines (parallel/gpipe.py,
pipeline_rt.py and pipedream.py with ``dp_replicas`` > 1, and gpipe's
hybrid PP x ZeRO-1) for tests/torch_dp_ranks.RankPool
("torch_hybrid_ranks:<case>"). This module imports no JAX: each rank
runs one replica of the port on numpy inputs and the reference's
weights as numpy, and sends back numpy. Importing it registers the tiny
benchmarks ("tinylm": T 32, vocab 64; "tinyhybimg": 4x4x1, 4 classes)
in the port's config, in the test process and in every rank."""

from __future__ import annotations

import numpy as np
import torch

import torch_tp_ranks  # noqa: F401  (registers "tinylm")
from torch_dp_ranks import _port_batch, build_model

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig

IMG = DatasetSpec("tinyhybimg", (4, 4, 1), 4, 64, 16)
tconfig.DATASETS.setdefault("tinyhybimg", IMG)
CPU = torch.device("cpu")


def port_strategy(comm, model: str, engine: str, cfg: dict, params=None,
                  states=None):
    """The port's ``engine`` ("gpipe", "rt" or "pipedream") on ``model``
    (torch_dp_ranks.build_model's twin of the reference's tiny model,
    with the reference's weights) as replica ``comm.rank`` of
    ``cfg["dp_replicas"]``; initialised."""
    from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
    from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy
    from ddlbench_tpu_torch.parallel.pipeline_rt import (
        ScheduledPipelineStrategy)

    net = build_model(model)
    if params is not None:
        from_jax_params(net, params)
    if states is not None:
        from_jax_state(net, states)
    rc = RunConfig(**cfg)
    cls = {"gpipe": GPipeStrategy, "rt": ScheduledPipelineStrategy,
           "pipedream": PipeDreamStrategy}[engine]
    strat = cls(net, rc, [CPU] * rc.resolved_stages(),
                dp_comm=comm if rc.dp_replicas > 1 else None)
    strat.init()
    return strat


def state_rows(strat) -> np.ndarray:
    """The running statistics packed as the reference's state rows: per
    chunk, per layer, its buffers sorted by name, zero-padded."""
    from ddlbench_tpu_torch.parallel.common import _key_part

    rows = []
    for c in range(strat.num_chunks):
        vals = []
        for layer in strat.chunk_layers(c):
            named = sorted(layer.named_buffers(),
                           key=lambda kv: tuple(map(_key_part,
                                                    kv[0].split("."))))
            vals += [b.detach().double().reshape(-1).numpy()
                     for _, b in named]
        rows.append(np.concatenate(vals) if vals else np.zeros(0))
    L = max(max(r.size for r in rows), 1)
    return np.stack([np.pad(r, (0, L - r.size)) for r in rows])


def train(comm, model: str, engine: str, cfg: dict, params, states,
          batches: list, lr: float) -> dict:
    """The port's hybrid over the global ``batches`` at ``lr``: each step's
    loss and accuracy, the packed parameter rows after each step
    (materialize_params), the state rows at the end, this rank's
    optimizer-state bytes, the bounds, and the eval step on the first
    batch."""
    strat = port_strategy(comm, model, engine, cfg, params, states)
    out = {"losses": [], "accuracy": [], "params": [],
           "bounds": list(strat.bounds),
           "p0": strat.materialize_params().numpy()}
    for x, y in batches:
        m = strat.train_step(_port_batch(x), torch.from_numpy(np.array(y)),
                             lr)
        out["losses"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append(strat.materialize_params().numpy())
    out["states"] = state_rows(strat)
    out["opt_bytes"] = strat.opt_state_bytes()
    ev = strat.eval_step(_port_batch(batches[0][0]),
                         torch.from_numpy(np.array(batches[0][1])))
    out["eval"] = {k: float(v) for k, v in ev.items()}
    return out


def rows_of(comm, model: str, cfg: dict, params) -> dict:
    """ZeRO-1's between-steps layout on this rank: each chunk's shard,
    the padded row length, and the plain row that the shards gathered
    (all_gather of each bucket) give back."""
    from ddlbench_tpu_torch.parallel.common import from_device_major

    strat = port_strategy(comm, model, "gpipe", cfg, params)
    out = {"shards": [], "rows": [], "padded": [], "plain": []}
    for c in range(strat.num_chunks):
        meta = strat._row_meta[c]
        full = comm.all_gather(strat._shards[c])
        out["shards"].append(strat._shards[c].numpy().copy())
        out["padded"].append(meta.padded)
        out["rows"].append(
            from_device_major(full, meta, comm.world)[:meta.length].numpy())
        out["plain"].append(strat._pack_row(
            c, [p.detach() for p in strat._ref_params[c]])[
                :meta.length].numpy())
    return out
