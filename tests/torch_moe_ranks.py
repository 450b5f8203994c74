"""Rank cases of the MoE archs under replicated dp and fsdp (global
routing: models/moe.global_routing) for tests/torch_dp_ranks.RankPool
("torch_moe_ranks:<case>"). This module imports no JAX: the ranks run
the port only, on numpy inputs and the reference's weights as numpy,
and send back numpy."""

from __future__ import annotations

import numpy as np
import torch

from torch_dp_ranks import named
from torch_shard_ranks import build


def _whole_grads(strat, comm, grads) -> dict:
    """The step's reduced gradient by "<layer>.<name>", whole: dp's flat
    vector unpacked (the replicated engine), fsdp's shards gathered."""
    from ddlbench_tpu_torch.parallel.common import from_ref_layout, unpack_flat

    if hasattr(strat, "shards"):
        out = {}
        for i, g in enumerate(grads):
            if strat.lengths[i]:
                full = comm.all_gather(g.contiguous())
                out.update({f"{i}.{n}": t.numpy().copy() for n, t in
                            strat._views(i, full).items()})
        return out
    by_id = {id(p): g for p, g in zip(strat.params,
                                      unpack_flat(grads, strat.meta))}
    return {f"{i}.{n}": from_ref_layout(by_id[id(p)]).reshape(p.shape)
            .numpy().copy()
            for i, layer in enumerate(strat.model.layers)
            for n, p in layer.named_parameters()}


def _routes(net) -> list:
    """Each MoE block's last route: (expert, slot, keep) of this rank's
    tokens, and the block's aux loss."""
    from ddlbench_tpu_torch.models.moe import moe_blocks

    return [{"expert": b.last_route.expert.numpy().copy(),
             "slot": b.last_route.slot.numpy().copy(),
             "keep": b.last_route.keep.numpy().copy(),
             "aux": float(b.last_route.aux.detach())}
            for b in moe_blocks(net)]


def train(comm, strategy: str, cfg: dict, batches: list, lr: float,
          params, grad_batch, eval_batch, capacity_factor=1.25) -> dict:
    """``strategy`` ("dp": the replicated engine, or "fsdp") on the tiny
    MoE with the reference's weights: the reduced gradient and the
    routes of one step on ``grad_batch`` (no update), then the steps
    over ``batches``: losses, every parameter whole, the eval sums."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.convert import from_jax_params
    from ddlbench_tpu_torch.parallel.api import RANK_CLASSES

    net = build("moe_t", capacity_factor)
    from_jax_params(net, params)
    strat = RANK_CLASSES[strategy](net, RunConfig(
        strategy=strategy, **{**cfg, "num_devices": comm.world}), comm)
    strat.init()
    x, y = (torch.from_numpy(np.array(t)).long() for t in grad_batch)
    m, grads = strat.reduced_grads(x, y)
    out = {"grad_loss": float(m["loss"]),
           "grads": _whole_grads(strat, comm, grads),
           "routes": _routes(net), "losses": []}
    for x, y in batches:
        m = strat.train_step(torch.from_numpy(np.array(x)).long(),
                             torch.from_numpy(np.array(y)).long(), lr)
        out["losses"].append(float(m["loss"]))
    out["params"] = ({k: v.numpy().copy() for k, v in
                      strat.named_params().items()}
                     if hasattr(strat, "named_params")
                     else named(strat.materialize_params()))
    ev = strat.eval_step(*(torch.from_numpy(np.array(t)).long()
                           for t in eval_batch))
    out["eval"] = {k: float(v) for k, v in ev.items()}
    return out
