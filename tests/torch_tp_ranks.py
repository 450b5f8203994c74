"""Rank cases of the port's tensor parallelism (the sliced block, tpp,
the tp strategy) for tests/torch_dp_ranks.RankPool
("torch_tp_ranks:<case>"). This module imports no JAX: the ranks run the
port only, on numpy inputs and the reference's weights as numpy, and
send back numpy. Importing it registers the tiny token benchmark
("tinylm": T 32, vocab 64) in the port's config, in the test process and
in every rank."""

from __future__ import annotations

import numpy as np
import torch

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig

TINY = DatasetSpec("tinylm", (32,), 64, 1000, 100, kind="tokens")
tconfig.DATASETS.setdefault("tinylm", TINY)
CPU = torch.device("cpu")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def block(comm, params, x, g, n_heads):
    """A dense transformer block with the reference's weights ``params``
    (its nested dict), sliced to this rank's shard and run under
    tensor_parallel on x [B, T, d], its output's cotangent ``g``: (y, dx,
    {name: gradient of the rank's leaf})."""
    from ddlbench_tpu_torch.models.transformer import (TransformerBlock,
                                                       slice_block,
                                                       tensor_parallel)

    d = x.shape[-1]
    blk = TransformerBlock(d, n_heads, torch.Generator().manual_seed(0))
    named = dict(blk.named_parameters())
    with torch.no_grad():
        for name, arr in _flat(params):
            named[name].copy_(torch.from_numpy(np.array(arr)))
    slice_block(blk, comm.rank, comm.world)
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    names = [n for n, _ in blk.named_parameters()]
    with tensor_parallel(comm):
        y = blk(xt)
        grads = torch.autograd.grad(
            y, [xt] + [p for _, p in blk.named_parameters()],
            torch.from_numpy(np.array(g)))
    return (y.detach().numpy(), grads[0].numpy(),
            {n: t.numpy() for n, t in zip(names, grads[1:])})


def tpp_model(params):
    """The port's transformer_t on tinylm with the reference's weights."""
    from ddlbench_tpu_torch.convert import from_jax_params
    from ddlbench_tpu_torch.models.transformer import build_transformer

    return from_jax_params(build_transformer("transformer_t", (32,), 64),
                           params)


def tpp(comm, cfg: dict, params, batches: list, lr: float,
        grad_batch=None) -> dict:
    """tpp (TPGPipeStrategy) on this rank's shard, from the reference's
    weights: each step's loss, then the rank's gradients (its shard's
    for a sliced leaf) on ``grad_batch``, by "<layer>.<name>"."""
    from ddlbench_tpu_torch.distributed import tp_stage_devices
    from ddlbench_tpu_torch.parallel.tpp import TPGPipeStrategy

    rc = RunConfig(strategy="gpipe", tp_size=comm.world, **cfg)
    devices = tp_stage_devices("cpu", rc.resolved_stages(), comm.world,
                               comm.rank)
    strat = TPGPipeStrategy(tpp_model(params), rc, devices, comm)
    strat.init()
    out = {"losses": [], "bounds": list(strat.bounds)}
    for x, y in batches:
        m = strat.train_step(torch.from_numpy(np.array(x)).long(),
                             torch.from_numpy(np.array(y)).long(), lr)
        out["losses"].append(float(m["loss"]))
    if grad_batch is not None:
        m, grads = strat.reduced_grads(
            *(torch.from_numpy(np.array(t)).long() for t in grad_batch))
        out["grad_loss"] = float(m["loss"])
        out["grads"] = {k: v.numpy().copy() for k, v in grads.items()}
    return out


def tp_grads(comm, model: str, cfg: dict, batch: tuple, params=None,
             states=None) -> dict:
    """The tp strategy's loss and whole gradients on one global batch
    (nothing updated), and the elements the rank holds of each leaf."""
    from torch_dp_ranks import _port_batch
    from torch_shard_ranks import build

    from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
    from ddlbench_tpu_torch.parallel.sharded import TPStrategy

    net = build(model)
    if params is not None:
        from_jax_params(net, params)
    if states is not None:
        from_jax_state(net, states)
    strat = TPStrategy(net, RunConfig(strategy="tp", num_devices=comm.world,
                                      **cfg), comm)
    strat.init()
    x, y = batch
    m, grads = strat.reduced_grads(_port_batch(x),
                                   torch.from_numpy(np.array(y)))
    return {"loss": float(m["loss"]),
            "grads": {k: v.numpy().copy()
                      for k, v in strat.whole_grads(grads).items()},
            "counts": strat.param_counts()}
