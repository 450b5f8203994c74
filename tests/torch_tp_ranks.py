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


def _tpp_rows(strat, tensors_of) -> dict:
    """The rank's rows of the reference's two packed matrices built from
    ``tensors_of(p)`` for each parameter p (its value or its gradient),
    as numpy: {"sliced": [S, L_sl], "repl": [S, L_rp]} (unpadded rows
    zero-padded to the longest)."""
    from ddlbench_tpu_torch.parallel.common import to_ref_layout

    out = {}
    for k, key in enumerate(("sliced", "repl")):
        rows = []
        for c in range(strat.num_chunks):
            leaves = strat._rows(c)[k]
            rows.append(np.concatenate(
                [to_ref_layout(tensors_of(p)).detach().double().reshape(-1)
                 .numpy() for p in leaves]) if leaves else np.zeros(0))
        L = max(max(r.size for r in rows), 1)
        out[key] = np.stack([np.pad(r, (0, L - r.size)) for r in rows])
    return out


def tpp3d(comm, cfg: dict, p0: dict, batches: list, lr: float,
          grad_batch=None, layout_rows: int = 0) -> dict:
    """3-D tpp (or 2-D at dp_replicas 1) through make_strategy on this
    rank, from the reference's packed matrices ``p0`` ({"sliced": [S,
    tp, L_sl], "repl": [S, L_rp]}, convert.load_tpp_rows): the step's
    gradient rows on ``grad_batch`` (summed over the replicas / R, as
    the step applies them), each step's loss and accuracy and the rows
    after it, the eval step on the first batch, and with
    ``layout_rows`` the global row index of every row of each of the
    rank's microbatches (shard_batch)."""
    from ddlbench_tpu_torch.convert import load_tpp_rows
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.parallel.gpipe import mean_over

    strat = make_strategy(RunConfig(strategy="gpipe", **cfg), CPU, comm)
    load_tpp_rows(strat, p0["sliced"], p0["repl"])
    strat.init()
    out = {"rank": comm.rank, "tp_rank": strat.tp_comm.rank,
           "dp_rank": 0 if strat.dp_comm is None else strat.dp_comm.rank,
           "bounds": list(strat.bounds), "losses": [], "accuracy": [],
           "params": [], "p0": _tpp_rows(strat, lambda p: p)}
    if layout_rows:
        ids = torch.arange(layout_rows)[:, None].expand(layout_rows, 4)
        xs, ys = strat.shard_batch(ids, ids)
        out["layout"] = [t[:, 0].tolist() for t in xs]
        out["layout_labels"] = [t[:, 0].tolist() for t in ys]
    if grad_batch is not None:
        m, _ = strat.reduced_grads(*(torch.from_numpy(np.array(t)).long()
                                     for t in grad_batch))
        for c in range(strat.num_chunks):
            grads = [p.grad for p in strat.chunk_params(c)]
            if strat.dp > 1:
                mean_over(strat.dp_comm, grads)
        out["grad_loss"] = float(m["loss"])
        out["grads"] = _tpp_rows(strat, lambda p: p.grad)
    for x, y in batches:
        m = strat.train_step(torch.from_numpy(np.array(x)).long(),
                             torch.from_numpy(np.array(y)).long(), lr)
        out["losses"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append(_tpp_rows(strat, lambda p: p))
    if batches:
        ev = strat.eval_step(*(torch.from_numpy(np.array(t)).long()
                               for t in batches[0]))
        out["eval"] = {k: float(v) for k, v in ev.items()}
    return out
