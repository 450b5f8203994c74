"""Rank cases of the port's sharded one-program strategies (sp, ep, fsdp)
for tests/torch_dp_ranks.RankPool ("torch_shard_ranks:<case>"). This
module imports no JAX: the ranks run the port only, on numpy inputs and
the reference's weights as numpy, and send back numpy."""

from __future__ import annotations

import numpy as np
import torch

from torch_dp_ranks import _port_batch, buffers, build_model

TINY_T, TINY_V = 32, 64
TINY_SRC = 12  # the tiny seq2seq's source length


def build(name: str, capacity_factor: float = 8.0):
    """The port's twin of a reference test model: torch_dp_ranks' models,
    "moe_t" (tests/tiny_models.tiny_moe: transformer_moe_t, T 32, vocab
    64, 8 experts) and "seq2seq_t" (a 2-block d32 prefix-LM over T 32,
    source 12)."""
    from ddlbench_tpu_torch.models import seq2seq
    from ddlbench_tpu_torch.models.moe import build_transformer_moe

    if name == "moe_t":
        return build_transformer_moe("transformer_moe_t", (TINY_T,), TINY_V,
                                     capacity_factor=capacity_factor)
    if name == "seq2seq_t":
        seq2seq._VARIANTS.setdefault(
            "seq2seq_t", dict(d_model=32, n_layers=2, n_heads=4))
        return seq2seq.build_seq2seq("seq2seq_t", (TINY_T,), TINY_V,
                                     TINY_SRC)
    return build_model(name)


def ring(comm, q, k, v, g, prefix_len=0, backend="xla"):
    """ring_attention on this rank's shard of q/k/v [B, H, T, dh] (numpy,
    the whole sequence) under sequence_parallel: (o, dq, dk, dv) of the
    shard, the cotangent of o being the shard of ``g``."""
    from ddlbench_tpu_torch.models.transformer import (ring_attention,
                                                       sequence_parallel,
                                                       set_attention_backend)

    T = q.shape[2]
    Tl = T // comm.world
    cols = slice(comm.rank * Tl, (comm.rank + 1) * Tl)
    ql, kl, vl = (torch.from_numpy(np.array(a[:, :, cols])).requires_grad_()
                  for a in (q, k, v))
    set_attention_backend(backend)
    try:
        with sequence_parallel(comm):
            o = ring_attention(ql, kl, vl, prefix_len)
            grads = torch.autograd.grad(
                o, (ql, kl, vl), torch.from_numpy(np.array(g[:, :, cols])))
    finally:
        set_attention_backend("auto")
    return [t.detach().numpy() for t in (o, *grads)]


def train(comm, strategy: str, model: str, cfg: dict, batches: list,
          lr: float, params=None, states=None, capacity_factor=8.0,
          backend="auto", eval_batch=None) -> dict:
    """``strategy`` (sp, ep or fsdp) through make_strategy's class on the
    port's ``model`` with the reference's weights, over the global
    ``batches``: per-step losses and accuracies, every parameter whole
    (gathered), the buffers, the eval sums on ``eval_batch``, and the
    rank's parameter and optimizer-state bytes."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
    from ddlbench_tpu_torch.models.moe import moe_blocks
    from ddlbench_tpu_torch.models.transformer import set_attention_backend
    from ddlbench_tpu_torch.parallel.api import RANK_CLASSES

    net = build(model, capacity_factor)
    if params is not None:
        from_jax_params(net, params)
    if states is not None:
        from_jax_state(net, states)
    set_attention_backend(backend)
    try:
        strat = RANK_CLASSES[strategy](net, RunConfig(
            strategy=strategy, num_devices=comm.world, **cfg), comm)
        strat.init()
        out = {"param_bytes": strat.param_bytes(),
               "opt_bytes": strat.opt_state_bytes(),
               "losses": [], "accuracy": []}
        for x, y in batches:
            m = strat.train_step(_port_batch(x),
                                 torch.from_numpy(np.array(y)), lr)
            out["losses"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
        if eval_batch is not None:
            ev = strat.eval_step(_port_batch(eval_batch[0]),
                                 torch.from_numpy(np.array(eval_batch[1])))
            out["eval"] = {k: float(v) for k, v in ev.items()}
    finally:
        set_attention_backend("auto")
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in strat.named_params().items()}
    out["buffers"] = buffers(net)
    out["regathers"] = getattr(strat, "regathers", None)
    out["dropped"] = sum(int((~m.last_route.keep).sum())
                         for m in moe_blocks(net) if m.last_route is not None)
    return out


def load_shards(comm, strategy: str, model: str, cfg: dict,
                params) -> dict:
    """A started ``strategy`` rank (the port's seeded weights) given the
    reference's weights through convert.py: ep's expert slices
    (``from_jax_params(..., expert_rank=(r, n))``), fsdp's shards
    (``to_fsdp_shards``); returns every parameter whole (gathered)."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.convert import from_jax_params, to_fsdp_shards
    from ddlbench_tpu_torch.parallel.api import RANK_CLASSES

    net = build(model)
    strat = RANK_CLASSES[strategy](net, RunConfig(
        strategy=strategy, num_devices=comm.world, **cfg), comm)
    strat.init()
    if strategy == "fsdp":
        to_fsdp_shards(strat, params)
    else:
        from_jax_params(net, params, expert_rank=(comm.rank, comm.world))
    return {k: v.detach().numpy().copy()
            for k, v in strat.named_params().items()}
