"""Mixture-of-experts transformer LM (PyTorch port).

The port of ``ddlbench_tpu/models/moe.py`` on one card (the reference's
expert-parallel all_to_all waits with the ep strategy, ROADMAP A.7):
dense and Switch-routed blocks alternate, the MoE blocks at the odd
indices. An MoE block is the transformer's attention half
(models/transformer.py ``AttentionBlock``) with a bank of ``E`` expert
MLPs, stacked as ``experts.w1`` [E, d, 4d], ``b1`` [E, 4d], ``w2``
[E, 4d, d], ``b2`` [E, d] (the reference's names, so convert.py carries
them over), and a router ``gate`` [d, E].

Routing (:func:`switch_route`) is the reference's top-1 Switch rule, in
float32: softmax over the router logits, the first maximum (``argmax``,
as ``jnp.argmax``), the chosen expert's probability as the gate, and a
static capacity ``C = max(1, ceil(cf * S / E))`` per expert, S the
micro-batch's tokens. A token's 1-based place in its expert's queue is
the running count of its one-hot; tokens past C are dropped and pass
through the residual. The load-balance loss (Switch eq. 4) is
``E * sum_e fraction_e * mean_prob_e``.

Dispatch and combine go by index, where the reference multiplies dense
one-hot [S, E, C] tensors: the token of each (expert, slot) is gathered
into an [E, C, d] buffer (empty slots read a zero row), the experts run
as two ``torch.bmm`` over the stack, and each kept token gathers its
slot's output back, times its gate rounded to the compute dtype. Each
gather reads a row at most once, so its backward is the gather by the
inverse map (:class:`_RowGather`), not a scatter-add. Only one
term of each one-hot sum is non-zero and the dispatch weights are 0/1,
so both forms compute the same function (tests/test_torch_moe.py holds
them equal, drops included); at transformer_moe_s's training shape (S
16 384, E 8, C 2 560) one dense [S, E, C] tensor would hold 335 M
elements.

Each MoE block keeps the :class:`Route` of its last forward
(``last_route``: the experts, the kept mask, the router's probabilities
and the aux loss), and
:func:`aux_losses` reads them: parallel/common.loss_with_moe_aux adds
``moe_aux_weight`` times their sum to the objective, as the reference's
trace-time collector does. A checkpointed forward would record twice, so
RunConfig refuses ``remat_layers`` with an MoE arch, as the reference
does.

Decoding (models/decode.py): the prompt's prefill runs the
capacity-limited layer; a decoded position runs its top-1 expert with no
capacity limit (:meth:`MoEBlock.mlp_one`, the reference's
``_moe_ffn_token``: every expert on the one position, then the chosen
one's output times its gate), so decoding matches the training forward
whenever the capacity dropped nothing. The attention half reuses the
transformer block's dense and paged cache ops (B7, and B1's prefix path
on the prefill). MoE blocks have no serving ops, as in the reference.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.transformer import (AttentionBlock, Embed,
                                                   LMHead, TransformerBlock,
                                                   _normal)

_VARIANTS = {
    # _t is the test size (the reference's tests/tiny_models.py value)
    "transformer_moe_t": dict(d_model=32, n_layers=2, n_heads=4, n_experts=8),
    # every other block is MoE (Switch/GShard convention)
    "transformer_moe_s": dict(d_model=512, n_layers=8, n_heads=8,
                              n_experts=8),
}


class Route(NamedTuple):
    """Top-1 routing of S tokens over E experts."""

    expert: torch.Tensor  # [S] int64, the chosen expert
    slot: torch.Tensor  # [S] int64, 0-based place in its expert's queue
    keep: torch.Tensor  # [S] bool, within the capacity
    gate: torch.Tensor  # [S] float32, the chosen expert's probability
    probs: torch.Tensor  # [S, E] float32, the router's probabilities
    aux: torch.Tensor  # float32 scalar, the load-balance loss


def top1_gate(gate_logits: torch.Tensor):
    """(probs float32 [S, E], chosen expert [S], its probability [S]):
    the routing core shared by training and decoding."""
    probs = torch.softmax(gate_logits.float(), -1)
    expert = probs.argmax(-1)
    return probs, expert, probs.gather(-1, expert[:, None])[:, 0]


def capacity(capacity_factor: float, tokens: int, n_experts: int) -> int:
    return max(1, math.ceil(capacity_factor * tokens / n_experts))


def switch_route(gate_logits: torch.Tensor, cap: int) -> Route:
    """Top-1 Switch routing over [S, E] router logits with ``cap`` slots
    an expert (module docstring). The running counts are taken along
    the contiguous axis of the [E, S] one-hot, where a scan is fast."""
    S, E = gate_logits.shape
    probs, expert, gate = top1_gate(gate_logits)
    onehot = F.one_hot(expert, E).t().contiguous()  # [E, S]
    aux = E * (onehot.float().mean(1) * probs.mean(0)).sum()
    pos1 = onehot.cumsum(1).gather(0, expert[None])[0]
    return Route(expert, pos1 - 1, pos1 <= cap, gate, probs, aux)


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros(1, t.shape[1])])


class _RowGather(torch.autograd.Function):
    """``[src; 0][index]`` where each row of ``src`` is read at most once,
    and ``inverse`` names the output row that reads each source row (the
    zero row's index where none does): the backward is then the gather
    ``[grad; 0][inverse]``, where autograd would scatter-add the
    gradient through a sort of ``index``."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _pad_row(src)[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return _pad_row(grad)[inverse], None, None


def expert_ffn(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """The stacked experts' MLPs: x [E, C, d] -> [E, C, d]."""
    h = F.gelu(torch.bmm(x, w1.to(x.dtype)) + b1.to(x.dtype)[:, None],
               approximate="tanh")
    return torch.bmm(h, w2.to(x.dtype)) + b2.to(x.dtype)[:, None]


class Experts(nn.Module):
    """E expert MLPs stacked on a leading axis."""

    def __init__(self, n_experts: int, d: int, f: int,
                 gen: torch.Generator):
        super().__init__()
        self.w1 = _normal(gen, n_experts, d, f)
        self.b1 = nn.Parameter(torch.zeros(n_experts, f))
        self.w2 = _normal(gen, n_experts, f, d)
        self.b2 = nn.Parameter(torch.zeros(n_experts, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return expert_ffn(x, self.w1, self.b1, self.w2, self.b2)


def moe_mlp(x: torch.Tensor, gate_w: torch.Tensor, experts: Experts,
            capacity_factor: float):
    """The Switch MoE feed-forward over x [B, T, d], by index (module
    docstring): returns (y [B, T, d], the route)."""
    B, T, d = x.shape
    S, E = B * T, gate_w.shape[1]
    C = capacity(capacity_factor, S, E)
    xf = x.reshape(S, d)
    route = switch_route(xf.float() @ gate_w.float(), C)
    # each token's (expert, slot) row of the [E * C, d] buffer; a dropped
    # token's is E * C, the zero row
    flat = torch.where(route.keep, route.expert * C + route.slot, E * C)
    # the token of each (expert, slot): S (the zero row) where it is
    # empty; dropped tokens all land on the spare entry E * C
    token = torch.full((E * C + 1,), S, dtype=torch.long, device=x.device)
    token = token.scatter_(0, flat, torch.arange(S, device=x.device))[:-1]
    expert_in = _RowGather.apply(xf, token, flat).view(E, C, d)
    out = _RowGather.apply(experts(expert_in).reshape(E * C, d), flat,
                           token)
    w = (route.gate * route.keep).to(x.dtype)
    return (out * w[:, None]).reshape(B, T, d), route


class MoEBlock(AttentionBlock):
    """Pre-LN block whose MLP is a switch-routed expert bank (module
    docstring). Not a serving layer."""

    def __init__(self, d_model: int, n_heads: int, n_experts: int,
                 gen: torch.Generator, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25):
        super().__init__(d_model, n_heads, gen)
        self.capacity_factor = capacity_factor
        self.gate = _normal(gen, d_model, n_experts)
        self.experts = Experts(n_experts, d_model, mlp_ratio * d_model, gen)
        self.last_route = None

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        y, self.last_route = moe_mlp(self.ln2(x), self.gate, self.experts,
                                     self.capacity_factor)
        return x + y

    def mlp_one(self, x: torch.Tensor) -> torch.Tensor:
        """One decoded position x [B, 1, d]: each row's top-1 expert, no
        capacity limit."""
        h = self.ln2(x)[:, 0]
        _, expert, gate = top1_gate(h.float() @ self.gate.float())
        e = self.experts
        eh = F.gelu(torch.einsum("bd,edf->bef", h, e.w1.to(h.dtype))
                    + e.b1.to(h.dtype)[None], approximate="tanh")
        ey = (torch.einsum("bef,efd->bed", eh, e.w2.to(h.dtype))
              + e.b2.to(h.dtype)[None])
        rows = torch.arange(h.shape[0], device=h.device)
        return x + (ey[rows, expert] * gate.to(h.dtype)[:, None])[:, None]


def moe_blocks(model: LayerModel) -> List[MoEBlock]:
    return [m for m in model.modules() if isinstance(m, MoEBlock)]


def aux_losses(model: LayerModel) -> List[torch.Tensor]:
    """The load-balance losses of the MoE blocks' last forward (empty for
    a dense model)."""
    return [m.last_route.aux for m in moe_blocks(model)]


def build_transformer_moe(arch: str, in_shape, vocab: int,
                          capacity_factor: float = 1.25,
                          seed: int = 0) -> LayerModel:
    """The ``arch`` MoE LM with random weights from ``seed`` (a
    torch.Generator; convert.py carries JAX weights over): dense and MoE
    blocks alternate, the MoE blocks at the odd indices. Built on the
    CPU; move it with ``.to(device)``."""
    cfgv = _VARIANTS[arch]
    gen = torch.Generator().manual_seed(seed)
    d, H = cfgv["d_model"], cfgv["n_heads"]
    layers: List[nn.Module] = [Embed(vocab, d, in_shape[0], gen)]
    for i in range(cfgv["n_layers"]):
        layers.append(MoEBlock(d, H, cfgv["n_experts"], gen,
                               capacity_factor=capacity_factor)
                      if i % 2 == 1 else TransformerBlock(d, H, gen))
    layers.append(LMHead(d, vocab, gen))
    return LayerModel(arch, layers, tuple(in_shape), vocab)
