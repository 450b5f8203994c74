"""Decoder-only transformer LM as a flat layer chain (PyTorch port).

The port of ``ddlbench_tpu/models/transformer.py``: an embedding, pre-LN
blocks (learned positions, GELU MLP 4x; :class:`AttentionBlock` is the
attention half with the cache ops, which models/moe.py's expert block
shares) and an untied LM head, for
training, serving (the ``ServeLayer`` ops) and cached decoding (the
``DecodeLayer`` ops of models/decode.py: the dense cache, read by plain
masked attention as the reference's ``attn_decode_op`` is, and the paged
beam cache, read by the decode kernel), each an
``nn.Module`` whose parameters keep the reference's names and layouts —
dense weights are ``[in, out]`` and every projection is ``x @ W``, as in
the JAX code, so converted weights (convert.py) are used as they are.

Attention dispatches like the reference's (:func:`set_attention_backend`):
``"flash"`` takes the flash kernels (ops/flash_attention.py) and raises on
CUDA operands they refuse, ``"xla"`` the plain einsum, and ``"auto"`` the
kernels exactly where they take the operands
(``flash_attention.kernel_takes``: a CUDA device, head dim 64, float32 or
bfloat16), else the plain einsum, as the reference's ``auto`` takes its XLA
path for shapes its kernel does not take. An ``"auto"`` call on CUDA
operands the kernels refuse is counted in
``flash_attention.plain_launches``. The serving passes and the paged
decode step dispatch the paged ops the same way
(``paged_decode.kernel_takes``). The reference's
TPU-measured length crossover for ``"auto"`` is not carried over; the
card's is still to be measured.

Three numerics of the reference are kept on purpose (tests pin them):

* ``jax.nn.gelu`` defaults to the tanh approximation, so the MLP uses
  ``F.gelu(..., approximate="tanh")``.
* :func:`layer_norm` is one-pass: ``mean(x^2) - mean(x)^2`` clamped at 0,
  eps 1e-5, computed in float32 and cast back before the affine —
  ``F.layer_norm`` computes the variance differently.
* ``wqkv``'s output splits into contiguous thirds q | k | v, each viewed as
  ``[B, T, H, dh]``.

Sequence parallelism (parallel/sp.py) runs the same layers inside
:class:`sequence_parallel`, which carries the rank's Comm: each rank
holds the contiguous T/n slice ``comm.rank`` of every sequence, the
embedding takes that slice's positions (:func:`shard_positions`), and
attention runs :func:`ring_attention` on every rank's K/V block,
all-gathered as one stacked tensor (the backward reduce-scatters their
gradients). The rank is a Python int, so each rank knows which of the n
blocks its queries see: a block masked whole is skipped, the others go
through :func:`ops.flash_attention.flash_attention_lse` at absolute
offsets and combine exactly through their logsumexps (the reference's
flash ring), or, under the ``"xla"`` backend, through the reference's
float32 online-softmax einsum ring. A causal rank r runs r + 1 blocks,
so B1-B3 launch n(n+1)/2 times per layer over the ranks.

Tensor parallelism is Megatron's slicing (the reference's
``tensor_parallel`` and ``tp_split_layer_params``): a shard of a dense
block holds its contiguous group of heads (a column slice of ``wqkv`` out
of each of q | k | v, and the matching row slice of ``wo``) and its slice
of the MLP's columns (``w1``/``b1`` columns, ``w2`` rows); LayerNorms and
``b2`` stay whole. Whether a block is sliced is read from the parameters
it holds, as the reference reads it: a block the splitter leaves whole
(an MoE block) computes the whole result and sums nothing. A sliced
block's two row-parallel products are summed in the compute dtype, after
the matmul and before the residual and ``b2``: over the ranks of the
active :class:`tensor_parallel` context (one shard a rank: tpp and the
``tp`` strategy, through distributed.sum_forward, the replicated inputs
entering through sum_backward), or, for the serving engine's shards in
one process (the serve ops' ``shards``), in shard order.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddlbench_tpu_torch.config import ATTENTION_BACKENDS
from ddlbench_tpu_torch.distributed import (AxisContext, all_gather_grad,
                                            sum_backward, sum_forward)
from ddlbench_tpu_torch.models.layers import (DecodeLayer, LayerModel,
                                              ServeLayer)
from ddlbench_tpu_torch.ops import flash_attention as fa
from ddlbench_tpu_torch.ops.flash_attention import flash_attention
from ddlbench_tpu_torch.ops.fused_xent import (fused_linear_xent,
                                              fused_linear_xent_eval)
from ddlbench_tpu_torch.ops.paged_decode import (paged_attention_auto,
                                                 paged_cache_init,
                                                 paged_chunk_attention_auto,
                                                 paged_decode_write,
                                                 paged_prefill_write,
                                                 paged_reorder,
                                                 paged_table_chunk_write,
                                                 paged_table_span_write,
                                                 paged_table_write,
                                                 pool_shard,
                                                 serve_pool_init)

LN_EPS = 1e-5

_VARIANTS = {
    # _t is the test size (the reference's tests/tiny_models.py value)
    "transformer_t": dict(d_model=32, n_layers=2, n_heads=4),
    "transformer_s": dict(d_model=512, n_layers=8, n_heads=8),
    "transformer_m": dict(d_model=768, n_layers=12, n_heads=12),
}


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """f32-accumulated one-pass LayerNorm over the feature axis,
    compute-dtype out (the reference's ``layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + LN_EPS)
    y = (xf - mean) * inv
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def _normal(gen: torch.Generator, *shape: int, std: float = 0.02):
    return nn.Parameter(torch.randn(*shape, generator=gen) * std)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


_ATTENTION_BACKEND = ["auto"]


class sequence_parallel(AxisContext):
    """While active, the model runs sequence-parallel on the rank of
    ``comm`` (distributed.Comm): the embedding reads this rank's
    positions and attention runs the ring (module docstring; the
    reference's ``sequence_parallel`` axis context)."""


class tensor_parallel(AxisContext):
    """While active, a Megatron-sliced block sums its row-parallel
    products over the ranks of ``comm``, each rank holding one shard
    (module docstring; the reference's ``tensor_parallel`` axis
    context)."""


# the dense block's leaves sliced per shard; everything else (LN scales
# and biases, b2, embeddings, heads, MoE blocks) stays whole
TP_SLICED_KEYS = ("wqkv", "wo", "w1", "b1", "w2")


def tp_split_layer_params(p, n: int):
    """Split one layer's parameters ({name: array}: the reference's nested
    dict of numpy arrays, or the port's named tensors) n ways: returns
    ``(shards, repl)``, ``shards[s]`` shard s's sliced leaves and ``repl``
    the rest, kept whole. A layer that is not a dense block (no wqkv, wo,
    w1 and w2 at its top level) comes back whole, ``shards[s] == {}``.
    The reference's splitter, for both packages' arrays."""
    if not (isinstance(p, dict) and {"wqkv", "wo", "w1", "w2"} <= set(p)):
        return [{} for _ in range(n)], p
    d = p["wo"].shape[1]
    f = p["w1"].shape[1]
    if d % n or f % n:
        raise ValueError(
            f"tensor parallelism: d_model={d} / mlp width={f} not divisible "
            f"by tp_size={n}")
    dl, fl = d // n, f // n
    shards = [{
        # the same head group out of each of the q | k | v blocks, so the
        # shard's qkv still splits into thirds
        "wqkv": p["wqkv"].reshape(d, 3, d)[:, :, s * dl:(s + 1) * dl]
                .reshape(d, 3 * dl),
        "wo": p["wo"][s * dl:(s + 1) * dl, :],
        "w1": p["w1"][:, s * fl:(s + 1) * fl],
        "b1": p["b1"][s * fl:(s + 1) * fl],
        "w2": p["w2"][s * fl:(s + 1) * fl, :],
    } for s in range(n)]
    repl = {k: v for k, v in p.items() if k not in TP_SLICED_KEYS}
    return shards, repl


def tp_merge_layer_params(shards, repl) -> dict:
    """Inverse of :func:`tp_split_layer_params` on tensors: the layer's
    whole parameters from its shards' slices and the rest."""
    out = dict(repl)
    if not shards[0]:
        return out
    d, w = shards[0]["wqkv"].shape
    out["wqkv"] = torch.cat([s["wqkv"].reshape(d, 3, w // 3)
                             for s in shards], 2).reshape(d, -1)
    for key, dim in (("wo", 0), ("w1", 1), ("b1", 0), ("w2", 0)):
        out[key] = torch.cat([s[key] for s in shards], dim)
    return out


def slice_block(block: nn.Module, rank: int, n: int) -> bool:
    """Replace a dense block's sliced parameters by shard ``rank`` of
    ``n``'s slices, in place; returns whether the block was sliced (a
    layer the splitter leaves whole is left as it is)."""
    named = dict(block.named_parameters())
    shards, _ = tp_split_layer_params(
        {k: v.detach() for k, v in named.items()}, n)
    if not shards[0]:
        return False
    if n > 1 and getattr(block, "n_heads", 0) % n:
        raise ValueError(f"tensor parallelism: n_heads={block.n_heads} not "
                         f"divisible by tp_size={n}")
    for key, t in shards[rank].items():
        setattr(block, key, nn.Parameter(t.contiguous().clone()))
    return True


def _tp_enter(h: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a sliced branch: its gradient is
    summed over the active tensor_parallel ranks."""
    comm = tensor_parallel.current()
    return h if comm is None else sum_backward(h, comm)


def _tp_sum(t: torch.Tensor) -> torch.Tensor:
    """A sliced block's row-parallel product summed over the active
    tensor_parallel ranks."""
    comm = tensor_parallel.current()
    if comm is None:
        raise RuntimeError(
            "a Megatron-sliced block runs inside tensor_parallel (one shard "
            "a rank) or on the serving engine's shards")
    return sum_forward(t, comm)


def _sum_shards(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' partial products summed in shard order."""
    out = parts[0]
    for t in parts[1:]:
        out = out + t
    return out


def shard_positions(pos_table: torch.Tensor, T: int):
    """(position embeddings [T, d], absolute positions [T]) of the local
    sequence shard: rows [0, T) outside sequence parallelism, this rank's
    contiguous slice (offset rank x T) inside it; every embedding
    (transformer and seq2seq) reads its positions here."""
    comm = sequence_parallel.current()
    offset = 0 if comm is None else comm.rank * T
    return (pos_table[offset:offset + T],
            torch.arange(offset, offset + T, device=pos_table.device))


def set_attention_backend(backend: str) -> None:
    """Select the attention path of every block: auto | flash | xla."""
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")
    _ATTENTION_BACKEND[0] = backend


def _use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether :func:`causal_attention` takes the flash kernels under the
    current backend (module docstring). Counts an ``"auto"`` call the
    kernels refuse on CUDA; raises for a forced ``"flash"`` one."""
    mode = _ATTENTION_BACKEND[0]
    if mode == "xla":
        return False
    if q.device.type == "cpu":
        return mode == "flash"  # the wrappers' plain versions
    if fa.kernel_takes(q, k, v):
        return True
    if mode == "flash":
        raise ValueError(
            f"attention backend 'flash': the flash kernels do not take q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype} on "
            f"{q.device} (head dim {fa.KERNEL_DH}, float32 or bfloat16); use "
            "'auto' or 'xla'")
    flash_attention.plain_launches += 1
    return False


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, k_offset: int = 0,
                     prefix_len: int = 0) -> torch.Tensor:
    """Masked attention for blocks of a causal (or prefix-LM) sequence:
    q [B, H, Tq, dh], k/v [B, H, Tk, dh]; offsets give each block's
    absolute position, and key positions < ``prefix_len`` are visible to
    every query. Takes the flash kernels when the backend says so (module
    docstring); else the reference's plain path, where a fully masked row
    returns 0."""
    if _use_flash(q, k, v):
        return flash_attention(q, k, v, q_offset, k_offset, prefix_len)
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
    ok = q_pos >= k_pos
    if prefix_len:
        ok = ok | (k_pos < prefix_len)
    scores = scores.masked_fill(~ok, -math.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    z = e.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", e / torch.clamp(z, min=1e-20), v)


def _block_visible(r: int, src: int, Tl: int, prefix_len: int) -> bool:
    """Whether rank r's queries see any key of rank src's block (causal:
    src <= r; prefix-LM: also a block opening inside the prefix)."""
    return src <= r or src * Tl < prefix_len


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   prefix_len: int = 0) -> torch.Tensor:
    """Causal (or prefix-LM) attention over a sequence sharded across the
    ranks of the active :class:`sequence_parallel` context: q/k/v
    [B, H, Tl, dh] are this rank's shard. Every rank's stacked K/V block
    comes in one all-gather (distributed.all_gather_grad: one collective,
    the same on every rank, forward and backward); rank r combines the
    blocks its queries see in the reference's ring order r, r - 1, ...
    (module docstring): through the flash kernels' (o, lse), or, where
    the backend takes the plain path, the reference's float32 online
    softmax. Returns [B, H, Tl, dh] in q's dtype."""
    comm = sequence_parallel.current()
    r, n = comm.rank, comm.world
    B, H, Tl, dh = q.shape
    flash = _use_flash(q, k, v)
    q_pos = r * Tl + torch.arange(Tl, device=q.device)[:, None]
    qf = q.float()
    kv = torch.stack([k, v])
    # every rank's block in rank order (at world 1 there is none to gather)
    kvs = (all_gather_grad(kv, comm) if n > 1 else kv).view(n, 2, B, H, Tl,
                                                            dh)
    for i in range(n):
        src = (r - i) % n  # the ring's i-th block: rank src's K/V
        if not _block_visible(r, src, Tl, prefix_len):
            continue
        kb, vb = kvs[src, 0], kvs[src, 1]
        if flash:
            o_i, lse_i = fa.flash_attention_lse(q, kb, vb, r * Tl, src * Tl,
                                                prefix_len)
            if i == 0:  # the diagonal block: every row sees a key
                o, lse = o_i.float(), lse_i
                continue
            new_lse = torch.logaddexp(lse, lse_i)
            safe = torch.clamp(new_lse, min=fa.NEG_INF)
            o = (o * torch.exp(lse - safe)[..., None]
                 + o_i.float() * torch.exp(lse_i - safe)[..., None])
            lse = new_lse
            continue
        k_pos = src * Tl + torch.arange(Tl, device=q.device)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) / math.sqrt(dh)
        ok = q_pos >= k_pos
        if prefix_len:
            ok = ok | (k_pos < prefix_len)
        s = s.masked_fill(~ok, -math.inf)
        if i == 0:
            m = torch.full((B, H, Tl, 1), -math.inf, device=q.device)
            l = torch.zeros((B, H, Tl, 1), device=q.device)
            acc = torch.zeros((B, H, Tl, dh), device=q.device)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        safe_m = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - safe_m)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
        m = m_new
    if flash:
        return o.to(q.dtype)
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


class Embed(ServeLayer, DecodeLayer):
    """Token + learned position embedding: x [B, T] int -> [B, T, d], in
    the tables' dtype (the compute dtype under layers.apply_model's cast,
    as in the reference's apply on cast params). Cache-free in both the
    serving and the decode protocol."""

    def __init__(self, vocab: int, d_model: int, max_len: int,
                 gen: torch.Generator):
        super().__init__()
        self.tok = _normal(gen, vocab, d_model)
        self.pos = _normal(gen, max_len, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # T is the local shard's length under sequence parallelism
        return self.tok[x] + shard_positions(self.pos, x.shape[1])[0]

    def decode(self, cache, x, pos):
        # x [B, 1] at absolute position pos
        return self.tok[x] + self.pos[pos:pos + 1], cache

    def serve_prefill(self, pool, table, x, start, npl, page):
        # chunk x [R, C] at positions [start, start + C). Padded positions
        # past the position table are clamped to its last row (the
        # reference's jnp.take fills them with NaN; torch indexing would
        # fault) — their outputs are discarded either way
        idx = torch.arange(start, start + x.shape[1], device=x.device)
        return self.tok[x] + self.pos[idx.clamp(max=self.pos.shape[0] - 1)]

    def serve_decode(self, pool, table, x, pos, npl, page):
        # x [B, 1] at PER-ROW positions pos [B]
        return self.tok[x] + self.pos[pos.long()][:, None]

    def serve_verify(self, pool, table, x, pos0, npl, page):
        # x [B, W] draft spans at per-row positions [pos0, pos0 + W); pad
        # positions past the position table are clamped as in
        # serve_prefill (their outputs are discarded)
        idx = pos0.long()[:, None] + torch.arange(x.shape[1],
                                                  device=x.device)
        return self.tok[x] + self.pos[idx.clamp(max=self.pos.shape[0] - 1)]


class AttentionBlock(DecodeLayer):
    """The attention half of a pre-LN block, x + attn(ln1(x)), then the
    subclass's feed-forward sublayer: ``mlp(x)`` over a whole sequence
    (the residual included) and ``mlp_one(x)`` over one decoded position.
    ``prefix_len`` > 0 switches the attention to the prefix-LM mask (the
    seq2seq workload). The decode ops (models/decode.py) take either
    mask: a prompt's prefill attends through :func:`causal_attention`
    with ``prefix_len``, and a decoded position sees every cached key
    before it, which the prefix rule adds nothing to."""

    cached = True
    paged = True

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 prefix_len: int = 0):
        super().__init__()
        self.n_heads = n_heads
        self.prefix_len = prefix_len
        self.dh = d_model // n_heads
        d = d_model
        self.ln1 = LayerNorm(d)
        self.wqkv = _normal(gen, d, 3 * d)
        self.wo = _normal(gen, d, d)
        self.ln2 = LayerNorm(d)

    def _qkv_heads(self, x: torch.Tensor,
                   p: Optional[dict] = None) -> List[torch.Tensor]:
        """q, k, v as [B, H, T, dh] from contiguous thirds of ln1(x) @
        wqkv: the block's own wqkv, or serving shard ``p``'s slice. H is
        the number of heads that wqkv holds (n_heads / tp for a slice);
        a sliced block's own input enters through the rank sum of its
        gradient."""
        B, T, d = x.shape
        wqkv = self.wqkv if p is None else p["wqkv"]
        h = self.ln1(x)
        if p is None and wqkv.shape[1] < 3 * d:
            h = _tp_enter(h)
        qkv = h @ wqkv.to(x.dtype)
        w = qkv.shape[-1] // 3
        return [t.reshape(B, T, w // self.dh, self.dh).transpose(1, 2)
                for t in qkv.split(w, dim=-1)]

    def _proj(self, o2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Output projection + residual of the attention sublayer; ``o2``
        is the [B, T, H * dh] attention output of the block's heads. A
        row slice of wo sums its product over the tensor_parallel
        ranks."""
        proj = o2 @ self.wo.to(x.dtype)
        if self.wo.shape[0] < x.shape[-1]:
            proj = _tp_sum(proj)
        return x + proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        q, k, v = self._qkv_heads(x)
        if sequence_parallel.current() is not None:
            o = ring_attention(q, k, v, self.prefix_len)
        else:
            o = causal_attention(q, k, v, prefix_len=self.prefix_len)
        x = self._proj(o.transpose(1, 2).reshape(B, T, -1), x)
        return self.mlp(x)

    # -- the cached-decode protocol (models/decode.py) ---------------------

    def _prompt(self, x, start, record):
        """The attention sublayer over a whole prompt, K/V handed to
        ``record(k, v)`` as [B, H, T, dh], then the MLP. The prompt must
        open the stream: attention runs within it."""
        assert start == 0, "chunked prefill (start > 0) is not implemented"
        B, T, d = x.shape
        q, k, v = self._qkv_heads(x)
        record(k, v)
        o = causal_attention(q, k, v, start, start, self.prefix_len)
        return self.mlp(self._proj(o.transpose(1, 2).reshape(B, T, -1), x))

    def init_cache(self, batch, max_len, dtype, device):
        shape = (batch, self.n_heads, max_len, self.dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, cache, x, start):
        def record(k, v):
            T = k.shape[2]
            cache["k"][:, :, start:start + T] = k
            cache["v"][:, :, start:start + T] = v

        return self._prompt(x, start, record), cache

    def decode(self, cache, x, pos):
        """One token at position ``pos`` against the dense cache: the
        reference's plain masked attention over the whole cache (keys at
        positions <= pos), no kernel."""
        B, _, d = x.shape
        q, k, v = self._qkv_heads(x)  # [B, H, 1, dh]
        cache["k"][:, :, pos] = k[:, :, 0]
        cache["v"][:, :, pos] = v[:, :, 0]
        kc, vc = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, kc) / math.sqrt(self.dh)
        k_pos = torch.arange(kc.shape[2], device=x.device)
        scores = scores.masked_fill(k_pos > pos, -math.inf)
        probs = torch.softmax(scores.float(), -1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, vc)
        x = self._proj(o.transpose(1, 2).reshape(B, 1, d), x)
        return self.mlp_one(x), cache

    def paged_init_cache(self, batch, max_len, dtype, device):
        return paged_cache_init(batch, max_len, self.n_heads, self.dh, dtype,
                                device=device)

    def paged_prefill(self, cache, x, start):
        page = cache["pool_k"].shape[1]

        def record(k, v):
            paged_prefill_write(cache, k.transpose(1, 2), v.transpose(1, 2),
                                page, start)

        return self._prompt(x, start, record), cache

    def paged_decode(self, cache, x, pos, npl):
        """Write the token's K/V into each row's own slot, then
        single-query attention over the ``npl`` live pages (the decode
        kernel on the card)."""
        B, _, d = x.shape
        page = cache["pool_k"].shape[1]
        q, k, v = self._qkv_heads(x)  # [B, H, 1, dh]
        paged_decode_write(cache, k.transpose(1, 2), v.transpose(1, 2), pos,
                           page)
        o = paged_attention_auto(q[:, :, 0].contiguous(), cache, pos, npl,
                                 page)
        x = self._proj(o.reshape(B, 1, d), x)
        return self.mlp_one(x), cache

    def paged_reorder(self, cache, parent, pos):
        return paged_reorder(cache, parent, pos, cache["pool_k"].shape[1])


class TransformerBlock(AttentionBlock, ServeLayer):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp(ln2(x)) + b2 (the
    dense GELU MLP, 4x), with the serving ops (causal-LM only). The
    serving ops take the engine's tensor-parallel ``shards`` (one dict of
    :data:`TP_SLICED_KEYS` slices a shard, the pool's per-slot tensors
    stacked on a leading [tp] axis): each shard writes and attends its
    heads in its slice of the pool, and the shards' row-parallel products
    are summed in shard order."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 mlp_ratio: int = 4, prefix_len: int = 0):
        super().__init__(d_model, n_heads, gen, prefix_len)
        d, f = d_model, mlp_ratio * d_model
        self.mlp_width = f
        self.w1 = _normal(gen, d, f)
        self.b1 = nn.Parameter(torch.zeros(f))
        self.w2 = _normal(gen, f, d)
        self.b2 = nn.Parameter(torch.zeros(d))

    def _mlp_part(self, x: torch.Tensor,
                  p: Optional[dict] = None) -> torch.Tensor:
        """gelu(ln2(x) @ w1 + b1) @ w2 over the block's MLP columns, or
        serving shard ``p``'s: a partial product where they are a
        slice."""
        w1, b1, w2 = ((self.w1, self.b1, self.w2) if p is None
                      else (p["w1"], p["b1"], p["w2"]))
        h = self.ln2(x)
        if p is None and w1.shape[1] < self.mlp_width:
            h = _tp_enter(h)
        h = F.gelu(h @ w1.to(x.dtype) + b1.to(x.dtype), approximate="tanh")
        return h @ w2.to(x.dtype)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        proj = self._mlp_part(x)
        if self.w1.shape[1] < self.mlp_width:
            proj = _tp_sum(proj)
        return x + proj + self.b2.to(x.dtype)

    mlp_one = mlp

    # -- the serving protocol (serve/engine.py) ----------------------------

    def pool_init(self, n_pages, page, dtype, device, tp: int = 1):
        """The layer's pool; at ``tp`` > 1 each shard's [n_pages, page,
        n_heads / tp, dh] slice stacked on a leading [tp] axis."""
        if tp == 1:
            return serve_pool_init(n_pages, page, self.n_heads, self.dh,
                                   dtype, device)
        return serve_pool_init(n_pages, page, self.n_heads // tp, self.dh,
                               dtype, device, shards=tp)

    def _serve(self, x, pool, shards, attend):
        """The block over a serving pass: ``attend(p, pool)`` writes a
        shard's K/V and returns its attention output [B, T, H * dh] (p
        None: the block's own parameters and whole pool)."""
        if shards is None:
            return self.mlp(self._proj(attend(None, pool), x))
        x = x + _sum_shards([attend(p, pool_shard(pool, s))
                             @ p["wo"].to(x.dtype)
                             for s, p in enumerate(shards)])
        return (x + _sum_shards([self._mlp_part(x, p) for p in shards])
                + self.b2.to(x.dtype))

    def serve_prefill(self, pool, table, x, start, npl, page, shards=None):
        """Write the page-aligned chunk's K/V through the shared table,
        then attend the chunk queries against the live pages."""
        B, C, _ = x.shape

        def attend(p, pool):
            q, k, v = self._qkv_heads(x, p)  # [B, H, C, dh]
            cache = {**pool, "table": table}
            paged_table_chunk_write(cache, k.transpose(1, 2),
                                    v.transpose(1, 2), start, page)
            o = paged_chunk_attention_auto(q.contiguous(), cache, start, npl,
                                           page)
            return o.transpose(1, 2).reshape(B, C, -1)

        return self._serve(x, pool, shards, attend)

    def serve_decode(self, pool, table, x, pos, npl, page, shards=None):
        """Write each row's token K/V at its own position through the
        table, then single-query attention over the live pages."""
        B = x.shape[0]

        def attend(p, pool):
            q, k, v = self._qkv_heads(x, p)  # [B, H, 1, dh]
            cache = {**pool, "table": table}
            paged_table_write(cache, k.transpose(1, 2), v.transpose(1, 2),
                              pos, page)
            o = paged_attention_auto(q[:, :, 0].contiguous(), cache, pos,
                                     npl, page)
            return o.reshape(B, 1, -1)

        return self._serve(x, pool, shards, attend)

    def serve_verify(self, pool, table, x, pos0, npl, page, shards=None):
        """The speculative verify pass: write the W-token span's K/V at
        page-unaligned per-row positions [pos0, pos0 + W), then attend all
        W queries causally at their absolute positions (the chunk kernel
        with per-row starts)."""
        B, W, _ = x.shape

        def attend(p, pool):
            q, k, v = self._qkv_heads(x, p)  # [B, H, W, dh]
            cache = {**pool, "table": table}
            paged_table_span_write(cache, k.transpose(1, 2),
                                   v.transpose(1, 2), pos0, page)
            o = paged_chunk_attention_auto(q.contiguous(), cache, pos0, npl,
                                           page)
            return o.transpose(1, 2).reshape(B, W, -1)

        return self._serve(x, pool, shards, attend)


class LMHead(nn.Module):
    """Final LayerNorm + untied vocabulary projection (pointwise: the
    serving engine applies it with ``forward``). ``fused_loss`` and
    ``fused_eval`` take the loss without the [B*T, V] logits
    (ops/fused_xent.py); both run on casts of the head's parameters to x's
    dtype inside autograd, so gradients land on the float32 masters.
    ``pointwise``: the decoders (models/decode.py) run it on one position
    through ``forward`` too."""

    pointwise = True

    def __init__(self, d_model: int, vocab: int, gen: torch.Generator):
        super().__init__()
        self.ln_f = LayerNorm(d_model)
        self.head = _normal(gen, d_model, vocab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_f(x) @ self.head.to(x.dtype)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_f(x).reshape(-1, x.shape[-1])

    def fused_parts(self, x: torch.Tensor):
        """The fused loss's two operands: the normalised rows [N, d] and
        the projection cast to x's dtype. The pipelines' split backward
        differentiates the loss in one of them at a time."""
        return self._rows(x), self.head.to(x.dtype)

    def fused_loss(self, x: torch.Tensor, labels: torch.Tensor,
                   smoothing: float):
        """(objective_sum, ce_sum, correct) over valid label positions:
        the projection + CE fused, the kernels B4-B6 on the card."""
        return fused_linear_xent(*self.fused_parts(x), labels.reshape(-1),
                                 smoothing)

    def fused_eval(self, x: torch.Tensor, labels: torch.Tensor):
        """(ce_sum, correct, correct5, valid), one logit chunk at a time."""
        return fused_linear_xent_eval(self._rows(x), self.head.to(x.dtype),
                                      labels.reshape(-1))


def build_transformer(arch: str, in_shape, vocab: int,
                      seed: int = 0) -> LayerModel:
    """The ``arch`` LM with random weights from ``seed`` (a torch.Generator;
    not the reference's jax.random stream — convert.py carries JAX weights
    over when a test needs the same model in both packages). Built on the
    CPU; move it with ``.to(device)``."""
    cfgv = _VARIANTS[arch]
    gen = torch.Generator().manual_seed(seed)
    T = in_shape[0]
    d = cfgv["d_model"]
    layers: List[nn.Module] = [Embed(vocab, d, T, gen)]
    for _ in range(cfgv["n_layers"]):
        layers.append(TransformerBlock(d, cfgv["n_heads"], gen))
    layers.append(LMHead(d, vocab, gen))
    return LayerModel(arch, layers, tuple(in_shape), vocab)
