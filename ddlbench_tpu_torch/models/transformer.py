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
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ddlbench_tpu_torch.config import ATTENTION_BACKENDS
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
        return self.tok[x] + self.pos[:x.shape[1]]

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

    def _qkv_heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        """q, k, v as [B, H, T, dh] from contiguous thirds of ln1(x) @
        wqkv."""
        B, T, d = x.shape
        qkv = self.ln1(x) @ self.wqkv.to(x.dtype)
        return [t.reshape(B, T, self.n_heads, self.dh).transpose(1, 2)
                for t in qkv.split(d, dim=-1)]

    def _proj(self, o2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Output projection + residual of the attention sublayer; ``o2``
        is the [B, T, d] attention output."""
        return x + o2 @ self.wo.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        q, k, v = self._qkv_heads(x)
        o = causal_attention(q, k, v, prefix_len=self.prefix_len)
        x = self._proj(o.transpose(1, 2).reshape(B, T, d), x)
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
        return self.mlp(self._proj(o.transpose(1, 2).reshape(B, T, d), x))

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
    dense GELU MLP, 4x), with the serving ops (causal-LM only)."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 mlp_ratio: int = 4, prefix_len: int = 0):
        super().__init__(d_model, n_heads, gen, prefix_len)
        d, f = d_model, mlp_ratio * d_model
        self.w1 = _normal(gen, d, f)
        self.b1 = nn.Parameter(torch.zeros(f))
        self.w2 = _normal(gen, f, d)
        self.b2 = nn.Parameter(torch.zeros(d))

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln2(x)
        h = F.gelu(h @ self.w1.to(x.dtype) + self.b1.to(x.dtype),
                   approximate="tanh")
        return x + h @ self.w2.to(x.dtype) + self.b2.to(x.dtype)

    mlp_one = mlp

    # -- the serving protocol (serve/engine.py) ----------------------------

    def pool_init(self, n_pages, page, dtype, device):
        return serve_pool_init(n_pages, page, self.n_heads, self.dh, dtype,
                               device)

    def serve_prefill(self, pool, table, x, start, npl, page):
        """Write the page-aligned chunk's K/V through the shared table,
        then attend the chunk queries against the live pages."""
        B, C, d = x.shape
        q, k, v = self._qkv_heads(x)  # [B, H, C, dh]
        cache = {**pool, "table": table}
        paged_table_chunk_write(cache, k.transpose(1, 2), v.transpose(1, 2),
                                start, page)
        o = paged_chunk_attention_auto(q.contiguous(), cache, start, npl,
                                       page)
        x = self._proj(o.transpose(1, 2).reshape(B, C, d), x)
        return self.mlp(x)

    def serve_decode(self, pool, table, x, pos, npl, page):
        """Write each row's token K/V at its own position through the
        table, then single-query attention over the live pages."""
        B, _, d = x.shape
        q, k, v = self._qkv_heads(x)  # [B, H, 1, dh]
        cache = {**pool, "table": table}
        paged_table_write(cache, k.transpose(1, 2), v.transpose(1, 2), pos,
                          page)
        o = paged_attention_auto(q[:, :, 0].contiguous(), cache, pos, npl,
                                 page)
        x = self._proj(o.reshape(B, 1, d), x)
        return self.mlp(x)

    def serve_verify(self, pool, table, x, pos0, npl, page):
        """The speculative verify pass: write the W-token span's K/V at
        page-unaligned per-row positions [pos0, pos0 + W), then attend all
        W queries causally at their absolute positions (the chunk kernel
        with per-row starts)."""
        B, W, d = x.shape
        q, k, v = self._qkv_heads(x)  # [B, H, W, dh]
        cache = {**pool, "table": table}
        paged_table_span_write(cache, k.transpose(1, 2), v.transpose(1, 2),
                               pos0, page)
        o = paged_chunk_attention_auto(q.contiguous(), cache, pos0, npl,
                                       page)
        x = self._proj(o.transpose(1, 2).reshape(B, W, d), x)
        return self.mlp(x)


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

    def fused_loss(self, x: torch.Tensor, labels: torch.Tensor,
                   smoothing: float):
        """(objective_sum, ce_sum, correct) over valid label positions:
        the projection + CE fused, the kernels B4-B6 on the card."""
        return fused_linear_xent(self._rows(x), self.head.to(x.dtype),
                                 labels.reshape(-1), smoothing)

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
