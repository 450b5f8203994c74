"""Decoder-only transformer LM as a flat layer chain (PyTorch port).

The port of the training and serving pieces of
``ddlbench_tpu/models/transformer.py``: an embedding, pre-LN blocks
(learned positions, GELU MLP 4x) and an untied LM head, each an
``nn.Module`` whose parameters keep the reference's names and layouts —
dense weights are ``[in, out]`` and every projection is ``x @ W``, as in
the JAX code, so converted weights (convert.py) are used as they are.

Attention dispatches like the reference's (:func:`set_attention_backend`):
``"flash"`` takes the flash kernels (ops/flash_attention.py), ``"xla"`` the
plain einsum, and ``"auto"`` the kernels for a CUDA tensor and the plain
einsum for a CPU tensor. The reference's TPU-measured length crossover for
``"auto"`` is not carried over; the card's is still to be measured.

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
from ddlbench_tpu_torch.models.layers import LayerModel, ServeLayer
from ddlbench_tpu_torch.ops.flash_attention import flash_attention
from ddlbench_tpu_torch.ops.paged_decode import (paged_attention,
                                                 paged_chunk_attention,
                                                 paged_table_chunk_write,
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


def _use_flash(q: torch.Tensor) -> bool:
    mode = _ATTENTION_BACKEND[0]
    if mode == "auto":
        return q.device.type == "cuda"
    return mode == "flash"


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, k_offset: int = 0,
                     prefix_len: int = 0) -> torch.Tensor:
    """Masked attention for blocks of a causal (or prefix-LM) sequence:
    q [B, H, Tq, dh], k/v [B, H, Tk, dh]; offsets give each block's
    absolute position, and key positions < ``prefix_len`` are visible to
    every query. Takes the flash kernels when the backend says so (module
    docstring); else the reference's plain path, where a fully masked row
    returns 0."""
    if _use_flash(q):
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


class Embed(ServeLayer):
    """Token + learned position embedding: x [B, T] int -> [B, T, d], in
    the tables' dtype (the compute dtype under layers.apply_model's cast,
    as in the reference's apply on cast params)."""

    def __init__(self, vocab: int, d_model: int, max_len: int,
                 gen: torch.Generator):
        super().__init__()
        self.tok = _normal(gen, vocab, d_model)
        self.pos = _normal(gen, max_len, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tok[x] + self.pos[:x.shape[1]]

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


class TransformerBlock(ServeLayer):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp(ln2(x)) + b2.
    ``prefix_len`` > 0 switches the attention to the prefix-LM mask (the
    seq2seq workload; the serve ops are causal-LM only)."""

    def __init__(self, d_model: int, n_heads: int, gen: torch.Generator,
                 mlp_ratio: int = 4, prefix_len: int = 0):
        super().__init__()
        self.n_heads = n_heads
        self.prefix_len = prefix_len
        self.dh = d_model // n_heads
        d, f = d_model, mlp_ratio * d_model
        self.ln1 = LayerNorm(d)
        self.wqkv = _normal(gen, d, 3 * d)
        self.wo = _normal(gen, d, d)
        self.ln2 = LayerNorm(d)
        self.w1 = _normal(gen, d, f)
        self.b1 = nn.Parameter(torch.zeros(f))
        self.w2 = _normal(gen, f, d)
        self.b2 = nn.Parameter(torch.zeros(d))

    def _qkv_heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        """q, k, v as [B, H, T, dh] from contiguous thirds of ln1(x) @
        wqkv."""
        B, T, d = x.shape
        qkv = self.ln1(x) @ self.wqkv.to(x.dtype)
        return [t.reshape(B, T, self.n_heads, self.dh).transpose(1, 2)
                for t in qkv.split(d, dim=-1)]

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln2(x)
        h = F.gelu(h @ self.w1.to(x.dtype) + self.b1.to(x.dtype),
                   approximate="tanh")
        return x + h @ self.w2.to(x.dtype) + self.b2.to(x.dtype)

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
        o = paged_chunk_attention(q.contiguous(), cache, start, npl, page)
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
        o = paged_attention(q[:, :, 0].contiguous(), cache, pos, npl, page)
        x = self._proj(o.reshape(B, 1, d), x)
        return self.mlp(x)


class LMHead(nn.Module):
    """Final LayerNorm + untied vocabulary projection (pointwise: the
    serving engine applies it with ``forward``)."""

    def __init__(self, d_model: int, vocab: int, gen: torch.Generator):
        super().__init__()
        self.ln_f = LayerNorm(d_model)
        self.head = _normal(gen, d_model, vocab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_f(x) @ self.head.to(x.dtype)


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
