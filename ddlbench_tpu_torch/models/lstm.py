"""Recurrent (LSTM) seq2seq, the reference's GNMT workload class (PyTorch
port).

The port of ``ddlbench_tpu/models/lstm.py``: a stack of LSTM layers over
the same [B, S+T] prefix token stream as the transformer seq2seq, so the
encoder's last state flows into the first target step by construction,
with one dot-product cross-attention after layer ``n // 2`` (target
positions attend over the source segment's states; source positions pass
through) and the shared LM head (the fused head B4-B6 applies unchanged).
The embedding is token + segment, no positions: the recurrence gives the
order.

The recurrence has no Pallas kernel in the reference (a ``lax.scan``),
so it runs on ``torch.lstm``, the op behind ``nn.LSTM``: cuDNN's LSTM on
the card where cuDNN takes the dtype, PyTorch's own fused cell elsewhere
(and on the CPU). The reference's parameters map onto it as
``weight_ih = wx.T``, ``weight_hh = wh.T``, ``bias_ih = b``, ``bias_hh =
0``: both use the gate order (i, f, g, o), and the forget-gate bias
starts at 1.0. Layer 1 has no residual (``residual=False``); the others
add their input.

Three numerics of the reference are kept on purpose (tests pin them):

* the cross-attention's scale is ``sqrt(d)`` computed in the compute
  dtype, so in bfloat16 the scores divide by 22.625, sqrt(512) rounded;
* its softmax runs in float32 and is cast back before the value product;
* source positions get exactly their input (``where``, not a masked
  add).

Variants: seq2seq_lstm_s (4 layers of d 512), seq2seq_lstm_t (the tests',
2 of d 32). No decode protocol: the cached and paged decoders refuse the
model (models/decode.supports_cache is False), as in the reference.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.transformer import LMHead, _normal

_VARIANTS = {
    # n_layers counts LSTM layers; GNMT uses 4 enc + 4 dec of d1024 — the
    # joint-stream design halves that (one stack serves both segments)
    "seq2seq_lstm_s": dict(d_model=512, n_layers=4),
    "seq2seq_lstm_t": dict(d_model=32, n_layers=2),  # test variant
}


class LSTMLayer(nn.Module):
    """One LSTM layer over the time axis: [B, T, D] -> [B, T, H], plus
    its input when ``residual`` (and D == H)."""

    def __init__(self, d_in: int, hidden: int, gen: torch.Generator,
                 residual: bool = True):
        super().__init__()
        self.residual = residual
        self.wx = _normal(gen, d_in, 4 * hidden)
        self.wh = _normal(gen, hidden, 4 * hidden)
        b = torch.zeros(4 * hidden)
        b[hidden:2 * hidden] = 1.0
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, d = x.shape
        H = self.wh.shape[0]
        wx, wh, b = (t.to(x.dtype) for t in (self.wx, self.wh, self.b))
        h0 = x.new_zeros(1, B, H)
        # cuDNN flattens the weights with views: they must be contiguous
        y, _, _ = torch.lstm(x, (h0, h0), [wx.t().contiguous(),
                                           wh.t().contiguous(), b,
                                           torch.zeros_like(b)],
                             True, 1, 0.0, self.training, False, True)
        return y + x if self.residual and d == H else y


class CrossAttention(nn.Module):
    """GNMT decoder attention, dot-product form: target positions attend
    over the source segment's states; source positions pass through."""

    def __init__(self, d_model: int, src_len: int, gen: torch.Generator):
        super().__init__()
        self.src_len = src_len
        self.q, self.k, self.v, self.o = (_normal(gen, d_model, d_model)
                                          for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        src = x[:, :self.src_len]
        q = x @ self.q.to(x.dtype)
        k = src @ self.k.to(x.dtype)
        v = src @ self.v.to(x.dtype)
        scale = torch.tensor(float(d), dtype=x.dtype, device=x.device).sqrt()
        scores = torch.einsum("btd,bsd->bts", q, k) / scale
        probs = torch.softmax(scores.float(), -1).to(x.dtype)
        out = torch.einsum("bts,bsd->btd", probs, v) @ self.o.to(x.dtype)
        is_tgt = (torch.arange(T, device=x.device) >= self.src_len)
        return x + torch.where(is_tgt[None, :, None], out,
                               torch.zeros_like(out))


class LSTMEmbed(nn.Module):
    """Token + segment (source 0 / target 1) embedding."""

    def __init__(self, vocab: int, d_model: int, src_len: int,
                 gen: torch.Generator):
        super().__init__()
        self.src_len = src_len
        self.tok = _normal(gen, vocab, d_model)
        self.seg = _normal(gen, 2, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seg = (torch.arange(x.shape[1], device=x.device)
               >= self.src_len).long()
        return self.tok[x] + self.seg[seg][None]


def build_lstm_seq2seq(arch: str, in_shape, vocab: int, src_len: int,
                       seed: int = 0) -> LayerModel:
    """The ``arch`` LSTM seq2seq with random weights from ``seed`` (a
    torch.Generator; convert.py carries JAX weights over). Built on the
    CPU; move it with ``.to(device)``."""
    cfgv = _VARIANTS[arch]
    T = in_shape[0]
    if not 0 < src_len < T:
        raise ValueError(f"src_len {src_len} must be inside the stream "
                         f"(T={T})")
    gen = torch.Generator().manual_seed(seed)
    d, n = cfgv["d_model"], cfgv["n_layers"]
    layers: List[nn.Module] = [LSTMEmbed(vocab, d, src_len, gen)]
    for i in range(n):
        layers.append(LSTMLayer(d, d, gen, residual=i > 0))
        if i == n // 2 - 1 or n == 1:
            # attention mid-stack: the lower layers encode, the upper
            # layers consume source context
            layers.append(CrossAttention(d, src_len, gen))
    layers.append(LMHead(d, vocab, gen))
    return LayerModel(arch, layers, tuple(in_shape), vocab, src_len=src_len)
