"""Seq2seq (translation) workload as a prefix-LM (PyTorch port).

The port of the training half of ``ddlbench_tpu/models/seq2seq.py``, the
reference's GNMT analog: source and target ride one [B, S+T] token stream;
source positions attend bidirectionally within the source, target positions
causally to targets and fully to the source, all in the same block. The
blocks are models/transformer.py's ``TransformerBlock`` with ``prefix_len =
src_len`` (the flash kernels' prefix path); the model adds only the
segment-aware embedding. Source labels are masked in the data
(data/synthetic.mask_source_labels), and the loss takes label smoothing
0.1 by default (RunConfig.resolved_label_smoothing).

Greedy and beam-search decoding (and the embedding's decode op) wait for
the port of ``models/decode.py``; the serve ops stay causal-LM only.

Variants: seq2seq_s (8 x d512, 8 heads), seq2seq_m (12 x d768).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.transformer import (LMHead, TransformerBlock,
                                                   _normal)

_VARIANTS = {
    "seq2seq_s": dict(d_model=512, n_layers=8, n_heads=8),
    "seq2seq_m": dict(d_model=768, n_layers=12, n_heads=12),
}


class Seq2seqEmbed(nn.Module):
    """Token + learned position + segment (source 0 / target 1)
    embedding: x [B, T] int -> [B, T, d] in the tables' dtype. The
    segment id is 1 at absolute positions >= ``src_len``."""

    def __init__(self, vocab: int, d_model: int, max_len: int, src_len: int,
                 gen: torch.Generator):
        super().__init__()
        self.src_len = src_len
        self.tok = _normal(gen, vocab, d_model)
        self.pos = _normal(gen, max_len, d_model)
        self.seg = _normal(gen, 2, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        abs_pos = torch.arange(x.shape[1], device=x.device)
        seg_ids = (abs_pos >= self.src_len).long()
        return self.tok[x] + self.pos[:x.shape[1]] + self.seg[seg_ids]


def build_seq2seq(arch: str, in_shape, vocab: int, src_len: int,
                  seed: int = 0) -> LayerModel:
    """The ``arch`` prefix-LM with random weights from ``seed`` (a
    torch.Generator; convert.py carries JAX weights over). Built on the
    CPU; move it with ``.to(device)``."""
    cfgv = _VARIANTS[arch]
    T = in_shape[0]
    if not 0 < src_len < T:
        raise ValueError(f"src_len {src_len} must be inside the stream "
                         f"(T={T})")
    gen = torch.Generator().manual_seed(seed)
    d = cfgv["d_model"]
    layers: List[nn.Module] = [Seq2seqEmbed(vocab, d, T, src_len, gen)]
    for _ in range(cfgv["n_layers"]):
        layers.append(TransformerBlock(d, cfgv["n_heads"], gen,
                                       prefix_len=src_len))
    layers.append(LMHead(d, vocab, gen))
    return LayerModel(arch, layers, tuple(in_shape), vocab)
