"""Seq2seq (translation) workload as a prefix-LM (PyTorch port).

The port of ``ddlbench_tpu/models/seq2seq.py``, the reference's GNMT
analog: source and target ride one [B, S+T] token stream;
source positions attend bidirectionally within the source, target positions
causally to targets and fully to the source, all in the same block. The
blocks are models/transformer.py's ``TransformerBlock`` with ``prefix_len =
src_len`` (the flash kernels' prefix path); the model adds only the
segment-aware embedding. Source labels are masked in the data
(data/synthetic.mask_source_labels), and the loss takes label smoothing
0.1 by default (RunConfig.resolved_label_smoothing).

Inference: :func:`greedy_decode` and :func:`beam_search_decode` (GNMT's
length-normalised beam search) take the KV-cached path of
models/decode.py by default; ``use_cache=False`` re-runs the full forward
per emitted token, the reference semantics the cached paths are tested
against. The serve ops stay causal-LM only.

Variants: seq2seq_s (8 x d512, 8 heads), seq2seq_m (12 x d768).
"""

from __future__ import annotations

from typing import List

import torch

from ddlbench_tpu_torch.models import decode
from ddlbench_tpu_torch.models.layers import DecodeLayer, LayerModel
from ddlbench_tpu_torch.models.transformer import (LMHead, TransformerBlock,
                                                   _normal)

_VARIANTS = {
    "seq2seq_s": dict(d_model=512, n_layers=8, n_heads=8),
    "seq2seq_m": dict(d_model=768, n_layers=12, n_heads=12),
}


class Seq2seqEmbed(DecodeLayer):
    """Token + learned position + segment (source 0 / target 1)
    embedding: x [B, T] int -> [B, T, d] in the tables' dtype. The
    segment id is 1 at absolute positions >= ``src_len``. Cache-free in
    the decode protocol."""

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

    def decode(self, cache, x, pos):
        # x [B, 1] at absolute position pos
        seg = self.seg[int(pos >= self.src_len)]
        return self.tok[x] + self.pos[pos:pos + 1] + seg, cache


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
    return LayerModel(arch, layers, tuple(in_shape), vocab, src_len=src_len)


# ---------------------------------------------------------------------------
# Inference (GNMT's beam-search parity). Both decoders delegate to the
# KV-cached implementation (models/decode.py) by default; the full-forward
# loops below re-run the whole model per emitted token and are the
# reference semantics the cached paths are tested against.
# ---------------------------------------------------------------------------


def _check_src(model: LayerModel, src: torch.Tensor, total_len: int) -> None:
    if model.src_len is None:
        raise ValueError(f"{model.name} is not a seq2seq model")
    if src.dim() != 2 or src.shape[1] != model.src_len:
        raise ValueError(
            f"src must be [B, {model.src_len}] (the src_len baked into "
            f"{model.name}'s attention masks), got {tuple(src.shape)}")
    T = model.in_shape[0]
    if not model.src_len < total_len <= T:
        raise ValueError(
            f"total_len must be in ({model.src_len}, {T}] (past the source, "
            f"within {model.name}'s trained context), got {total_len}")


@torch.no_grad()
def greedy_decode(model: LayerModel, src: torch.Tensor, total_len: int,
                  use_cache: bool = True) -> torch.Tensor:
    """Greedy continuation of ``src`` [B, src_len] to [B, total_len]: the
    KV-cached path (models/decode.py) with ``use_cache``, else one full
    forward per emitted token over the zero-padded stream."""
    _check_src(model, src, total_len)
    if use_cache:
        return decode.greedy_decode(model, src, total_len)
    B, S = src.shape
    x = torch.zeros(B, total_len, dtype=torch.long, device=src.device)
    x[:, :S] = src
    for t in range(S, total_len):
        x[:, t] = model(x)[:, t - 1].argmax(-1)
    return x


@torch.no_grad()
def beam_search_decode(model: LayerModel, src: torch.Tensor, total_len: int,
                       beam: int = 4, length_penalty: float = 0.6,
                       use_cache: bool = True):
    """Beam-search continuation of ``src`` [B, src_len] to ``total_len``,
    GNMT's length-normalised score (log-prob sum over
    ((5 + len) / 6) ** length_penalty). Every hypothesis has the full
    length, so none finishes early. Returns (tokens [B, total_len], score
    [B]) of each item's best beam. ``use_cache``: the KV-cached path
    (models/decode.py); else one full forward per position over every
    hypothesis."""
    _check_src(model, src, total_len)
    if use_cache:
        return decode.beam_search_decode(model, src, total_len, beam,
                                         length_penalty)
    B, S = src.shape
    dev = src.device
    x = torch.zeros(B * beam, total_len, dtype=torch.long, device=dev)
    x[:, :S] = src.repeat_interleave(beam, 0)
    score = decode.first_scores(B, beam, dev)
    for t in range(S, total_len):
        x, score, _ = decode.beam_expand(x, score, model(x)[:, t - 1], t,
                                         B, beam)
    return decode.best_beam(x, score, B, beam, total_len - S,
                            length_penalty)
