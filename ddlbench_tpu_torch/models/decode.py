"""KV-cached incremental decoding over the flat layer chain (PyTorch port).

The port of ``ddlbench_tpu/models/decode.py``. The full-forward decoders
in models/seq2seq.py re-run the whole model per emitted token; here one
**prefill** pass runs the prompt and fills each attention block's K/V
cache, then each generated token runs one single-position **decode** pass
against the caches. The protocol is :class:`~ddlbench_tpu_torch.models.
layers.DecodeLayer`'s: attention blocks carry a cache, position
embeddings decode without one, and pointwise layers (the LM head) run
through ``forward``. For dense models both decoders give the token
streams of their full-forward counterparts (tests/test_torch_decode.py).

Two caches:

* dense (``paged=False``): [rows, H, max_len, dh] per block, read by the
  reference's plain masked attention; a beam step gathers every cache
  along the parent beams, as GNMT reorders its recurrent decoder state;
* paged (``paged=True``): the row-owned beam cache of ops/paged_decode.py,
  pages of ``paged_decode.PAGE`` positions, read by the decode kernel over
  the live pages only; a beam step copies table pointers and one partial
  page per row (copy-on-write).

The loops are Python loops over the position. The reference compiles its
paged loop in one-page segments so that its kernel sees a static page
count; here each step passes its live page count, ``pos // page + 1``.
Ties: greedy takes the first maximum (``argmax``, as ``jnp.argmax``), and
a beam step ranks its candidates by a stable descending sort, so equal
scores keep the lower index first, as ``lax.top_k`` does. The cache dtype
is float32 or bfloat16; the reference's int8 beam cache would truncate
K/V (it has no scales) and is refused. MoE blocks (models/moe.py) decode
each position's top-1 expert with no capacity limit; the LSTM seq2seq
and the image models have no decode protocol.
"""

from __future__ import annotations

import math
from typing import Any, List

import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.models.layers import DecodeLayer, LayerModel
from ddlbench_tpu_torch.ops import paged_decode as pd


def _decodes(layer) -> bool:
    return isinstance(layer, DecodeLayer)


def supports_cache(model: LayerModel) -> bool:
    """True if every layer can take part in cached decoding."""
    return all(_decodes(l) or getattr(l, "pointwise", False)
               for l in model.layers)


def _require_cache_support(model: LayerModel) -> None:
    if not supports_cache(model):
        missing = [type(l).__name__ for l in model.layers
                   if not (_decodes(l) or getattr(l, "pointwise", False))]
        raise NotImplementedError(
            f"{model.name} has layers without cached-decode support: "
            f"{missing}; use the full-forward decoders instead")


def _check_cache_dtype(dtype: torch.dtype) -> None:
    if dtype not in pd.BEAM_CACHE_DTYPES:
        raise ValueError(
            f"cache dtype {dtype}: float32 or bfloat16 only. The reference's "
            "decode caches have no scale sidecars, so an int8 cache would "
            "truncate K/V to integers (ROADMAP C.10)")


def _device(model: LayerModel) -> torch.device:
    return next(model.parameters()).device


def init_caches(model: LayerModel, batch: int, max_len: int,
                dtype: torch.dtype) -> List[Any]:
    _check_cache_dtype(dtype)
    dev = _device(model)
    return [l.init_cache(batch, max_len, dtype, dev) if _decodes(l) else None
            for l in model.layers]


def prefill(model: LayerModel, caches, tokens: torch.Tensor):
    """Run the prompt [B, S] through the chain, filling the caches from
    position 0. Returns (logits [B, S, V], caches)."""
    h, out = tokens, []
    for layer, c in zip(model.layers, caches):
        if _decodes(layer):
            h, c = layer.prefill(c, h, 0)
        else:
            h = layer(h)
        out.append(c)
    return h, out


def decode_one(model: LayerModel, caches, tok: torch.Tensor, pos: int):
    """Run ONE token [B, 1] at position ``pos``. Returns (logits, caches)."""
    h, out = tok, []
    for layer, c in zip(model.layers, caches):
        if _decodes(layer):
            h, c = layer.decode(c, h, pos)
        else:
            h = layer(h)
        out.append(c)
    return h, out


# ---------------------------------------------------------------------------
# The paged cache: copy-on-write beam reorder, attention over the live pages.
# ---------------------------------------------------------------------------


def supports_paged(model: LayerModel) -> bool:
    """True if every cache-carrying layer also has the paged ops."""
    return supports_cache(model) and all(
        l.paged for l in model.layers if _decodes(l) and l.cached)


def _require_paged_support(model: LayerModel) -> None:
    if not supports_paged(model):
        missing = [type(l).__name__ for l in model.layers
                   if _decodes(l) and l.cached and not l.paged]
        raise NotImplementedError(
            f"{model.name} has cached layers without paged-decode support: "
            f"{missing or 'cached path unsupported'}; use paged=False")


def init_paged_caches(model: LayerModel, batch: int, max_len: int,
                      dtype: torch.dtype) -> List[Any]:
    _check_cache_dtype(dtype)
    dev = _device(model)
    return [l.paged_init_cache(batch, max_len, dtype, dev)
            if _decodes(l) and l.paged else None for l in model.layers]


def paged_prefill(model: LayerModel, caches, tokens: torch.Tensor):
    h, out = tokens, []
    for layer, c in zip(model.layers, caches):
        if _decodes(layer):
            h, c = (layer.paged_prefill(c, h, 0) if layer.paged
                    else layer.prefill(c, h, 0))
        else:
            h = layer(h)
        out.append(c)
    return h, out


def paged_decode_one(model: LayerModel, caches, tok: torch.Tensor, pos: int,
                     npl: int):
    """:func:`decode_one` over the paged caches; ``npl`` live pages."""
    h, out = tok, []
    for layer, c in zip(model.layers, caches):
        if _decodes(layer):
            h, c = (layer.paged_decode(c, h, pos, npl) if layer.paged
                    else layer.decode(c, h, pos))
        else:
            h = layer(h)
        out.append(c)
    return h, out


def paged_reorder_caches(model: LayerModel, caches, parent: torch.Tensor,
                         pos: int):
    return [l.paged_reorder(c, parent, pos) if c is not None else None
            for l, c in zip(model.layers, caches)]


def _gather_caches(caches, idx: torch.Tensor):
    """The dense caches' rows along ``idx``: a physical gather."""
    return [None if c is None else {k: a[idx] for k, a in c.items()}
            for c in caches]


def _start_len(model: LayerModel, src: torch.Tensor) -> int:
    if model.src_len is not None and src.shape[1] != model.src_len:
        raise ValueError(f"src must be [B, {model.src_len}] for "
                         f"{model.name}, got {tuple(src.shape)}")
    return src.shape[1]


def _setup(model: LayerModel, src: torch.Tensor, total_len: int,
           paged: bool) -> int:
    (_require_paged_support if paged else _require_cache_support)(model)
    S = _start_len(model, src)
    T = model.in_shape[0]
    if not S < total_len <= T:
        raise ValueError(f"total_len must be in ({S}, {T}], got {total_len}")
    return S


def _start(model, src, rows, total_len, dtype, paged):
    """Fresh caches for ``rows`` rows and the prompt's prefill: (the
    prompt's logits, caches, the step function)."""
    if paged:
        caches = init_paged_caches(model, rows, total_len, dtype)
        logits, caches = paged_prefill(model, caches, src)
        page = pd.PAGE

        def step(caches, tok, pos):
            return paged_decode_one(model, caches, tok, pos, pos // page + 1)
    else:
        caches = init_caches(model, rows, total_len, dtype)
        logits, caches = prefill(model, caches, src)

        def step(caches, tok, pos):
            return decode_one(model, caches, tok, pos)
    return logits, caches, step


@torch.no_grad()
def greedy_decode(model: LayerModel, src: torch.Tensor, total_len: int,
                  dtype: torch.dtype = torch.float32,
                  paged: bool = False) -> torch.Tensor:
    """KV-cached greedy continuation of ``src`` [B, S] to [B, total_len]
    (int64). ``paged``: the paged cache, whose attention reads only the
    live pages; greedy never reorders."""
    S = _setup(model, src, total_len, paged)
    B = src.shape[0]
    src = src.long()
    logits, caches, step = _start(model, src, B, total_len, dtype, paged)
    x = torch.zeros(B, total_len, dtype=torch.long, device=src.device)
    x[:, :S] = src
    x[:, S] = logits[:, -1].argmax(-1)
    for t in range(S, total_len - 1):
        logits, caches = step(caches, x[:, t:t + 1], t)
        x[:, t + 1] = logits[:, 0].argmax(-1)
    return x


def first_scores(B: int, beam: int, device) -> torch.Tensor:
    """[B * beam] float32: 0 for each item's first beam, -inf for the
    others, so the first expansion comes from one beam per item (all beams
    start identical)."""
    first = torch.arange(B * beam, device=device) % beam == 0
    return torch.where(first, 0.0, -math.inf).to(torch.float32)


def beam_expand(x: torch.Tensor, score: torch.Tensor, logits: torch.Tensor,
                t: int, B: int, beam: int):
    """One beam expansion at position ``t`` from each hypothesis's
    logits [B * beam, V]: every (beam, token) candidate scored, the best
    ``beam`` of each item kept in a stable descending order (ties: the
    lower candidate index first, as ``lax.top_k``). Returns (x with each
    kept hypothesis's parent row and new token, scores [B * beam], the
    flat parent rows)."""
    V = logits.shape[-1]
    logp = F.log_softmax(logits.float(), -1)
    cand = (score[:, None] + logp).reshape(B, beam * V)
    top_score, top_idx = torch.sort(cand, dim=-1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :beam], top_idx[:, :beam]
    rows = torch.arange(B, device=x.device)[:, None] * beam
    flat_src = (rows + top_idx // V).reshape(-1)
    x = x[flat_src]
    x[:, t] = (top_idx % V).reshape(-1)
    return x, top_score.reshape(-1), flat_src


def best_beam(x: torch.Tensor, score: torch.Tensor, B: int, beam: int,
              new: int, length_penalty: float):
    """Each item's best hypothesis under GNMT's length normalisation
    (``new`` generated positions): (tokens [B, T], score [B])."""
    norm = ((5.0 + new) / 6.0) ** length_penalty
    score = (score / norm).reshape(B, beam)
    best = score.argmax(-1)
    items = torch.arange(B, device=x.device)
    return x.reshape(B, beam, -1)[items, best], score[items, best]


@torch.no_grad()
def beam_search_decode(model: LayerModel, src: torch.Tensor, total_len: int,
                       beam: int = 4, length_penalty: float = 0.6,
                       dtype: torch.dtype = torch.float32,
                       paged: bool = False):
    """KV-cached beam search with models/seq2seq.beam_search_decode's
    semantics and scores (length-normalised, GNMT-style). Caches are kept
    per hypothesis (B * beam rows) and follow the parent beam at every
    expansion: a physical gather of every dense cache, or with ``paged``
    the copy-on-write reorder of the page tables. Returns (tokens
    [B, total_len], score [B]) of each item's best beam."""
    S = _setup(model, src, total_len, paged)
    B = src.shape[0]
    src_rep = src.long().repeat_interleave(beam, 0)
    logits, caches, step = _start(model, src_rep, B * beam, total_len, dtype,
                                  paged)
    logits_prev = logits[:, -1]
    x = torch.zeros(B * beam, total_len, dtype=torch.long, device=src.device)
    x[:, :S] = src_rep
    score = first_scores(B, beam, src.device)
    for t in range(S, total_len - 1):
        x, score, parent = beam_expand(x, score, logits_prev, t, B, beam)
        caches = (paged_reorder_caches(model, caches, parent, t) if paged
                  else _gather_caches(caches, parent))
        logits, caches = step(caches, x[:, t:t + 1], t)
        logits_prev = logits[:, 0]
    # the last position needs only the expansion: its decode pass's logits
    # would be discarded
    x, score, _ = beam_expand(x, score, logits_prev, total_len - 1, B, beam)
    return best_beam(x, score, B, beam, total_len - S, length_penalty)
