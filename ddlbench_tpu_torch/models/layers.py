"""Flat-layer model container and the serving-layer protocol.

The port's counterpart of ``ddlbench_tpu/models/layers.py``'s
``LayerModel`` and ``ServeOps``. A model is a named flat stack of
``nn.Module`` layers; the serving engine walks the stack itself, calling each
serving layer's two serve ops and plain ``forward`` on pointwise layers (the
LM head).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class ServeLayer(nn.Module):
    """A layer the continuous-batching engine (serve/engine.py) can serve.

    Serving rows are independent requests at per-row stream positions,
    borrowing K/V slots from a SHARED pool through ONE page table
    ([max_batch, npg] int32, slot 0 = scratch) that every layer indexes
    (ops/paged_decode.py). Pools are written in place.

    * ``pool_init(n_pages, page, dtype, device)`` — the layer's slice of the
      shared pool, or None for a cache-free layer (the embedding).
    * ``serve_prefill(pool, table, x, start, npl, page)`` — one
      page-aligned prompt chunk x [R, C] at positions [start, start + C).
    * ``serve_decode(pool, table, x, pos, npl, page)`` — one token per row,
      x [B, 1] at per-row positions ``pos`` [B] (an int32 tensor).

    ``npl`` is the number of live table pages the attention walks.
    """

    def pool_init(self, n_pages: int, page: int, dtype: torch.dtype,
                  device: torch.device) -> Optional[dict]:
        return None

    def serve_prefill(self, pool, table, x, start: int, npl: int,
                      page: int) -> torch.Tensor:
        raise NotImplementedError

    def serve_decode(self, pool, table, x, pos, npl: int,
                     page: int) -> torch.Tensor:
        raise NotImplementedError


class LayerModel(nn.Module):
    """A named flat stack of layers plus the metadata the tools need:
    ``in_shape`` is ``(T,)`` for token models and ``num_classes`` the
    vocabulary. ``forward`` applies every layer in order."""

    def __init__(self, name: str, layers: Sequence[nn.Module],
                 in_shape: Tuple[int, ...], num_classes: int):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleList(layers)
        self.in_shape = tuple(in_shape)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

