"""Flat-layer model container, the training apply and the serving-layer
protocol.

The port's counterpart of ``ddlbench_tpu/models/layers.py``'s
``LayerModel``, ``apply_slice``/``apply_model`` and ``ServeOps``. A model is
a named flat stack of ``nn.Module`` layers; training applies it through
:func:`apply_model`, and the serving engine walks the stack itself, calling
each serving layer's serve ops and plain ``forward`` on pointwise layers
(the LM head).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


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
    * ``serve_verify(pool, table, x, pos0, npl, page)`` — the speculative
      verify pass: a span of W tokens per row, x [B, W] at per-row
      positions [pos0, pos0 + W), page-unaligned (the reference's
      ``ServeOps.verify``).

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

    def serve_verify(self, pool, table, x, pos0, npl: int,
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


def _call(layer: nn.Module, params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(layer, params, (x,))


def apply_slice(layers: Sequence[nn.Module], x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False) -> torch.Tensor:
    """Run ``layers`` in order on casts of their parameters.

    Every floating-point parameter is cast to ``compute_dtype`` (None keeps
    it) before its layer runs, as the reference applies its model on
    ``cast_params`` (parallel/common.py): the embedding tables and the
    LayerNorm scales and biases too, so activations come out in the
    compute dtype. The casts are inside autograd, so gradients land on the
    float32 master parameters. With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
    layer instead of keeping its interior activations."""
    for layer in layers:
        params = {n: p.to(compute_dtype)
                  if compute_dtype is not None and p.is_floating_point()
                  else p for n, p in layer.named_parameters()}
        if remat:
            x = checkpoint(_call, layer, params, x, use_reentrant=False)
        else:
            x = _call(layer, params, x)
    return x


def apply_model(model: LayerModel, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False) -> torch.Tensor:
    return apply_slice(model.layers, x, compute_dtype, remat)
