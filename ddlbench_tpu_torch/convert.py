"""Carry the JAX package's weights into the port's modules.

``from_jax_params(model, params_np)`` copies the reference's per-layer
param list — each layer's dict of arrays, as numpy (``jax.device_get`` of
``init_model``'s params) — into the port's ``LayerModel``:

* embed: ``tok``, ``pos``;
* block: ``ln1``/``ln2`` ``scale``/``bias``, ``wqkv``, ``wo``, ``w1``,
  ``b1``, ``w2``, ``b2``;
* head: ``ln_f`` ``scale``/``bias``, ``head``.

Dense weights stay ``[in, out]`` — the port computes ``x @ W`` exactly as
the JAX code does — so every array is copied as it is, nothing transposed.
This module imports no JAX: it takes numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ddlbench_tpu_torch.models.layers import LayerModel


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """Dotted names of a nested param dict: {"ln1": {"scale": a}} ->
    ("ln1.scale", a) — the port's module parameter names."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


@torch.no_grad()
def from_jax_params(model: LayerModel, params_np: List[Dict]) -> LayerModel:
    """Copy ``params_np`` (one nested dict of arrays per layer) into
    ``model`` in place and return it. Every array must land on a parameter
    of the same shape, and every parameter must be covered."""
    if len(params_np) != len(model.layers):
        raise ValueError(f"{len(params_np)} param dicts for "
                         f"{len(model.layers)} layers")
    for i, (layer, tree) in enumerate(zip(model.layers, params_np)):
        own = dict(layer.named_parameters())
        given = dict(_flatten(tree))
        if set(own) != set(given):
            raise ValueError(
                f"layer {i}: params {sorted(given)} do not match the "
                f"port's {sorted(own)}")
        for name, arr in given.items():
            src = torch.from_numpy(np.array(arr))  # a writable copy
            if tuple(src.shape) != tuple(own[name].shape):
                raise ValueError(
                    f"layer {i} {name}: shape {tuple(src.shape)} vs "
                    f"{tuple(own[name].shape)}")
            own[name].copy_(src)
    return model
