"""Carry the JAX package's weights into the port's modules.

``from_jax_params(model, params_np)`` copies the reference's per-layer
param list — each layer's dict of arrays, as numpy (``jax.device_get`` of
``init_model``'s params) — into the port's ``LayerModel``:

* embed: ``tok``, ``pos`` (and ``seg``, the seq2seq embedding's segment
  table);
* block: ``ln1``/``ln2`` ``scale``/``bias``, ``wqkv``, ``wo``, ``w1``,
  ``b1``, ``w2``, ``b2``;
* head: ``ln_f`` ``scale``/``bias``, ``head``.

Parameters are matched by name, so a layer is covered whatever its
family (transformer or seq2seq). Dense weights stay ``[in, out]`` — the
port computes ``x @ W`` exactly as the JAX code does — so every array is
copied as it is, nothing transposed.

``from_jax_opt_state(optimizer, model, opt_np)`` carries the reference's
optimizer state (``TrainState.opt``: SGD ``{"m"}``, Adam ``{"m", "v",
"step"}``, each m/v a per-layer param list like the params) into the
``torch.optim`` state of ``model``'s parameters, so a run can resume the
port from a JAX TrainState mid-run.

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


def _pairs(model: LayerModel, tree_np: List[Dict]
           ) -> Iterator[Tuple[str, torch.nn.Parameter, np.ndarray]]:
    """(name, port parameter, reference array) for every parameter of
    ``model`` against ``tree_np`` (one nested dict of arrays per layer),
    which must cover exactly the port's parameters at their shapes."""
    if len(tree_np) != len(model.layers):
        raise ValueError(f"{len(tree_np)} param dicts for "
                         f"{len(model.layers)} layers")
    for i, (layer, tree) in enumerate(zip(model.layers, tree_np)):
        own = dict(layer.named_parameters())
        given = dict(_flatten(tree))
        if set(own) != set(given):
            raise ValueError(
                f"layer {i}: params {sorted(given)} do not match the "
                f"port's {sorted(own)}")
        for name, arr in given.items():
            if tuple(np.shape(arr)) != tuple(own[name].shape):
                raise ValueError(
                    f"layer {i} {name}: shape {tuple(np.shape(arr))} vs "
                    f"{tuple(own[name].shape)}")
            yield f"{i}.{name}", own[name], arr


def _tensor_like(arr, p: torch.Tensor) -> torch.Tensor:
    # np.array: a writable copy
    return torch.from_numpy(np.array(arr)).to(p.device, p.dtype)


@torch.no_grad()
def from_jax_params(model: LayerModel, params_np: List[Dict]) -> LayerModel:
    """Copy ``params_np`` (one nested dict of arrays per layer) into
    ``model`` in place and return it. Every array must land on a parameter
    of the same shape, and every parameter must be covered."""
    for _, p, arr in list(_pairs(model, params_np)):
        p.copy_(_tensor_like(arr, p))
    return model


def from_jax_opt_state(optimizer: torch.optim.Optimizer, model: LayerModel,
                       opt_np: Mapping) -> torch.optim.Optimizer:
    """Set ``optimizer``'s state for ``model``'s parameters from the
    reference's optimizer state ``opt_np`` (numpy leaves): SGD ``{"m"}``
    becomes ``momentum_buffer``; Adam ``{"m", "v", "step"}`` becomes
    ``exp_avg``, ``exp_avg_sq`` and ``step``. Returns the optimizer."""
    if isinstance(optimizer, torch.optim.SGD):
        if set(opt_np) != {"m"}:
            raise ValueError(f"SGD state must be {{'m'}}, got {set(opt_np)}")
        for _, p, m in list(_pairs(model, opt_np["m"])):
            optimizer.state[p] = {"momentum_buffer": _tensor_like(m, p)}
    elif isinstance(optimizer, torch.optim.Adam):
        if set(opt_np) != {"m", "v", "step"}:
            raise ValueError("Adam state must be {'m', 'v', 'step'}, got "
                             f"{set(opt_np)}")
        step = float(np.asarray(opt_np["step"]))
        v_by_name = {n: v for n, _, v in _pairs(model, opt_np["v"])}
        for name, p, m in list(_pairs(model, opt_np["m"])):
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": _tensor_like(m, p),
                "exp_avg_sq": _tensor_like(v_by_name[name], p)}
    else:
        raise TypeError(f"no reference state for {type(optimizer).__name__}")
    return optimizer
