"""Stage splits of the port's pipelines (``ddlbench_tpu/parallel/packing.py``
``balanced_stage_bounds`` and ``layer_flop_costs``).

The reference packs each stage's parameters into one row of a sharded
matrix because its pipeline is one SPMD program; the port's pipelines run
each chunk's layers as they are, on their own device, so only the split
itself is ported: the analytic per-layer FLOP estimate (with the packed
spans' stated geometry) and the exact min-max DP over it. The
per-example boundary shapes the estimate reads (the reference's
``init_model`` shapes) come from :func:`model_shapes`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ddlbench_tpu_torch.models.layers import LayerModel


def balanced_stage_bounds(costs: Sequence[float],
                          num_stages: int) -> List[int]:
    """Split a chain of per-layer costs into contiguous stages minimizing the
    max stage cost (torchgpipe's balance_by_time objective). Exact DP.

    Returns bounds of length num_stages+1 with bounds[0]=0, bounds[-1]=n.
    """
    n = len(costs)
    if num_stages >= n:
        # degenerate: one layer per stage, pad trailing bounds
        return list(range(n + 1)) + [n] * (num_stages - n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))

    def span(i, j):  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # dp[k][j] = min over splits of max-load using k stages for first j layers
    dp = [[INF] * (n + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(num_stages + 1)]
    dp[0][0] = 0.0
    for k in range(1, num_stages + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                v = max(dp[k - 1][i], span(i, j))
                if v < dp[k][j]:
                    dp[k][j] = v
                    cut[k][j] = i
    bounds = [n]
    j = n
    for k in range(num_stages, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    return bounds[::-1]


def model_shapes(model: LayerModel) -> List[Tuple[int, ...]]:
    """Per-example boundary shapes in the reference's order: the input
    shape, then each layer's output (an image map as (H, W, C), a token
    stream as (T, d)). Image layers record theirs; otherwise one batch-1
    forward in eval mode, without gradients, on the model's device reads
    them (eval mode leaves BatchNorm's running statistics alone)."""
    layers = list(model.layers)
    if all(hasattr(layer, "out_shape") for layer in layers):
        return [tuple(model.in_shape)] + [tuple(layer.out_shape)
                                          for layer in layers]
    p = next(model.parameters())
    if len(model.in_shape) == 1:  # token ids
        x = torch.zeros((1,) + tuple(model.in_shape), dtype=torch.long,
                        device=p.device)
    else:
        h, w, c = model.in_shape
        x = torch.zeros((1, c, h, w), dtype=p.dtype, device=p.device)
    shapes = [tuple(model.in_shape)]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for layer in layers:
                x = layer(x)
                s = tuple(x.shape[1:])
                shapes.append((s[1], s[2], s[0]) if x.dim() == 4 else s)
    finally:
        model.train(was_training)
    return shapes


def layer_flop_costs(model: LayerModel,
                     shapes: Sequence[Tuple[int, ...]]) -> List[float]:
    """Analytic per-layer FLOP estimate for load balancing: 2 x the
    layer's parameter count x its output's spatial size (the product of
    all but the last output dimension; 1 for a vector), at least 1. A
    layer whose flat output hides its geometry (a packed span of a
    branchy DAG, models/branchy.py) states it as ``cost_spatial``: one
    number, or one per node, whose costs are then summed node by node
    (``nodes``), as the reference's packed spans advertise theirs."""
    costs = []
    for layer, out_shape in zip(model.layers, shapes[1:]):
        spatial = getattr(layer, "cost_spatial", None)
        if isinstance(spatial, (list, tuple)):
            costs.append(sum(
                max(1.0, 2.0 * sum(p.numel() for p in node.parameters())
                    * s) for node, s in zip(layer.nodes, spatial)))
            continue
        n_params = sum(p.numel() for p in layer.parameters())
        if spatial is None:
            spatial = math.prod(out_shape[:-1]) if len(out_shape) > 1 else 1
        costs.append(max(1.0, 2.0 * n_params * spatial))
    return costs
