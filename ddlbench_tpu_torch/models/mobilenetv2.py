"""MobileNetV2 as a flat layer list (``ddlbench_tpu/models/mobilenetv2.py``).

The stem and the head convolution end in ReLU (the reference's
``conv_bn(relu=True)``), the inverted-residual blocks in ReLU6. Inputs of
at most 64 px take a stride-1 stem and keep stride 1 in the first two
blocks.
"""

from __future__ import annotations

from typing import List

import torch

from ddlbench_tpu_torch.models.layers import (ConvBN, Dense, GlobalAvgPool,
                                              ImageLayer, InvertedResidual,
                                              LayerModel)

# (expansion t, output channels c, repeats n, first block's stride s)
_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def build_mobilenetv2(arch: str, in_shape, num_classes: int,
                      seed: int = 0) -> LayerModel:
    """MobileNetV2 for per-example input ``in_shape`` (H, W, C) with
    random weights from ``seed``."""
    small_input = in_shape[0] <= 64
    gen = torch.Generator().manual_seed(seed)
    layers: List[ImageLayer] = []
    shape = lambda: layers[-1].out_shape if layers else tuple(in_shape)
    layers.append(ConvBN("stem", shape(), 32, kernel=3,
                         stride=1 if small_input else 2, gen=gen))
    block_i = 0
    for t, c, n, s in _CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            if small_input and block_i < 2:
                stride = 1  # keep the early resolution of 28/32 px inputs
            block_i += 1
            layers.append(InvertedResidual(f"block{block_i}", shape(), c,
                                           stride, t, gen=gen))
    layers.append(ConvBN("head_conv", shape(), 1280, kernel=1, stride=1,
                         gen=gen))
    layers.append(GlobalAvgPool("gap", shape()))
    layers.append(Dense("fc", shape(), num_classes, gen=gen))
    return LayerModel("mobilenetv2", layers, in_shape, num_classes)
