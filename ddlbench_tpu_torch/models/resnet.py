"""ResNet-18/50/152 as flat layer lists (``ddlbench_tpu/models/resnet.py``).

Inputs of at most 64 px (mnist, cifar10) take a 3x3 stride-1 stem with no
pool; larger ones (imagenet, highres) the 7x7 stride-2 stem and a 3x3
stride-2 SAME max pool. Each residual block is one layer.
"""

from __future__ import annotations

from typing import List

import torch

from ddlbench_tpu_torch.models.layers import (BasicBlock, Bottleneck,
                                              ConvBN, Dense, GlobalAvgPool,
                                              ImageLayer, LayerModel,
                                              MaxPool)

# (block kind, blocks per group)
_DEPTHS = {
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
}
_WIDTHS = [64, 128, 256, 512]


def build_resnet(arch: str, in_shape, num_classes: int,
                 seed: int = 0) -> LayerModel:
    """``arch`` for per-example input ``in_shape`` (H, W, C) with random
    weights from ``seed``."""
    kind, counts = _DEPTHS[arch]
    gen = torch.Generator().manual_seed(seed)
    layers: List[ImageLayer] = []
    shape = lambda: layers[-1].out_shape if layers else tuple(in_shape)
    if in_shape[0] <= 64:  # mnist/cifar stems keep the resolution
        layers.append(ConvBN("stem", shape(), 64, kernel=3, stride=1,
                             gen=gen))
    else:
        layers.append(ConvBN("stem", shape(), 64, kernel=7, stride=2,
                             gen=gen))
        layers.append(MaxPool("stem_pool", shape(), window=3, stride=2,
                              padding="SAME"))
    for group, (width, n_blocks) in enumerate(zip(_WIDTHS, counts)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and group > 0) else 1
            name = f"group{group + 1}_block{b + 1}"
            block = BasicBlock if kind == "basic" else Bottleneck
            layers.append(block(name, shape(), width, stride, gen=gen))
    layers.append(GlobalAvgPool("gap", shape()))
    layers.append(Dense("fc", shape(), num_classes, gen=gen))
    return LayerModel(arch, layers, in_shape, num_classes)
