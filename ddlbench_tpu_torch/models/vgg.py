"""VGG-11/16, batch-norm variants, as flat layer lists
(``ddlbench_tpu/models/vgg.py``).

Inputs of at most 64 px classify from the 512-channel map through a global
average pool; larger ones keep the 4096-wide two-layer classifier over the
flattened map, flattened in the reference's (H, W, C) order
(layers.Flatten). Five 2x2 VALID pools take 28 px (mnist) to 0, which the
reference carries into a NaN mean; here the build raises.
"""

from __future__ import annotations

from typing import List

import torch

from ddlbench_tpu_torch.models.layers import (ConvBN, Dense, Flatten,
                                              GlobalAvgPool, ImageLayer,
                                              LayerModel, MaxPool)

_CFG = {
    # torchvision cfgs A (vgg11) and D (vgg16); "M" = 2x2 max pool
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
}


def build_vgg(arch: str, in_shape, num_classes: int,
              seed: int = 0) -> LayerModel:
    """``arch`` for per-example input ``in_shape`` (H, W, C) with random
    weights from ``seed``; raises ValueError where the map vanishes."""
    gen = torch.Generator().manual_seed(seed)
    layers: List[ImageLayer] = []
    shape = lambda: layers[-1].out_shape if layers else tuple(in_shape)
    conv_i = pool_i = 0
    for item in _CFG[arch]:
        if item == "M":
            pool_i += 1
            layers.append(MaxPool(f"pool{pool_i}", shape(), window=2,
                                  stride=2))
        else:
            conv_i += 1
            layers.append(ConvBN(f"conv{conv_i}", shape(), int(item),
                                 kernel=3, stride=1, gen=gen))
    if in_shape[0] <= 64:
        layers.append(GlobalAvgPool("gap", shape()))
        layers.append(Dense("fc", shape(), num_classes, gen=gen))
    else:
        layers.append(Flatten("flatten", shape()))
        layers.append(Dense("fc1", shape(), 4096, relu=True, gen=gen))
        layers.append(Dense("fc2", shape(), 4096, relu=True, gen=gen))
        layers.append(Dense("fc3", shape(), num_classes, gen=gen))
    return LayerModel(arch, layers, in_shape, num_classes)
