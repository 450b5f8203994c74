"""LeNet, AlexNet, SqueezeNet, ResNeXt-50 and DenseNet-121 as flat layer
lists (``ddlbench_tpu/models/extra.py``).

Every block is one layer, with the reference's layer, parameter and state
names. Inputs of at most 64 px (mnist, cifar10) take the small stems
that keep the resolution; larger ones the torchvision stems:

* squeezenet's fire module concatenates its 1x1 and 3x3 expansions in
  that order;
* resnext50's bottlenecks convolve their 3x3 in 32 groups (``c2`` is
  (width, width / 32, 3, 3));
* densenet121's dense layers each concatenate their 32 new channels after
  the running map (cast to its type), and its transitions halve the map
  with a VALID 2x2 mean (floor output).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ddlbench_tpu_torch.models.layers import (BatchNorm, ConvBN, ConvReLU,
                                              Dense, Flatten, GlobalAvgPool,
                                              ImageLayer, LayerModel,
                                              MaxPool, _conv_kernel, conv2d,
                                              out_hw)


class _Builder:
    """Appends layers, each built on the previous layer's output shape."""

    def __init__(self, in_shape, seed: int):
        self.in_shape = tuple(in_shape)
        self.gen = torch.Generator().manual_seed(seed)
        self.layers: List[ImageLayer] = []

    @property
    def shape(self):
        return self.layers[-1].out_shape if self.layers else self.in_shape

    def add(self, cls, name, *args, **kw):
        if cls in _NEEDS_GEN:
            kw["gen"] = self.gen
        self.layers.append(cls(name, self.shape, *args, **kw))

    def model(self, arch: str, num_classes: int) -> LayerModel:
        return LayerModel(arch, self.layers, self.in_shape, num_classes)


class Fire(ImageLayer):
    """SqueezeNet's fire module: 1x1 squeeze -> ReLU, then the 1x1 and 3x3
    expansions (each -> ReLU) concatenated in that order; no biases."""

    def __init__(self, name: str, in_shape, squeeze: int, expand: int, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (h, w, 2 * expand))
        self.sq = _conv_kernel(gen, 1, 1, c, squeeze)
        self.e1 = _conv_kernel(gen, 1, 1, squeeze, expand)
        self.e3 = _conv_kernel(gen, 3, 3, squeeze, expand)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sq = F.relu(conv2d(x, self.sq))
        return torch.cat([F.relu(conv2d(sq, self.e1)),
                          F.relu(conv2d(sq, self.e3))], dim=1)


class ResNeXtBlock(ImageLayer):
    """Grouped bottleneck: 1x1 -> grouped 3x3 (stride) -> 1x1 (x
    expansion), each with BatchNorm, identity or projection shortcut."""

    def __init__(self, name: str, in_shape, width: int, stride: int,
                 groups: int = 32, expansion: int = 2, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        out_ch = width * expansion
        super().__init__(name, (*out_hw(name, h, w, 3, stride, "SAME"),
                                out_ch))
        self.c1 = _conv_kernel(gen, 1, 1, c, width)
        self.c2 = _conv_kernel(gen, 3, 3, width // groups, width)
        self.c3 = _conv_kernel(gen, 1, 1, width, out_ch)
        self.bn1, self.bn2 = BatchNorm(width), BatchNorm(width)
        self.bn3 = BatchNorm(out_ch)
        if stride != 1 or c != out_ch:
            self.proj = _conv_kernel(gen, 1, 1, c, out_ch)
            self.bnp = BatchNorm(out_ch)
        else:
            self.proj = None
        self.stride, self.groups = stride, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d(x, self.c1)))
        y = F.relu(self.bn2(conv2d(y, self.c2, self.stride, self.groups)))
        y = self.bn3(conv2d(y, self.c3))
        sc = (x if self.proj is None
              else self.bnp(conv2d(x, self.proj, self.stride)))
        return F.relu(y + sc)


class DenseBlock(ImageLayer):
    """``n_layers`` of BN-ReLU-1x1 -> BN-ReLU-3x3, each concatenating its
    ``growth`` new channels after the running map."""

    def __init__(self, name: str, in_shape, n_layers: int, growth: int = 32,
                 bn_size: int = 4, *, gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (h, w, c + n_layers * growth))
        self.n_layers = n_layers
        ch = c
        for i in range(n_layers):
            setattr(self, f"l{i}_bn1", BatchNorm(ch))
            setattr(self, f"l{i}_c1",
                    _conv_kernel(gen, 1, 1, ch, bn_size * growth))
            setattr(self, f"l{i}_bn2", BatchNorm(bn_size * growth))
            setattr(self, f"l{i}_c2",
                    _conv_kernel(gen, 3, 3, bn_size * growth, growth))
            ch += growth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for i in range(self.n_layers):
            y = F.relu(getattr(self, f"l{i}_bn1")(feats))
            y = conv2d(y, getattr(self, f"l{i}_c1"))
            y = F.relu(getattr(self, f"l{i}_bn2")(y))
            y = conv2d(y, getattr(self, f"l{i}_c2"))
            feats = torch.cat([feats, y.to(feats.dtype)], dim=1)
        return feats


class Transition(ImageLayer):
    """DenseNet's transition: BN -> ReLU -> 1x1 conv -> VALID 2x2 mean
    (torch's AvgPool2d(2, 2): floor output, no padding)."""

    def __init__(self, name: str, in_shape, out_ch: int, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (h // 2, w // 2, out_ch))
        self.conv = _conv_kernel(gen, 1, 1, c, out_ch)
        self.bn = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(F.relu(self.bn(x)), self.conv)
        return F.avg_pool2d(y, 2, 2)


class BNReLU(ImageLayer):
    """BatchNorm -> ReLU over the final map (torchvision DenseNet's
    norm5)."""

    def __init__(self, name: str, in_shape):
        super().__init__(name, in_shape)
        self.bn = BatchNorm(in_shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(x))


_NEEDS_GEN = (ConvBN, ConvReLU, Dense, Fire, ResNeXtBlock, DenseBlock,
              Transition)


def build_lenet(in_shape, num_classes: int, seed: int = 0) -> LayerModel:
    b = _Builder(in_shape, seed)
    b.add(ConvReLU, "conv1", 6, 5)
    b.add(MaxPool, "pool1", 2)
    b.add(ConvReLU, "conv2", 16, 5)
    b.add(MaxPool, "pool2", 2)
    b.add(Flatten, "flatten")
    b.add(Dense, "fc1", 120, relu=True)
    b.add(Dense, "fc2", 84, relu=True)
    b.add(Dense, "fc3", num_classes)
    return b.model("lenet", num_classes)


def build_alexnet(in_shape, num_classes: int, seed: int = 0) -> LayerModel:
    small = in_shape[0] <= 64
    pad = "SAME" if small else "VALID"
    b = _Builder(in_shape, seed)
    b.add(ConvReLU, "conv1", 64, 3 if small else 11, 1 if small else 4)
    b.add(MaxPool, "pool1", 3, 2, pad)
    b.add(ConvReLU, "conv2", 192, 5)
    b.add(MaxPool, "pool2", 3, 2, pad)
    b.add(ConvReLU, "conv3", 384, 3)
    b.add(ConvReLU, "conv4", 256, 3)
    b.add(ConvReLU, "conv5", 256, 3)
    b.add(MaxPool, "pool5", 3, 2, pad)
    b.add(Flatten, "flatten")
    b.add(Dense, "fc1", 4096, relu=True, dropout=0.5)
    b.add(Dense, "fc2", 4096, relu=True, dropout=0.5)
    b.add(Dense, "fc3", num_classes)
    return b.model("alexnet", num_classes)


def build_squeezenet(in_shape, num_classes: int,
                     seed: int = 0) -> LayerModel:
    b = _Builder(in_shape, seed)
    b.add(ConvReLU, "conv1", 64, 3, 1 if in_shape[0] <= 64 else 2)
    b.add(MaxPool, "pool1", 3, 2, "SAME")
    b.add(Fire, "fire2", 16, 64)
    b.add(Fire, "fire3", 16, 64)
    b.add(MaxPool, "pool3", 3, 2, "SAME")
    b.add(Fire, "fire4", 32, 128)
    b.add(Fire, "fire5", 32, 128)
    b.add(MaxPool, "pool5", 3, 2, "SAME")
    for i, (sq, ex) in enumerate([(48, 192), (48, 192), (64, 256),
                                  (64, 256)]):
        b.add(Fire, f"fire{6 + i}", sq, ex)
    b.add(ConvReLU, "conv10", num_classes, 1)
    b.add(GlobalAvgPool, "gap")
    return b.model("squeezenet", num_classes)


def _stem(b: _Builder, ch: int) -> None:
    """The resnet stem: 3x3 stride 1 on small inputs, else 7x7 stride 2
    and a 3x3 stride-2 SAME max pool."""
    if b.in_shape[0] <= 64:
        b.add(ConvBN, "stem", ch, 3, 1)
    else:
        b.add(ConvBN, "stem", ch, 7, 2)
        b.add(MaxPool, "stem_pool", 3, 2, "SAME")


def build_resnext50(in_shape, num_classes: int,
                    seed: int = 0) -> LayerModel:
    b = _Builder(in_shape, seed)
    _stem(b, 64)
    for g, (width, n) in enumerate(zip([128, 256, 512, 1024],
                                       [3, 4, 6, 3])):
        for i in range(n):
            b.add(ResNeXtBlock, f"group{g + 1}_block{i + 1}", width,
                  2 if (i == 0 and g > 0) else 1)
    b.add(GlobalAvgPool, "gap")
    b.add(Dense, "fc", num_classes)
    return b.model("resnext50", num_classes)


def build_densenet121(in_shape, num_classes: int,
                      seed: int = 0) -> LayerModel:
    growth = 32
    b = _Builder(in_shape, seed)
    _stem(b, 2 * growth)
    ch = 2 * growth
    for i, n in enumerate([6, 12, 24, 16]):
        b.add(DenseBlock, f"dense{i + 1}", n, growth)
        ch += n * growth
        if i < 3:
            ch //= 2
            b.add(Transition, f"trans{i + 1}", ch)
    b.add(BNReLU, "norm5")
    b.add(GlobalAvgPool, "gap")
    b.add(Dense, "fc", num_classes)
    return b.model("densenet121", num_classes)


BUILDERS = {
    "lenet": build_lenet,
    "alexnet": build_alexnet,
    "squeezenet": build_squeezenet,
    "resnext50": build_resnext50,
    "densenet121": build_densenet121,
}
