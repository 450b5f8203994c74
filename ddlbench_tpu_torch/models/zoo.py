"""Model registry of the port: (arch, dataset) -> LayerModel.

The port trains the image models of ``ddlbench_tpu/models/zoo.py``
(resnet18/50/152, vgg11/16, mobilenetv2, and lenet, alexnet, squeezenet,
resnext50, densenet121 from models/extra.py, and the branchy inception
and nasnet from models/branchy.py, run as their chains of composite
layers) on the image benchmarks (mnist, cifar10, imagenet, highres),
trains and serves the causal-LM
``transformer_*`` arches on the token benchmarks (synthtext, longctx,
longctx32k), trains and decodes the MoE ``transformer_moe_*`` arches
there (models/moe.py), trains and decodes the prefix-LM ``seq2seq_*``
arches on the seq2seq benchmark (synthmt) and trains the recurrent
``seq2seq_lstm_*`` arches there (models/lstm.py): every arch of the
reference's zoo.
"""

from __future__ import annotations

from ddlbench_tpu_torch.config import DATASETS, DatasetSpec
from ddlbench_tpu_torch.models import (branchy, extra, lstm, moe, seq2seq,
                                       transformer)
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.mobilenetv2 import build_mobilenetv2
from ddlbench_tpu_torch.models.resnet import _DEPTHS, build_resnet
from ddlbench_tpu_torch.models.vgg import _CFG as _VGG, build_vgg

IMAGE_ARCHS = tuple(_DEPTHS) + tuple(_VGG) + ("mobilenetv2",)
# the rest of the reference's image zoo
EXTRA_ARCHS = tuple(extra.BUILDERS) + ("inception", "nasnet")
MODEL_NAMES = (IMAGE_ARCHS + EXTRA_ARCHS + tuple(transformer._VARIANTS)
               + tuple(moe._VARIANTS) + tuple(seq2seq._VARIANTS)
               + tuple(lstm._VARIANTS))


def _unknown(arch: str) -> ValueError:
    return ValueError(f"unknown arch {arch!r}; the port builds "
                      f"{MODEL_NAMES}")


def get_model(arch: str, dataset, seed: int = 0,
              moe_capacity_factor: float = 1.25) -> LayerModel:
    """Build ``arch`` for ``dataset`` (a name in DATASETS or a
    DatasetSpec) with random weights from ``seed``; an MoE arch's experts
    take ``ceil(moe_capacity_factor * tokens / experts)`` tokens each."""
    spec = dataset if isinstance(dataset, DatasetSpec) else DATASETS[dataset]
    if arch.startswith("seq2seq"):
        if spec.kind != "seq2seq":
            raise ValueError(f"{arch} requires a seq2seq dataset, got "
                             f"{spec.name}")
        if arch in lstm._VARIANTS:
            return lstm.build_lstm_seq2seq(arch, spec.image_size,
                                           spec.num_classes, spec.src_len,
                                           seed)
        if arch not in seq2seq._VARIANTS:
            raise _unknown(arch)
        return seq2seq.build_seq2seq(arch, spec.image_size, spec.num_classes,
                                     spec.src_len, seed)
    if arch in IMAGE_ARCHS + tuple(extra.BUILDERS) + branchy.BRANCHY_ARCHS:
        if spec.kind != "image":
            raise ValueError(f"{arch} requires an image dataset, got "
                             f"{spec.name}")
        if arch in extra.BUILDERS:
            return extra.BUILDERS[arch](spec.image_size, spec.num_classes,
                                        seed)
        if arch in branchy.BRANCHY_ARCHS:
            return branchy.to_chain(branchy.get_dag(
                arch, spec.image_size, spec.num_classes, seed))
        build = (build_resnet if arch.startswith("resnet") else
                 build_vgg if arch.startswith("vgg") else build_mobilenetv2)
        return build(arch, spec.image_size, spec.num_classes, seed)
    if arch not in transformer._VARIANTS and arch not in moe._VARIANTS:
        raise _unknown(arch)
    if spec.kind != "tokens":
        raise ValueError(f"{arch} requires a token dataset, got {spec.name}")
    if arch in moe._VARIANTS:
        return moe.build_transformer_moe(arch, spec.image_size,
                                         spec.num_classes,
                                         moe_capacity_factor, seed)
    return transformer.build_transformer(arch, spec.image_size,
                                         spec.num_classes, seed)
