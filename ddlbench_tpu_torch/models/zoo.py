"""Model registry of the port: (arch, dataset) -> LayerModel.

The port trains the image models of ``ddlbench_tpu/models/zoo.py``
(resnet18/50/152, vgg11/16, mobilenetv2, and lenet, alexnet, squeezenet,
resnext50, densenet121 from models/extra.py, and the branchy inception
and nasnet from models/branchy.py, run as their chains of composite
layers) on the image benchmarks (mnist, cifar10, imagenet, highres),
trains and serves the causal-LM
``transformer_*`` arches on the token benchmarks (synthtext, longctx,
longctx32k) and trains and decodes the prefix-LM ``seq2seq_*`` arches on
the seq2seq benchmark (synthmt). The reference's other arches (:data:`NOT_PORTED`)
raise ``NotImplementedError``.
"""

from __future__ import annotations

from ddlbench_tpu_torch.config import DATASETS, DatasetSpec
from ddlbench_tpu_torch.models import branchy, extra, seq2seq, transformer
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.mobilenetv2 import build_mobilenetv2
from ddlbench_tpu_torch.models.resnet import _DEPTHS, build_resnet
from ddlbench_tpu_torch.models.vgg import _CFG as _VGG, build_vgg

IMAGE_ARCHS = tuple(_DEPTHS) + tuple(_VGG) + ("mobilenetv2",)
# the rest of the reference's image zoo
EXTRA_ARCHS = tuple(extra.BUILDERS) + ("inception", "nasnet")
MODEL_NAMES = (IMAGE_ARCHS + EXTRA_ARCHS + tuple(transformer._VARIANTS)
               + tuple(seq2seq._VARIANTS))
# the reference's arches the port does not build yet -> ROADMAP item
NOT_PORTED = {
    "transformer_moe_s": "A.5",
    "seq2seq_lstm_s": "A.5",
}


def get_model(arch: str, dataset, seed: int = 0) -> LayerModel:
    """Build ``arch`` for ``dataset`` (a name in DATASETS or a
    DatasetSpec) with random weights from ``seed``."""
    spec = dataset if isinstance(dataset, DatasetSpec) else DATASETS[dataset]
    if arch in NOT_PORTED or "lstm" in arch or "moe" in arch:
        item = NOT_PORTED.get(arch, "A.5")
        raise NotImplementedError(
            f"{arch} is not ported to the PyTorch path yet (ROADMAP "
            f"{item})")
    if arch.startswith("seq2seq"):
        if spec.kind != "seq2seq":
            raise ValueError(f"{arch} requires a seq2seq dataset, got "
                             f"{spec.name}")
        if arch not in seq2seq._VARIANTS:
            raise ValueError(f"unknown arch {arch!r}; the port builds "
                             f"{MODEL_NAMES}")
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
    if arch not in transformer._VARIANTS:
        raise ValueError(f"unknown arch {arch!r}; the port builds "
                         f"{MODEL_NAMES}")
    if spec.kind != "tokens":
        raise ValueError(f"{arch} requires a token dataset, got {spec.name}")
    return transformer.build_transformer(arch, spec.image_size,
                                         spec.num_classes, seed)
