"""Model registry of the port: (arch, dataset) -> LayerModel.

The port trains and serves the causal-LM ``transformer_*`` arches of
``ddlbench_tpu/models/zoo.py`` on the token benchmarks (synthtext,
longctx, longctx32k) and trains the prefix-LM ``seq2seq_*`` arches on the
seq2seq benchmark (synthmt); the other families wait for later slices.
"""

from __future__ import annotations

from ddlbench_tpu_torch.config import DATASETS, DatasetSpec
from ddlbench_tpu_torch.models import seq2seq, transformer
from ddlbench_tpu_torch.models.layers import LayerModel

MODEL_NAMES = tuple(transformer._VARIANTS) + tuple(seq2seq._VARIANTS)


def get_model(arch: str, dataset, seed: int = 0) -> LayerModel:
    """Build ``arch`` for ``dataset`` (a name in DATASETS or a
    DatasetSpec) with random weights from ``seed``."""
    spec = dataset if isinstance(dataset, DatasetSpec) else DATASETS[dataset]
    if arch.startswith("seq2seq"):
        if spec.kind != "seq2seq":
            raise ValueError(f"{arch} requires a seq2seq dataset, got "
                             f"{spec.name}")
        if "lstm" in arch:
            raise NotImplementedError(
                f"{arch}: the recurrent seq2seq (models/lstm.py) is not "
                "ported yet (ROADMAP A.1)")
        if arch not in seq2seq._VARIANTS:
            raise ValueError(f"unknown arch {arch!r}; the port builds "
                             f"{MODEL_NAMES}")
        return seq2seq.build_seq2seq(arch, spec.image_size, spec.num_classes,
                                     spec.src_len, seed)
    if arch not in transformer._VARIANTS:
        raise ValueError(f"unknown arch {arch!r}; the port builds "
                         f"{MODEL_NAMES}")
    if spec.kind != "tokens":
        raise ValueError(f"{arch} requires a token dataset, got {spec.name}")
    return transformer.build_transformer(arch, spec.image_size,
                                         spec.num_classes, seed)
