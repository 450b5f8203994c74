"""Model registry of the port: (arch, dataset) -> LayerModel.

The port trains and serves the causal-LM ``transformer_*`` arches of
``ddlbench_tpu/models/zoo.py`` on the token benchmarks (synthtext,
longctx, longctx32k); the other families wait for later slices.
"""

from __future__ import annotations

from ddlbench_tpu_torch.config import DATASETS, DatasetSpec
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.transformer import _VARIANTS, build_transformer

MODEL_NAMES = tuple(_VARIANTS)


def get_model(arch: str, dataset, seed: int = 0) -> LayerModel:
    """Build ``arch`` for ``dataset`` (a name in DATASETS or a
    DatasetSpec) with random weights from ``seed``."""
    spec = dataset if isinstance(dataset, DatasetSpec) else DATASETS[dataset]
    if arch not in _VARIANTS:
        raise ValueError(f"unknown arch {arch!r}; the port builds "
                         f"{MODEL_NAMES}")
    if spec.kind != "tokens":
        raise ValueError(f"{arch} requires a token dataset, got {spec.name}")
    return build_transformer(arch, spec.image_size, spec.num_classes, seed)
