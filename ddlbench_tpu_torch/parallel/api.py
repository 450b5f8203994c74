"""Strategy factory of the port (``ddlbench_tpu/parallel/api.py``
``make_strategy``), for the one strategy it carries: ``single``."""

from __future__ import annotations

import torch

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.transformer import set_attention_backend
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.parallel.single import SingleStrategy


def make_strategy(cfg: RunConfig, device: torch.device) -> SingleStrategy:
    """Validate ``cfg``, set the attention backend (which image models do
    not read), build ``cfg.arch`` for ``cfg.benchmark`` with random weights
    from ``cfg.seed`` on ``device``, and return its strategy with fresh
    optimizer state. On the card an image model's convolution kernels are
    channels_last, the layout cuDNN runs fastest, as the data's images
    are."""
    cfg.validate()
    set_attention_backend(cfg.attention_backend)
    model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed,
                      moe_capacity_factor=cfg.moe_capacity_factor).to(device)
    if device.type == "cuda" and cfg.dataset().kind == "image":
        model = model.to(memory_format=torch.channels_last)
    strategy = SingleStrategy(model, cfg)
    strategy.init()
    return strategy
