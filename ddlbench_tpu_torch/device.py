"""Device selection and provenance for the PyTorch port.

The counterpart of ``ddlbench_tpu/distributed.py``'s backend helpers for
one process on one card. Entry points run on ``cuda`` unless the caller
asks for ``cpu``; with no card and no explicit ``cpu`` they raise. There is
no silent CPU fallback: a number taken on the CPU must never pass for a
device number.
"""

from __future__ import annotations

from typing import Optional

import torch

# Version stamp for every JSON record the port's tools emit.
RECORD_SCHEMA_VERSION = 1


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu"; None means
    "cuda"). Asking for cuda on a machine without a card raises. On cuda,
    float32 matrix products and convolutions are pinned to full float32
    (no TF32), so an f32 run means f32."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run on the CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def provenance(device: torch.device) -> dict:
    """The record header every port tool merges into its JSON rows: what
    actually ran (platform, card name and count) and the library versions."""
    on_gpu = device.type == "cuda"
    return {
        "schema_version": RECORD_SCHEMA_VERSION,
        "platform": "gpu" if on_gpu else "cpu",
        "device_kind": (torch.cuda.get_device_name(device) if on_gpu
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_gpu else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
