"""Part of the PyTorch port (see ddlbench_tpu_torch/__init__.py)."""
from ddlbench_tpu_torch.graph.graph import Graph, Node

__all__ = ["Graph", "Node"]
