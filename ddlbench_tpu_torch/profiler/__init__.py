"""Part of the PyTorch port (see ddlbench_tpu_torch/__init__.py)."""
