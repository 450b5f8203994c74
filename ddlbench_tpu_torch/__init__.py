"""PyTorch/CUDA port of ddlbench_tpu for one NVIDIA H100.

A second package beside the JAX reference, mirroring its paths: the
serving path (config, models, ops, serve, telemetry, tools/servebench) and
the token-training path (data/synthetic, parallel/{common,single,api},
tools/{lmbench,timing}), with hand-written Hopper kernels for the paged
attention and the flash attention (forward, dQ, dK/dV) that the reference
runs as Pallas TPU kernels. It imports torch, numpy and the standard
library, never jax or ddlbench_tpu.
"""
