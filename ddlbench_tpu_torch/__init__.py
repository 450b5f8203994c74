"""PyTorch/CUDA port of ddlbench_tpu for one NVIDIA H100.

A second package beside the JAX reference, mirroring its paths: the
serving path (config, models, ops, serve with its replicated fleet and
autoscaler, telemetry, tools/{servebench,servechaos}, train/watchdog),
the token-training path (data/synthetic, parallel/{common,single,api},
tools/{lmbench,timing}) and image training (models/{resnet,vgg,
mobilenetv2}, train/{loop,metrics}, cli, tools/bench), with hand-written
Hopper kernels for the paged attention, the flash attention (forward, dQ,
dK/dV) and the fused LM head that the reference runs as Pallas TPU
kernels. It imports torch, numpy and the standard
library, never jax or ddlbench_tpu.
"""
