"""RCDMs in PyTorch with hand-written Hopper (sm_90a) kernels: the port of
the JAX package `rcdms_tpu`, which stays the reference.

Layout mirrors `rcdms_tpu`: `core/` (layers, attention, temporal, resnet,
schedulers), `models/` (story UNet, fusion, VAE, CLIP towers, frame prior),
`ops/` (the kernel wrappers, their plain versions, the nvcc build),
`sample/` (UnCLIP and DDIM samplers, the two-stage pipeline), `io/` (flax
params -> torch state dicts), `tools/` (the ported kernel studies),
`configs.py` (the model config dataclasses, the port's own copy). The port
imports nothing of `rcdms_tpu`.
"""
