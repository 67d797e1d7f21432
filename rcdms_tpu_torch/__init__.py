"""RCDMs in PyTorch with hand-written Hopper (sm_90a) kernels: the port of
the JAX package `rcdms_tpu`, which stays the reference.

Layout mirrors `rcdms_tpu`: `core/` (layers, attention, temporal, resnet,
schedulers), `models/` (story UNet, fusion, VAE, CLIP towers, frame prior),
`ops/` (the four kernel wrappers, their plain versions, the nvcc build),
`sample/` (UnCLIP and DDIM samplers, the two-stage pipeline), `io/` (flax
params -> torch state dicts). The config dataclasses are the JAX package's
own `rcdms_tpu.configs`, which import no JAX.
"""
