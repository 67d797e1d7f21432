"""RCDMs in PyTorch with hand-written Hopper (sm_90a) kernels: the port of
the JAX package `rcdms_tpu`, which stays the reference.

Layout mirrors `rcdms_tpu`: `core/` (layers, attention, temporal, resnet,
schedulers), `models/` (story UNet, fusion, VAE, CLIP towers, frame prior),
`ops/` (the kernel wrappers, their plain versions, the nvcc build),
`sample/` (UnCLIP and DDIM samplers, the two-stage pipeline, eval
metrics and story PNGs), `data/` (the story protocol and datasets), `io/`
(flax params -> torch state dicts; diffusers / HF / reference checkpoints
-> the port's names), `cli/` (`generate`, `evaluate`), `tools/` (the
ported kernel studies), `configs.py` (the model and dataset config
dataclasses, the port's own copy), `reference_yaml.py` (`--config`). The
port imports nothing of `rcdms_tpu`.
"""
