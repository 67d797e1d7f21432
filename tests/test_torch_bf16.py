"""The port in bf16 against the JAX package in bf16, on the CPU.

The story runs in bf16, so the port must round where the reference
rounds:

* kernels C and D (`rcdms_tpu_torch/ops/geglu.py`) against the JAX
  package's fused FF Pallas kernels, run in interpret mode at shapes the
  JAX package routes to them (rows >= 128). The TPU kernels keep h + b,
  g + b and the activation in fp32 and round h * gelu(g) (gelu(h + b)) once
  into the bf16 intermediate. Tolerance: every output within one bf16 ulp
  at the output's largest magnitude (2^-7 of max|ref|) and at most 1% of
  the outputs off the reference's bits at all. The two sides differ only
  in summation order and in the TPU kernel's A&S erf (|err| <= 1.5e-7),
  which move a rounding by one ulp now and then; rounding h + b, g + b
  and gelu(g) to bf16 first, as the port once did, moves more than half
  of the outputs;
* one tiny story-UNet call, both sides in bf16 from the same parameters
  (the JAX package's routes forced to its Pallas kernels, in interpret
  mode), with every GroupNorm and LayerNorm scale and bias far from 1 and
  0. Tolerance: max|port - ref| <= 4e-2 max|ref| and mean|port - ref| <=
  1e-2 max|ref|. The two frameworks round bf16 products, bias adds and
  residual adds at other places, and each such ulp grows through the
  blocks: the JAX package's own bf16 output lies about 1.7e-2 max|ref|
  from its fp32 output at this size;
* `build_pipeline(..., dtype=torch.bfloat16)` keeps every norm parameter
  in fp32, as the JAX modules hold them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import StoryUNetConfig
from rcdms_tpu.io import convert
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops.attention import set_default_attention_impl
from rcdms_tpu.ops.geglu import geglu_ff as jgeglu_ff, gelu_ff as jgelu_ff
from rcdms_tpu_torch.core.layers import GroupNorm, LayerNorm, init_like_flax_
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.models import unet3d as tunet
from rcdms_tpu_torch.ops.geglu import geglu_ff, gelu_ff
from rcdms_tpu_torch.sample.pipeline import build_pipeline, tiny_configs
from tests.test_torch_configs import port_config

NORMS = (GroupNorm, LayerNorm)


@pytest.fixture
def jax_kernels():
    """The JAX package's layers routed to its Pallas kernels, run in
    interpret mode; restored afterwards."""
    jflash.set_kernel_interpret(True)
    set_default_attention_impl("pallas")
    try:
        yield
    finally:
        set_default_attention_impl("auto")
        jflash.set_kernel_interpret(False)


def _ff_inputs(seed, c, inner, geglu):
    rng = np.random.default_rng(seed)
    up = 2 * inner if geglu else inner
    x = rng.standard_normal((2, 128, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, up)) * c ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(up) * 0.5).astype(np.float32)
    w2 = (rng.standard_normal((inner, c)) * inner ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geglu", [True, False])
def test_bf16_ff_rounds_once_like_the_tpu_kernel(jax_kernels, geglu, seed):
    x, w1, b1, w2, b2 = _ff_inputs(seed, 64, 256, geglu)
    jfn = jgeglu_ff if geglu else jgelu_ff
    ref = jfn(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray,
                                                        (w1, b1, w2, b2)))
    ref = np.asarray(ref.astype(jnp.float32))

    def bf(a):  # flax (in, out) kernels -> torch (out, in) weights
        return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()

    fn = geglu_ff if geglu else gelu_ff
    out = fn(bf(x), bf(w1.T), bf(b1), bf(w2.T), bf(b2))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    top = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2.0 ** -7 * top
    assert (out != ref).mean() <= 0.01


def _unet_params(m, seed=0):
    """Seeded weights plus noise; norm scales 1 + 0.5 N(0, 1) and biases
    0.5 N(0, 1), so that a rounded norm parameter would change the output.
    Returns the numpy state dict."""
    g = torch.Generator().manual_seed(seed)
    init_like_flax_(m, g)
    with torch.no_grad():
        for mod in m.modules():
            for name, p in mod.named_parameters(recurse=False):
                noise = torch.randn(p.shape, generator=g)
                if isinstance(mod, NORMS):
                    p.copy_((1.0 if name == "weight" else 0.0) + 0.5 * noise)
                else:
                    p.add_(0.05 * noise)
    return {k: v.numpy().copy() for k, v in m.state_dict().items()}


def test_bf16_story_unet_matches_jax(jax_kernels):
    cfg = StoryUNetConfig.tiny()
    cfg = dataclasses.replace(cfg, temporal=dataclasses.replace(
        cfg.temporal, zero_init_output=False))
    params = convert.convert_rcdms_unet3d(
        _unet_params(tunet.StoryUNet(port_config(cfg))), cfg)
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((1, 5, 8, 8, 9)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 7, 24)).astype(np.float32)
    t = np.array([500], np.int32)
    ref = jax.jit(junet.StoryUNet(cfg, dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(sample).astype(jnp.bfloat16), t,
        jnp.asarray(ctx).astype(jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))

    m = tunet.StoryUNet(port_config(cfg)).to(torch.bfloat16)
    bridge.load_state_dict(m, bridge.unet_state_dict({"params": params},
                                                     port_config(cfg)))
    with torch.no_grad():
        out = m(torch.from_numpy(sample).bfloat16(), torch.from_numpy(t),
                torch.from_numpy(ctx).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    diff = np.abs(out.float().numpy() - ref)
    top = np.abs(ref).max()
    assert diff.max() <= 4e-2 * top
    assert diff.mean() <= 1e-2 * top


def test_bf16_pipeline_keeps_norm_parameters_fp32():
    configs = tiny_configs()
    pipe = build_pipeline(configs, "cpu", torch.bfloat16, seed=0,
                          num_steps=1)
    ref = build_pipeline(configs, "cpu", torch.float32, seed=0, num_steps=1)
    towers = ("text_s1", "text_s2", "vision", "vae", "prior", "unet",
              "fusion")
    for tower in towers:
        norms = [n for n, m in getattr(pipe, tower).named_modules()
                 if isinstance(m, NORMS)]
        if tower != "fusion":  # the fusion stacks hold no norm
            assert norms, tower
    ref_params = dict(ref.named_parameters())
    for name, p in pipe.named_parameters():
        mod = pipe.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(mod, NORMS):
            assert p.dtype == torch.float32, name
            assert torch.equal(p, ref_params[name]), name
        else:
            assert p.dtype == torch.bfloat16, name


def test_norm_parameters_load_bit_for_bit_into_a_bf16_module():
    """bridge.load_state_dict keeps each parameter's dtype: flax's fp32
    norm parameters arrive unrounded in a bf16 model."""
    m = LayerNorm(8).to(torch.bfloat16)
    scale = (1.0 + np.random.default_rng(0).standard_normal(8) * 0.3).astype(
        np.float32)
    bridge.load_state_dict(m, {"weight": scale, "bias": scale[::-1].copy()})
    np.testing.assert_array_equal(m.weight.detach().numpy(), scale)
    np.testing.assert_array_equal(m.bias.detach().numpy(), scale[::-1])
