"""Blocks of the port (rcdms_tpu_torch/core) against the JAX package's flax
modules on the same parameters (through rcdms_tpu_torch/io/bridge.py) and
the same numpy inputs: layers, attention, temporal (both modes), resnet.

On the CPU the JAX blocks take their XLA paths (their plain references)
and the port's kernel wrappers their plain versions.

Tolerance: 3e-5 absolute/relative, as tests/test_parity_torch_blocks.py
holds its torch replicas: fp32 on both sides, differing in summation order
and in how the norms take their moments."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import TemporalConfig
from rcdms_tpu.core import attention as jattn
from rcdms_tpu.core import layers as jlayers
from rcdms_tpu.core import resnet as jresnet
from rcdms_tpu.core import temporal as jtemporal
from rcdms_tpu_torch.core import attention as tattn
from rcdms_tpu_torch.core import layers as tlayers
from rcdms_tpu_torch.core import resnet as tresnet
from rcdms_tpu_torch.core import temporal as ttemporal
from rcdms_tpu_torch.io import bridge
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)

TOL = dict(atol=3e-5, rtol=3e-5)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _flax(module, *args, seed=0):
    """Init a flax module on the inputs; return (params, output)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    params = module.init(jax.random.PRNGKey(seed), *jargs)
    return params["params"], np.asarray(module.apply(params, *jargs))


def _load(module, fill, params):
    """Bridge a flax subtree into `module` with one of the bridge's
    fill-in helpers (they write under a prefix)."""
    sd = {}
    fill(sd, "m", params)
    bridge.load_state_dict(module, {k[2:]: v for k, v in sd.items()})
    return module


def _run(module, *args, **kw):
    with torch.no_grad():
        t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
        return module(*t, **kw).numpy()


# --- layers -----------------------------------------------------------------


@pytest.mark.parametrize("dim", [32, 33])
def test_time_embedding_and_positional_encoding(dim):
    t = np.array([0, 1, 500, 999], np.int32)
    ref = jlayers.sinusoidal_time_embedding(jnp.asarray(t), dim)
    out = tlayers.sinusoidal_time_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        tlayers.temporal_positional_encoding(5, dim).numpy(),
        np.asarray(jlayers.temporal_positional_encoding(5, dim)), **TOL)


def test_timestep_embedding():
    x = _x(0, 3, 16)
    params, ref = _flax(jlayers.TimestepEmbedding(32, out_dim=24), x)
    m = _load(tlayers.TimestepEmbedding(16, 32, 24), bridge._time_embedding,
              params)
    np.testing.assert_allclose(_run(m, x), ref, **TOL)


def test_groupnorm_per_frame_and_layernorm():
    x = _x(1, 2, 3, 4, 4, 16, scale=3.0) + 1.5
    params, ref = _flax(jlayers.GroupNorm(4, eps=1e-6), x)
    m = tlayers.GroupNorm(4, 16, eps=1e-6)
    bridge.load_state_dict(m, bridge._norm(params))
    np.testing.assert_allclose(_run(m, x), ref, **TOL)

    y = _x(2, 2, 5, 24) * 2 + 0.5
    params, ref = _flax(jlayers.LayerNorm(), y)
    m = tlayers.LayerNorm(24)
    bridge.load_state_dict(m, bridge._layernorm(params))
    np.testing.assert_allclose(_run(m, y), ref, **TOL)


@pytest.mark.parametrize("activation", ["geglu", "gelu"])
def test_feedforward(activation):
    x = _x(3, 2, 5, 7, 16)
    params, ref = _flax(jlayers.FeedForward(activation), x)
    m = _load(tlayers.FeedForward(16, activation), bridge._feedforward,
              params)
    np.testing.assert_allclose(_run(m, x), ref, **TOL)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_frame_conv(k, stride, pad):
    x = _x(4, 1, 3, 8, 8, 6)
    params, ref = _flax(jlayers.FrameConv(10, k, stride, pad), x)
    m = tlayers.FrameConv(6, 10, k, stride=stride, padding=pad)
    bridge.load_state_dict(m, bridge._conv(params["conv"]))
    np.testing.assert_allclose(_run(m, x), ref, **TOL)


# --- attention --------------------------------------------------------------


def test_attention_self_masked_and_cross():
    x, ctx = _x(5, 2, 3, 9, 16), _x(6, 2, 3, 7, 12)
    mask = np.triu(np.full((9, 9), -1e4, np.float32), 1)
    params, ref = _flax(jattn.Attention(2, 8, qkv_bias=True), x, None, mask)
    m = _load(tattn.Attention(16, 2, 8, qkv_bias=True), bridge._attention,
              params)
    np.testing.assert_allclose(_run(m, x, mask=torch.from_numpy(mask)), ref,
                               **TOL)

    params, ref = _flax(jattn.Attention(2, 8), x, ctx)
    m = _load(tattn.Attention(16, 2, 8, context_dim=12), bridge._attention,
              params)
    np.testing.assert_allclose(_run(m, x, ctx), ref, **TOL)


def test_basic_block_geglu_cross():
    x, ctx = _x(7, 1, 2, 16, 16), _x(8, 1, 2, 7, 12)
    params, ref = _flax(jattn.BasicTransformerBlock(2, 8, use_cross=True),
                        x, ctx)
    m = _load(tattn.BasicTransformerBlock(16, 2, 8, context_dim=12),
              bridge._basic_block, params)
    np.testing.assert_allclose(_run(m, x, ctx), ref, **TOL)


def test_basic_block_prior_variant_masked():
    x = _x(9, 2, 3, 10, 16)
    mask = np.triu(np.full((10, 10), -1e4, np.float32), 1)[None, None, None]
    blk = jattn.BasicTransformerBlock(2, 8, activation="gelu",
                                      attention_bias=True)
    params, ref = _flax(blk, x, None, mask)
    m = _load(tattn.BasicTransformerBlock(16, 2, 8, activation="gelu",
                                          attention_bias=True),
              bridge._basic_block, params)
    np.testing.assert_allclose(_run(m, x, mask=torch.from_numpy(mask)), ref,
                               **TOL)


def test_spatial_transformer():
    """16 x 16 = 256 tokens: the port routes this to kernel A's wrapper."""
    x, ctx = _x(10, 1, 2, 16, 16, 16), _x(11, 1, 2, 7, 12)
    params, ref = _flax(jattn.SpatialTransformer(2, 8, norm_groups=4), x,
                        ctx)
    m = _load(tattn.SpatialTransformer(16, 2, 8, 12, norm_groups=4),
              bridge._spatial_transformer, params)
    np.testing.assert_allclose(_run(m, x, ctx), ref, **TOL)


def test_spatial_transformer_loads_1x1_conv_projections():
    m = tattn.SpatialTransformer(16, 2, 8, 12, norm_groups=4)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    sd["proj_in.weight"] = sd["proj_in.weight"][:, :, None, None]
    m.load_state_dict(sd)
    assert m.proj_in.weight.dim() == 2


# --- temporal ---------------------------------------------------------------

_TCFG = TemporalConfig(num_heads=2, num_blocks=1, zero_init_output=False)


def test_temporal_module_unet_mode():
    x = _x(12, 1, 5, 4, 4, 32)
    params, ref = _flax(jtemporal.TemporalModule(32, _TCFG), x)
    m = _load(ttemporal.TemporalModule(32, port_config(_TCFG)),
              bridge._temporal, params)
    np.testing.assert_allclose(_run(m, x), ref, **TOL)


def test_temporal_module_prior_mode():
    x = _x(13, 2, 5, 7, 16)
    params, ref = _flax(jtemporal.TemporalModule(16, _TCFG), x)
    m = _load(ttemporal.TemporalModule(16, port_config(_TCFG),
                                        prior_mode=True),
              bridge._temporal, params)
    np.testing.assert_allclose(_run(m, x), ref, **TOL)


def test_temporal_module_zero_init_is_identity():
    m = ttemporal.TemporalModule(16, port_config(dataclasses.replace(
        _TCFG, zero_init_output=True)), prior_mode=True)
    tlayers.init_like_flax_(m, torch.Generator().manual_seed(0))
    x = _x(14, 1, 5, 3, 16)
    np.testing.assert_array_equal(_run(m, x), x)


# --- resnet -----------------------------------------------------------------


@pytest.mark.parametrize("c_in,c_out", [(16, 16), (16, 24)])
def test_resnet_block(c_in, c_out):
    x, temb = _x(15, 2, 3, 6, 6, c_in), _x(16, 2, 20)
    params, ref = _flax(jresnet.ResnetBlock(c_out, groups=4), x, temb)
    m = _load(tresnet.ResnetBlock(c_in, c_out, 20, groups=4),
              bridge._resnet, params)
    np.testing.assert_allclose(_run(m, x, temb), ref, **TOL)


@pytest.mark.parametrize("which", ["down", "up"])
def test_resample(which):
    x = _x(17, 1, 2, 6, 6, 8)
    jm = (jresnet.Downsample(8) if which == "down" else jresnet.Upsample(8))
    params, ref = _flax(jm, x)
    m = tresnet.Downsample(8) if which == "down" else tresnet.Upsample(8)
    bridge.load_state_dict(m, {f"conv.{k}": v for k, v in
                               bridge._conv(params["conv"]["conv"]).items()})
    np.testing.assert_allclose(_run(m, x), ref, **TOL)
