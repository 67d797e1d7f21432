"""Model towers of the port (rcdms_tpu_torch/models) against the JAX
package's flax models at tiny configs: story UNet, fusion, VAE, both CLIP
text towers and the vision tower, and the frame prior. The torch module's
seeded weights are perturbed with seeded noise (so zero-initialised biases
and embeddings are exercised too) and reach the flax model through the JAX
package's own converters (rcdms_tpu/io/convert.py), which read the port's
state-dict names. The opposite direction, flax -> torch, is
test_torch_bridge.py's.

Tolerance: 1e-4 absolute/relative in fp32. A model chains tens of blocks,
each held to 3e-5 in test_torch_blocks.py, and summation-order
differences grow along the chain."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    FusionConfig,
    PriorConfig,
    StoryUNetConfig,
    VAEConfig,
)
from rcdms_tpu.models import clip as jclip
from rcdms_tpu.models import fusion as jfusion
from rcdms_tpu.models import prior as jprior
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.models import vae as jvae
from rcdms_tpu.io import convert
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.models import clip as tclip
from rcdms_tpu_torch.models import fusion as tfusion
from rcdms_tpu_torch.models import prior as tprior
from rcdms_tpu_torch.models import unet3d as tunet
from rcdms_tpu_torch.models import vae as tvae
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(module, seed=0):
    """Seeded flax-like weights plus noise; returns the numpy state dict."""
    g = torch.Generator().manual_seed(seed)
    init_like_flax_(module, g)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def _apply(jm, params, *args, method=None):
    fn = jax.jit(functools.partial(jm.apply, method=method))
    return fn({"params": params}, *args)


def _np(t):
    return t.detach().numpy()


def _temporal_live(cfg):
    return dataclasses.replace(cfg, temporal=dataclasses.replace(
        cfg.temporal, zero_init_output=False))


def test_story_unet():
    cfg = _temporal_live(StoryUNetConfig.tiny())
    sample, ctx = _x(0, 1, 5, 8, 8, 9), _x(1, 1, 5, 7, 24)
    t = np.array([500], np.int32)
    m = tunet.StoryUNet(port_config(cfg))
    params = convert.convert_rcdms_unet3d(_weights(m), cfg)
    ref = _apply(junet.StoryUNet(cfg), params, sample, t, ctx)
    with torch.no_grad():
        out = m(torch.from_numpy(sample), torch.from_numpy(t),
                torch.from_numpy(ctx))
    assert out.shape == (1, 5, 8, 8, 4)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_fusion():
    cfg = FusionConfig.tiny()
    args = (_x(2, 1, 5, 5, 16), _x(3, 1, 5, 16), _x(4, 1, 5, 7, 24),
            np.array([[True, False, True, False, False]]))
    m = tfusion.FusionModule(port_config(cfg))
    blob = convert.split_deepspeed_blob(_weights(m))
    params = {"seen_module": convert.convert_fusion_stack(blob["seen"]),
              "unseen_module": convert.convert_fusion_stack(blob["unseen"])}
    ref = _apply(jfusion.FusionModule(cfg), params, *args)
    with torch.no_grad():
        out = m(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_vae_encode_decode():
    cfg = VAEConfig.tiny()
    x, z = _x(5, 2, 32, 32, 3), _x(6, 2, 16, 16, 4)
    m = tvae.VAE(port_config(cfg))
    params = convert.convert_sd_vae(_weights(m), cfg)
    jm = jvae.VAE(cfg)
    mean, logvar = _apply(jm, params, x, method=jvae.VAE.encode)
    dec = _apply(jm, params, z, method=jvae.VAE.decode)
    with torch.no_grad():
        tmean, tlogvar = m.encode(torch.from_numpy(x))
        tdec = m.decode(torch.from_numpy(z))
    np.testing.assert_allclose(_np(tmean), np.asarray(mean), **TOL)
    np.testing.assert_allclose(_np(tlogvar), np.asarray(logvar), **TOL)
    np.testing.assert_allclose(_np(tdec), np.asarray(dec), **TOL)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text(act):
    """quick_gelu is the SD tower's activation, gelu bigG's. EOS at
    different positions exercises the first-EOS pooling."""
    cfg = CLIPTextConfig.tiny(hidden_act=act)
    ids = np.random.default_rng(7).integers(0, 60, (3, 7)).astype(np.int32)
    ids[0, 2] = ids[1, 5] = ids[1, 6] = ids[2, 6] = cfg.eos_token_id
    m = tclip.CLIPTextEncoder(port_config(cfg))
    params = convert.convert_clip_text(_weights(m), cfg)
    h, e = _apply(jclip.CLIPTextEncoder(cfg), params, ids)
    with torch.no_grad():
        th, te = m(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(th), np.asarray(h), **TOL)
    np.testing.assert_allclose(_np(te), np.asarray(e), **TOL)


def test_clip_vision():
    cfg = CLIPVisionConfig.tiny()
    px = _x(8, 2, 28, 28, 3)
    m = tclip.CLIPVisionEncoder(port_config(cfg))
    params = convert.convert_clip_vision(_weights(m), cfg)
    h, e = _apply(jclip.CLIPVisionEncoder(cfg), params, px)
    with torch.no_grad():
        th, te = m(torch.from_numpy(px))
    np.testing.assert_allclose(_np(th), np.asarray(h), **TOL)
    np.testing.assert_allclose(_np(te), np.asarray(e), **TOL)


def test_frame_prior():
    cfg = _temporal_live(PriorConfig.tiny())
    b, f, d, t = 2, 5, 16, 7
    mask = np.ones((b, f, t), bool)
    mask[0, :, 4:] = False
    args = (_x(9, b, f, d), np.full((b, f), 700, np.int32), _x(10, b, f, d),
            _x(11, b, f, t, d), _x(12, b, f, d), _x(13, b, f, d), mask)
    m = tprior.FramePrior(port_config(cfg))
    params = convert.convert_rcdms_prior(_weights(m), cfg)
    ref = _apply(jprior.FramePrior(cfg), params, *args)
    with torch.no_grad():
        out = m(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
