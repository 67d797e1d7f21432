"""The port's samplers and whole two-stage `generate` against the JAX
package on one tiny story with injected noise.

The JAX reference is `tools/capture_ref_noise.py::self_test`, run as it
is: it encodes the conditioning with the JAX towers, runs both JAX
samplers on noise drawn from numpy (RandomState(42): prior init, prior
step noise, VAE noise, story init) and records `reference_prior_embeds`
and `reference_latents`. Its tiny pipeline builder is swapped for one
whose parameters are the port's seeded weights (perturbed, so no bias or
zero-init projection stays zero), converted by the JAX package's own
converters; the port gets the same parameters back through
rcdms_tpu_torch/io/bridge.py.

Tolerances (fp32): 5e-4 for the sampler outputs and 1e-3 for decoded
frames. Two steps of two samplers, each step a full model, compound the
1e-4 per-model differences of test_torch_models.py; the VAE decoder adds
its own on top."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.io import convert
from rcdms_tpu.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from rcdms_tpu.models.fusion import FusionModule
from rcdms_tpu.models.prior import FramePrior
from rcdms_tpu.models.unet3d import StoryUNet
from rcdms_tpu.models.vae import VAE
from rcdms_tpu.sample import pipeline as jpipeline
from rcdms_tpu.sample.prior_sampler import PriorSampler
from rcdms_tpu.sample.story_sampler import StorySampler
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.sample.pipeline import (
    StoryInputs,
    StoryNoise,
    StoryPipeline,
    build_tiny_pipeline,
    padding_mask,
    tiny_configs,
    tiny_inputs,
)
from rcdms_tpu_torch.tools.parity_check import conditioning_from_npz
from tests.test_torch_configs import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import capture_ref_noise  # noqa: E402

STEPS = 2
UNET_CHANNELS = (64, 128)  # what self_test builds
SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
FRAME_TOL = dict(atol=1e-3, rtol=1e-3)


def _jax_params(pipe: StoryPipeline) -> dict:
    """The port's weights as the JAX pipeline's params dict."""
    def sd(m):
        return {k: v.numpy().copy() for k, v in m.state_dict().items()}

    c = pipe.configs
    blob = convert.split_deepspeed_blob(sd(pipe.fusion))
    trees = {
        "text_s1": convert.convert_clip_text(sd(pipe.text_s1), c.text_s1),
        "text_s2": convert.convert_clip_text(sd(pipe.text_s2), c.text_s2),
        "vision": convert.convert_clip_vision(sd(pipe.vision), c.vision),
        "vae": convert.convert_sd_vae(sd(pipe.vae), c.vae),
        "prior": convert.convert_rcdms_prior(sd(pipe.prior), c.prior),
        "unet": convert.convert_rcdms_unet3d(sd(pipe.unet), c.unet),
        "fusion": {
            "seen_module": convert.convert_fusion_stack(blob["seen"]),
            "unseen_module": convert.convert_fusion_stack(blob["unseen"])},
    }
    return {k: {"params": v} for k, v in trees.items()}


def build_story(npz_path: str):
    """(torch pipeline loaded through the bridge, its inputs, the JAX
    params and modules, the self_test arrays); self_test writes
    `npz_path`."""
    configs = tiny_configs(unet_channels=UNET_CHANNELS)
    src = StoryPipeline(configs, num_steps=STEPS)
    g = torch.Generator().manual_seed(0)
    init_like_flax_(src, g)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    params = _jax_params(src)
    inputs = tiny_inputs(configs, seed=0)

    jpipe = jpipeline.StoryPipeline(
        text_encoder_s1=CLIPTextEncoder(configs.text_s1),
        text_encoder_s2=CLIPTextEncoder(configs.text_s2),
        vision_encoder=CLIPVisionEncoder(configs.vision),
        vae=VAE(configs.vae),
        prior_sampler=PriorSampler(FramePrior(configs.prior),
                                   num_steps=STEPS, guidance_scale=2.0),
        story_sampler=StorySampler(StoryUNet(configs.unet),
                                   FusionModule(configs.fusion),
                                   num_steps=STEPS, guidance_scale=2.0))
    jinputs = jpipeline.StoryInputs(*(jnp.asarray(t.numpy())
                                      for t in inputs))

    def fake_builder(**kw):
        assert kw.get("num_steps") == STEPS
        assert kw.get("unet_channels") == UNET_CHANNELS
        return jpipe, params, jinputs

    real = jpipeline.build_tiny_pipeline
    jpipeline.build_tiny_pipeline = fake_builder
    try:
        arrays = capture_ref_noise.self_test(npz_path, steps=STEPS)
    finally:
        jpipeline.build_tiny_pipeline = real

    port = StoryPipeline(configs, num_steps=STEPS).eval()
    bridge.load_pipeline_params(port, params)
    return port, inputs, params, jpipe, arrays


@pytest.fixture(scope="module")
def story(tmp_path_factory):
    """`build_story`'s tuple, once for the module."""
    return build_story(str(tmp_path_factory.mktemp("selftest") / "ref.npz"))


def self_test_noise(port: StoryPipeline, a) -> StoryNoise:
    """self_test's noise (RandomState(42): prior init, prior steps, VAE,
    story init) as the port's StoryNoise."""
    b, f = a["story_frame_known"].shape
    rng = np.random.RandomState(42)  # self_test's draw order
    d = port.configs.prior.embedding_dim
    prior_init = rng.randn(b, f, d).astype(np.float32)
    prior_steps = rng.randn(STEPS, b, f, d).astype(np.float32)
    h8 = a["reference_latents"].shape[2]
    vae = rng.randn(b * f, h8, h8, 4).astype(np.float32)
    story_init = rng.randn(*a["reference_latents"].shape).astype(np.float32)
    np.testing.assert_array_equal(prior_init, a["prior_init_latents"])
    np.testing.assert_array_equal(story_init, a["story_init_latents"])
    return StoryNoise(_t(prior_init), _t(prior_steps), _t(vae),
                      _t(story_init))


def jax_frames(port: StoryPipeline, params, jpipe, a) -> np.ndarray:
    """The JAX VAE's per-frame decode of the JAX story latents, in [0, 1]:
    the frames of the JAX package's `generate` on self_test's noise."""
    b, f, h8 = a["reference_latents"].shape[:3]
    z = a["reference_latents"].reshape((b * f, h8, h8, 4)) / port.vae_scale
    decode = jax.jit(lambda zi: jpipe.vae.apply(params["vae"], zi,
                                                method=VAE.decode))
    ref = np.concatenate([np.asarray(decode(zi[None])) for zi in z])
    return np.clip(ref / 2 + 0.5, 0.0, 1.0).reshape((b, f) + ref.shape[1:])


def _t(a):
    return torch.tensor(np.asarray(a))


def test_prior_sampler_matches_self_test(story):
    port, _, _, _, a = story
    cond, _ = conditioning_from_npz(a)
    out = port.prior_sampler(cond, _t(a["prior_init_latents"]),
                             _t(a["prior_step_noise"]))
    np.testing.assert_allclose(out.numpy(), a["reference_prior_embeds"],
                               **SAMPLER_TOL)


def test_story_sampler_matches_self_test(story):
    port, _, _, _, a = story
    _, cond = conditioning_from_npz(a, a["reference_prior_embeds"])
    out = port.story_sampler(cond, _t(a["story_init_latents"]))
    np.testing.assert_allclose(out.numpy(), a["reference_latents"],
                               **SAMPLER_TOL)


def test_generate_matches_jax_story(story):
    """The whole port `generate`, with self_test's noise injected, against
    the JAX stage-1 embeds and the JAX VAE's per-frame decode of the JAX
    story latents."""
    port, inputs, params, jpipe, a = story
    frames, embeds = port.generate(inputs, noise=self_test_noise(port, a))
    np.testing.assert_allclose(embeds.numpy(), a["reference_prior_embeds"],
                               **SAMPLER_TOL)
    ref = jax_frames(port, params, jpipe, a)
    assert frames.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(frames.numpy(), ref, **FRAME_TOL)


def test_generate_cond_cache_and_generator():
    """CondCache gives the uncached result on protocol inputs (white/black
    mask images by frame_known, one uncond row), and a per-request
    generator makes a story reproducible."""
    pipe, inputs = build_tiny_pipeline(seed=1, num_steps=STEPS)
    c = pipe.configs.vision.image_size
    white, black = torch.full((c, c, 3), 0.75), torch.full((c, c, 3), -0.25)
    known = inputs.frame_known
    mask_clip = torch.where(known[..., None, None, None], white, black)
    inputs = inputs._replace(mask_clip=mask_clip)
    cache = pipe.precompute_cond_cache(inputs.tokens_s1_u[0, 0],
                                       inputs.tokens_s2_u[0, 0], white, black)

    def run(cond_cache):
        return pipe.generate(inputs, cond_cache,
                             torch.Generator().manual_seed(7))

    frames, embeds = run(None)
    frames_c, embeds_c = run(cache)
    np.testing.assert_allclose(frames_c.numpy(), frames.numpy(), atol=1e-5)
    np.testing.assert_allclose(embeds_c.numpy(), embeds.numpy(), atol=1e-5)
    frames_again, _ = run(cache)
    np.testing.assert_array_equal(frames_again.numpy(), frames_c.numpy())
    assert torch.isfinite(frames).all()
    assert frames.min() >= 0 and frames.max() <= 1


def test_cached_generate_reads_the_uncond_row_for_the_mask_alone(
        monkeypatch):
    """With a cache, the stage-1 uncond mask is the padding mask of
    `inputs.tokens_s1_u` (as the reference builds it); `mask_clip` and
    `tokens_s2_u` are not read, and the uncond states are the cache's."""
    pipe, inputs = build_tiny_pipeline(seed=1, num_steps=1)
    c = pipe.configs.vision.image_size
    white, black = torch.full((c, c, 3), 0.75), torch.full((c, c, 3), -0.25)
    cache = pipe.precompute_cond_cache(inputs.tokens_s1_u[0, 0],
                                       inputs.tokens_s2_u[0, 0], white, black)
    # drawn before the sampler is wrapped: the stand-in has no `draw`
    noise = StoryNoise.draw(pipe, 1, torch.Generator().manual_seed(0),
                            tuple(inputs.source_pixels.shape[2:4]))
    seen = []
    sampler = pipe.prior_sampler
    monkeypatch.setattr(pipe, "prior_sampler",
                        lambda cond, *a: seen.append(cond) or sampler(cond,
                                                                      *a))
    eos = pipe.configs.text_s1.eos_token_id
    masks = []
    for pos in (3, 5):
        uncond = torch.zeros_like(inputs.tokens_s1_u)
        uncond[..., pos] = eos
        pipe.generate(inputs._replace(tokens_s1_u=uncond, tokens_s2_u=None,
                                      mask_clip=None), cache,
                      noise=noise)
        cond = seen[-1]
        np.testing.assert_array_equal(cond.text_mask_u.numpy(),
                                      padding_mask(uncond, eos).numpy())
        torch.testing.assert_close(
            cond.text_hidden_u, cache.s1_hidden_u.expand_as(cond.text_hidden))
        torch.testing.assert_close(
            cond.text_embed_u, cache.s1_embed_u.expand_as(cond.text_embed))
        masks.append(cond.text_mask_u)
    assert not torch.equal(masks[0], masks[1])


def test_padding_mask():
    ids = torch.tensor([[[1, 2, 63, 0, 0, 0, 0]]])
    assert padding_mask(ids, 63)[0, 0].tolist() == [True] * 3 + [False] * 4
    assert padding_mask(torch.ones(1, 1, 7, dtype=torch.long), 63).all()
    ref = jpipeline._padding_mask(jnp.asarray(ids.numpy()), 63)
    np.testing.assert_array_equal(padding_mask(ids, 63).numpy(),
                                  np.asarray(ref))


def test_story_inputs_fields_match_jax():
    assert StoryInputs._fields == jpipeline.StoryInputs._fields
