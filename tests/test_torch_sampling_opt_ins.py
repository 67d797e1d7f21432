"""The port's sampling opt-ins against the JAX package on the CPU: DDIM with
eta > 0, the story UNet split into `encode` / `decode`, the story
sampler's batched CFG, encoder propagation and eta, and the
autoregressive prior; then the port's own noise plumbing (`StoryNoise.draw`
and `cat`: a request gets the same noise alone and in a batch).

Each JAX sampler runs as it is on the same seeded numpy inputs, its
randomness rebuilt here from its own key schedule and injected into the
port. The towers are the port's seeded weights (perturbed, temporal
output projections live), converted for flax by the JAX package's
converters. Tolerances: 1e-6 for one DDIM step; for the split UNet, bit
for bit against the port's own unsplit UNet and 1e-4 against flax, as
tests/test_torch_models.py holds the unsplit one; `SAMPLER_TOL` (5e-4)
for whole samplers, as tests/test_torch_pipeline.py holds them (fp32)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import FusionConfig, PriorConfig, StoryUNetConfig
from rcdms_tpu.core import schedulers as jsched
from rcdms_tpu.io import convert
from rcdms_tpu.models import fusion as jfusion
from rcdms_tpu.models import prior as jprior
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.sample import prior_sampler as jps
from rcdms_tpu.sample import story_sampler as jss
from rcdms_tpu_torch.core.schedulers import DDIMSchedule
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.sample.pipeline import StoryNoise, build_tiny_pipeline
from rcdms_tpu_torch.sample.prior_sampler import (
    PriorConditioning,
    PriorSampler,
)
from rcdms_tpu_torch.sample.story_sampler import (
    StoryConditioning,
    StorySampler,
)
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_models import _weights, _x

SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
B, F, H8 = 1, 5, 8


def _live(cfg):
    return dataclasses.replace(cfg, temporal=dataclasses.replace(
        cfg.temporal, zero_init_output=False))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# DDIM eta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,prev_t", [(981, 931), (481, 431), (1, -49)])
def test_ddim_eta_step_matches_jax(t, prev_t):
    out_, sample, noise = _x(0, 2, 4, 4, 4), _x(1, 2, 4, 4, 4), \
        _x(2, 2, 4, 4, 4)
    ref = jsched.DDIMSchedule.stage2_inference().step(
        jnp.asarray(out_), jnp.int32(t), jnp.int32(prev_t),
        jnp.asarray(sample), eta=0.3, noise=jnp.asarray(noise))
    got = DDIMSchedule.stage2_inference().step(
        _t(out_), t, prev_t, _t(sample), eta=0.3, noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_ddim_eta_needs_noise_and_eta_zero_is_the_exact_step():
    s = DDIMSchedule.stage2_inference()
    x = _t(_x(3, 4, 4))
    with pytest.raises(ValueError, match="noise"):
        s.step(x, 501, 451, x, eta=0.5)
    torch.testing.assert_close(s.step(x, 501, 451, x, eta=0.0, noise=x),
                               s.step(x, 501, 451, x), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the split UNet and the story sampler's variants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def story_towers():
    """(port UNet, port fusion, JAX UNet, JAX fusion, their params, the
    conditioning arrays) at the tiny configs."""
    ucfg, fcfg = _live(StoryUNetConfig.tiny()), FusionConfig.tiny()
    unet, fusion = StoryUNet(port_config(ucfg)), FusionModule(
        port_config(fcfg))
    uparams = {"params": convert.convert_rcdms_unet3d(_weights(unet, 1),
                                                       ucfg)}
    blob = convert.split_deepspeed_blob(_weights(fusion, 2))
    fparams = {"params": {
        "seen_module": convert.convert_fusion_stack(blob["seen"]),
        "unseen_module": convert.convert_fusion_stack(blob["unseen"])}}
    unet.eval()
    fusion.eval()
    t, cross = 7, ucfg.cross_attention_dim
    known = np.array([[True, False, False, True, False]])
    mask = np.broadcast_to(known[:, :, None, None, None].astype(np.float32),
                           (B, F, H8, H8, 1))
    cond = dict(text_hidden=_x(10, B, F, t, cross),
                text_hidden_u=_x(11, B, F, t, cross),
                image_tokens=_x(12, B, F, 5, fcfg.seen_vis_dim),
                image_proj=_x(13, B, F, fcfg.unseen_vis_dim),
                frame_known=known, masked_latents=_x(14, B, F, H8, H8, 4),
                mask_label=np.ascontiguousarray(mask))
    return (unet, fusion, junet.StoryUNet(ucfg), jfusion.FusionModule(fcfg),
            uparams, fparams, cond)


def test_unet_forward_is_decode_of_encode(story_towers):
    unet = story_towers[0]
    sample, ctx = _t(_x(20, B, F, H8, H8, 9)), _t(_x(21, B, F, 7, 24))
    tb = torch.tensor([601])
    with torch.no_grad():
        out = unet(sample, tb, ctx)
        temb = unet.time_embed(tb, sample.dtype)
        calls = unet.encode_calls
        split = unet.decode(*unet.encode(sample, temb, ctx), temb, ctx)
    assert unet.encode_calls == calls + 1
    torch.testing.assert_close(split, out, rtol=0, atol=0)


def test_unet_encode_decode_match_flax(story_towers):
    unet, _, jm, _, uparams, _, _ = story_towers
    sample, ctx = _x(22, B, F, H8, H8, 9), _x(23, B, F, 7, 24)
    temb = np.asarray(jm.apply(uparams, jnp.array([333], jnp.int32),
                               method=junet.StoryUNet.time_embed))
    h, skips = jm.apply(uparams, sample, temb, ctx,
                        method=junet.StoryUNet.encode)
    out = jm.apply(uparams, h, list(skips), temb, ctx,
                   method=junet.StoryUNet.decode)
    with torch.no_grad():
        # the split keeps the port's own unsplit UNet, bit for bit
        t = torch.tensor([333])
        whole = unet(_t(sample), t, _t(ctx))
        ptemb = unet.time_embed(t, torch.float32)
        split = unet.decode(*unet.encode(_t(sample), ptemb, _t(ctx)), ptemb,
                            _t(ctx))
        th, tskips = unet.encode(_t(sample), _t(temb), _t(ctx))
        tout = unet.decode(_t(np.asarray(h)),
                           [_t(np.asarray(s)) for s in skips], _t(temb),
                           _t(ctx))
    torch.testing.assert_close(split, whole, rtol=0, atol=0)
    # flax at the unsplit UNet's tolerance (tests/test_torch_models.py:
    # TOL): fp32 sums in another order, whose size depends on the CPU
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **tol)
    assert len(tskips) == len(skips)
    for a, b in zip(tskips, skips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **tol)


def _story_pair(story_towers, steps, **kw):
    unet, fusion, jm, jf, uparams, fparams, cond = story_towers
    port = StorySampler(unet, fusion, num_steps=steps, guidance_scale=2.0,
                        **kw)
    ref = jss.StorySampler(jm, jf, num_steps=steps, guidance_scale=2.0, **kw)
    return port, functools.partial(ref, uparams, fparams), cond


@pytest.mark.parametrize("steps,kw", [
    (2, dict(sequential_cfg=False)),
    (3, dict(encoder_propagation=2)),
    (3, dict(encoder_propagation=2, sequential_cfg=False)),
    (2, dict(eta=0.5)),
], ids=["batched_cfg", "propagation2", "propagation2_batched", "eta"])
def test_story_sampler_variant_matches_jax(story_towers, steps, kw):
    port, ref, cond = _story_pair(story_towers, steps, **kw)
    init = _x(30, B, F, H8, H8, 4)
    key = jax.random.PRNGKey(4)
    out_ref = ref(jss.StoryConditioning(**{k: jnp.asarray(v)
                                           for k, v in cond.items()}),
                  key, jnp.asarray(init))
    step_noise = None
    if kw.get("eta"):
        # the JAX sampler's draws: split off the init key, then one
        # normal(fold_in(key, i)) a step
        k, _ = jax.random.split(key)
        step_noise = _t(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, i), init.shape)) for i in range(steps)]))
    out = port(StoryConditioning(**{k: _t(v) for k, v in cond.items()}),
               _t(init), step_noise=step_noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref),
                               **SAMPLER_TOL)


# one step at 1e-5 (it reads 2.4e-7); over two steps the two batch shapes'
# fp32 rounding compounds to 1.44e-5 at most (CPU, one intra-op thread),
# so 5e-5
@pytest.mark.parametrize("steps,tol", [(1, 1e-5), (2, 5e-5)],
                         ids=["one_step", "two_steps"])
def test_story_sampler_batched_cfg_matches_sequential(story_towers, steps,
                                                      tol):
    cond = StoryConditioning(**{k: _t(v) for k, v in story_towers[6].items()})
    init = _t(_x(31, B, F, H8, H8, 4))
    outs = [StorySampler(story_towers[0], story_towers[1], num_steps=steps,
                         sequential_cfg=seq)(cond, init)
            for seq in (True, False)]
    torch.testing.assert_close(outs[1], outs[0], atol=tol, rtol=tol)


def test_story_sampler_propagation_encodes_on_key_steps(story_towers):
    unet = story_towers[0]
    cond = StoryConditioning(**{k: _t(v) for k, v in story_towers[6].items()})
    init = _t(_x(32, B, F, H8, H8, 4))
    counts = {}
    for k, seq in ((0, True), (2, True), (2, False)):
        before = unet.encode_calls
        StorySampler(unet, story_towers[1], num_steps=3, sequential_cfg=seq,
                     encoder_propagation=k)(cond, init)
        counts[(k, seq)] = unet.encode_calls - before
    # steps 0 and 2 are key steps; two CFG branches a step one after the
    # other, or one batched call
    assert counts == {(0, True): 6, (2, True): 4, (2, False): 2}


def test_story_sampler_eta_draws_step_noise_after_the_init(story_towers):
    """With eta > 0 and a generator, the init is drawn first and then one
    draw a step, so the injected draws give the generator's result."""
    cond = StoryConditioning(**{k: _t(v) for k, v in story_towers[6].items()})
    sampler = StorySampler(story_towers[0], story_towers[1], num_steps=2,
                           eta=0.5)
    out = sampler(cond, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    shape = (B, F, H8, H8, 4)
    init = torch.randn(shape, generator=g)
    steps = torch.stack([torch.randn(shape, generator=g) for _ in range(2)])
    torch.testing.assert_close(sampler(cond, init, step_noise=steps), out,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the autoregressive prior
# ---------------------------------------------------------------------------

def test_autoregressive_prior_matches_jax():
    cfg = _live(PriorConfig.tiny())
    b, d, t, steps = 2, cfg.embedding_dim, cfg.num_text_tokens, 2
    model = FramePrior(port_config(cfg)).eval()
    params = {"params": convert.convert_rcdms_prior(_weights(model, 5),
                                                     cfg)}
    white = _x(40, b, d)
    known = np.array([[True, False, False, False, False],
                      [False, True, False, True, False]])
    mask_embed = np.where(known[..., None], white[:, None],
                          _x(41, b, 1, d))
    text_mask = np.ones((b, F, t), bool)
    text_mask[:, :, 5:] = False
    cond = dict(text_embed=_x(42, b, F, d), text_hidden=_x(43, b, F, t, d),
                text_mask=text_mask, text_embed_u=_x(44, b, F, d),
                text_hidden_u=_x(45, b, F, t, d),
                text_mask_u=np.ones((b, F, t), bool),
                image_embed=np.where(known[..., None], _x(46, b, F, d), 0.0
                                     ).astype(np.float32),
                mask_embed=mask_embed.astype(np.float32))
    key = jax.random.PRNGKey(6)
    ref = jps.PriorSampler(jprior.FramePrior(cfg), num_steps=steps
                           ).autoregressive(
        params, jps.PriorConditioning(**{k: jnp.asarray(v)
                                         for k, v in cond.items()}),
        key, jnp.asarray(white), jnp.asarray(known))
    # each pass i calls the sampler with fold_in(key, i), which splits off
    # its init key and folds the step index into the rest
    noise = []
    for i in range(F):
        k, init_key = jax.random.split(jax.random.fold_in(key, i))
        init = jax.random.normal(init_key, (b, F, d))
        st = [jax.random.normal(jax.random.fold_in(k, j), (b, F, d))
              for j in range(steps)]
        noise.append((_t(init), _t(np.stack(st))))
    out = PriorSampler(model, num_steps=steps).autoregressive(
        PriorConditioning(**{k: _t(v) for k, v in cond.items()}),
        _t(white), _t(known), noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SAMPLER_TOL)
    np.testing.assert_array_equal(out.numpy()[known],
                                  cond["image_embed"][known])


def test_autoregressive_draw_passes_matches_the_generator():
    pipe, _ = build_tiny_pipeline(seed=2, num_steps=1)
    sampler = pipe.prior_sampler
    d = pipe.configs.prior.embedding_dim
    rng = np.random.default_rng(7)
    cond = PriorConditioning(
        *(_t(rng.standard_normal(s).astype(np.float32)) for s in (
            (1, F, d), (1, F, 7, d))), torch.ones(1, F, 7, dtype=torch.bool),
        *(_t(rng.standard_normal(s).astype(np.float32)) for s in (
            (1, F, d), (1, F, 7, d))), torch.ones(1, F, 7, dtype=torch.bool),
        *(_t(rng.standard_normal(s).astype(np.float32)) for s in (
            (1, F, d), (1, F, d))))
    white, known = cond.mask_embed[:, 0], torch.zeros(1, F, dtype=torch.bool)
    by_generator = sampler.autoregressive(
        cond, white, known, generator=torch.Generator().manual_seed(3))
    by_draw = sampler.autoregressive(
        cond, white, known,
        noise=sampler.draw_passes(1, F, torch.Generator().manual_seed(3)))
    torch.testing.assert_close(by_draw, by_generator, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a request's noise alone and in a batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_story_noise_draw_is_what_generate_draws(eta):
    pipe, inputs = build_tiny_pipeline(seed=1, num_steps=1, eta=eta)
    frames, embeds = pipe.generate(inputs,
                                   generator=torch.Generator().manual_seed(5))
    noise = StoryNoise.draw(pipe, 1, torch.Generator().manual_seed(5), 32)
    assert (noise.story_steps is None) == (eta == 0)
    frames_n, embeds_n = pipe.generate(inputs, noise=noise)
    torch.testing.assert_close(frames_n, frames, rtol=0, atol=0)
    torch.testing.assert_close(embeds_n, embeds, rtol=0, atol=0)


def test_story_noise_cat_stacks_requests_along_the_batch():
    pipe, _ = build_tiny_pipeline(seed=1, num_steps=2, eta=0.5)
    draws = [StoryNoise.draw(pipe, 1, torch.Generator().manual_seed(s), 32)
             for s in (1, 2, 3)]
    both = StoryNoise.cat(draws)
    batch_dim = {"prior_steps": 1, "story_steps": 1}
    for name in StoryNoise._fields:
        dim = batch_dim.get(name, 0)
        for i, n in enumerate(draws):
            part = getattr(both, name).narrow(dim, i * getattr(n, name)
                                              .shape[dim],
                                              getattr(n, name).shape[dim])
            torch.testing.assert_close(part, getattr(n, name), rtol=0,
                                       atol=0)
