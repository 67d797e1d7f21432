"""The port's training step of both stages (rcdms_tpu_torch/train/,
`DDPMSchedule`) against the JAX package's, on the CPU, at the tiny
pipeline's configs.

Seeded numpy weights in the JAX modules' parameter trees (the tiny
pipeline's towers; shapes from `jax.eval_shape` of their `init`, so no
model is compiled to initialise it) reach the port through
rcdms_tpu_torch/io/bridge.py, once with every temporal output projection
zero (as flax initialises it: every gradient inside a temporal module is
then exactly zero) and once live. The JAX trainers draw their noise,
offsets and timesteps from a key; the test draws them from the same key
with `jax.random` and injects them into the port as `TrainNoise`.

Tolerances, fp32 unless noted:
* `DDPMSchedule`: 1e-6 (the same fp32 formulas);
* both `encode_batch` functions: 1e-4, as the towers in
  test_torch_models.py;
* the trainers: the loss within 1e-5 relative, every gradient within
  1e-4 of its tensor's largest |value| (tens of blocks, each summing in
  another order), and the same set of tensors whose gradient is all zero;
* one optimizer step on the bridged JAX state and the JAX gradients:
  1e-6 relative (the same arithmetic in the same order, one rounding of
  each op apart; the global norm that scales the clipped gradients sums
  in another order), with a millionth of a step as the floor of a
  parameter and 1e-6 of the tensor's largest value for a moment.

The bf16 step is held in test_torch_training_bf16.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.core import schedulers as jsched
from rcdms_tpu.models.clip import CLIPTextEncoder as JText
from rcdms_tpu.models.clip import CLIPVisionEncoder as JVision
from rcdms_tpu.models.fusion import FusionModule as JFusion
from rcdms_tpu.models.prior import FramePrior as JPrior
from rcdms_tpu.models.unet3d import StoryUNet as JUNet
from rcdms_tpu.models.vae import VAE as JVAE
from rcdms_tpu.train import stage1 as jstage1
from rcdms_tpu.train import stage2 as jstage2
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.core import schedulers as sched
from rcdms_tpu_torch.core.resnet import ResnetBlock
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.sample.pipeline import StoryPipeline, tiny_configs
from rcdms_tpu_torch.train import loop, stage1, stage2
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.train_state import TrainState
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

B, F, PIXELS = 2, 5, 32  # 16 x 16 latents: 256 queries reach kernel A
LR = 1e-3


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- DDPMSchedule -------------------------------------------------------


@pytest.mark.parametrize("t_shape", [(B,), (B, F)], ids=["story", "frame"])
@pytest.mark.parametrize("preset", ["stage1_train", "stage2_train"])
def test_ddpm_matches_jax(preset, t_shape):
    """add_noise, velocity and the ancestral step, t a story's or a
    frame's (0 among them: the step adds no noise there); add_noise also
    on a bf16 sample, which promotes to fp32 on both sides."""
    rng = np.random.default_rng(0)
    x0, noise, out, eps = (rng.standard_normal((B, F, 4, 3)).astype(
        np.float32) for _ in range(4))
    t = rng.integers(0, 1000, t_shape)
    t.flat[0] = 0
    js, ps = getattr(jsched.DDPMSchedule, preset)(), getattr(
        sched.DDPMSchedule, preset)()
    jt, pt = jnp.asarray(t, jnp.int32), torch.from_numpy(t)
    pairs = [
        (js.add_noise(x0, noise, jt), ps.add_noise(_t(x0), _t(noise), pt)),
        (js.velocity(x0, noise, jt), ps.velocity(_t(x0), _t(noise), pt)),
        (js.step(out, jt, x0, eps), ps.step(_t(out), pt, _t(x0), _t(eps))),
        (js.add_noise(jnp.asarray(x0, jnp.bfloat16), noise, jt),
         ps.add_noise(_t(x0).bfloat16(), _t(noise), pt)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                   atol=1e-6)


# ---- the tiny pipeline's weights and batches -----------------------------


def _towers(cfg):
    """The JAX tiny pipeline's towers (keys of its params dict) and their
    init arguments."""
    f, t = cfg.prior.num_frames, cfg.prior.num_text_tokens
    d, cimg = cfg.prior.embedding_dim, cfg.vision.image_size
    z = jnp.zeros
    ids = z((f, t), jnp.int32)
    return {
        "text_s1": (JText(cfg.text_s1), (ids,)),
        "text_s2": (JText(cfg.text_s2), (ids,)),
        "vision": (JVision(cfg.vision), (z((1, cimg, cimg, 3)),)),
        "vae": (JVAE(cfg.vae), (z((1, PIXELS, PIXELS, 3)),
                                z((1, PIXELS // 2, PIXELS // 2, 4)))),
        "prior": (JPrior(cfg.prior), (z((1, f, d)), z((1, f), jnp.int32),
                                      z((1, f, d)), z((1, f, t, d)),
                                      z((1, f, d)), z((1, f, d)),
                                      jnp.ones((1, f, t), bool))),
        "unet": (JUNet(cfg.unet), (
            z((1, f, PIXELS // 2, PIXELS // 2, cfg.unet.in_channels)),
            z((1,), jnp.int32), z((1, f, t, cfg.unet.cross_attention_dim)))),
        "fusion": (JFusion(cfg.fusion), (
            z((1, f, 5, cfg.fusion.seen_vis_dim)),
            z((1, f, cfg.fusion.unseen_vis_dim)),
            z((1, f, t, cfg.fusion.text_dim)), z((1, f), bool))),
    }


def _draw(rng, path, leaf) -> np.ndarray:
    """A seeded value for one parameter: kernels normal / sqrt(fan in),
    norm scales about 1, the rest (biases, embeddings) about 0."""
    name = jax.tree_util.keystr(path)
    x = rng.standard_normal(leaf.shape)
    if name.endswith("['kernel']"):
        x = x / np.sqrt(np.prod(leaf.shape[:-1]))
    elif name.endswith("['scale']"):
        x = 1.0 + 0.1 * x
    else:
        x = 0.1 * x
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The JAX towers (by params key) and two param sets for them:
    "zero_temporal" and "live"."""
    towers = _towers(tiny_configs())
    rng = np.random.default_rng(1)
    live = {name: jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng),
        jax.eval_shape(m.init, jax.random.PRNGKey(0), *args))
        for name, (m, args) in towers.items()}

    def zero_temporal(path, x):
        name = jax.tree_util.keystr(path)
        return (np.zeros_like(x) if "temporal" in name
                and "proj_out" in name else x)

    zeroed = jax.tree_util.tree_map_with_path(zero_temporal, live)
    return ({name: m for name, (m, _) in towers.items()},
            {"zero_temporal": zeroed, "live": live})


def _port(params) -> StoryPipeline:
    port = StoryPipeline(tiny_configs())
    bridge.load_pipeline_params(port, params)
    return port


def _raw(seed: int) -> dict:
    """A raw protocol batch of both stages' keys (numpy)."""
    cfg = tiny_configs()
    t, eos, csize = cfg.prior.num_text_tokens, cfg.text_s1.eos_token_id, \
        cfg.vision.image_size
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, eos - 1, (B, F, t))
    ends = rng.integers(1, t, (B, F))
    mask = np.arange(t) <= ends[..., None]
    ids[np.arange(t) >= ends[..., None]] = eos
    known = np.zeros((B, F), bool)
    known[:, 0] = True
    known[1, 2] = True

    def px(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    return dict(input_ids=ids.astype(np.int32), text_mask=mask,
                reference_clip=px(B, F, csize, csize, 3),
                source_clip=px(B, F, csize, csize, 3),
                mask_clip=px(B, F, csize, csize, 3),
                target=px(B, F, PIXELS, PIXELS, 3),
                source=px(B, F, PIXELS, PIXELS, 3), frame_known=known)


def _port_raw(raw: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "input_ids"
            else torch.from_numpy(v) for k, v in raw.items()}


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _encoded(jm, params, raw, stage: int):
    """The JAX `encode_batch` of a stage (numpy fields), and for stage 2
    the posterior noise its key drew."""
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    if stage == 1:
        batch = jax.jit(lambda r: jstage1.encode_batch(
            jm["text_s1"], params["text_s1"], jm["vision"], params["vision"],
            r))(jraw)
        return jax.tree.map(np.asarray, batch), None
    key = jax.random.PRNGKey(3)
    batch = jax.jit(lambda r, k: jstage2.encode_batch(
        jm["vae"], params["vae"], jm["text_s2"], params["text_s2"],
        jm["vision"], params["vision"], r, k))(jraw, key)
    shape = (B * F,) + batch.latents.shape[2:]
    noise = [np.asarray(jax.random.normal(k, shape))
             for k in jax.random.split(key)]
    return jax.tree.map(np.asarray, batch), noise


@pytest.fixture(scope="module")
def encoded(tiny):
    """Each stage's JAX `encode_batch` of one raw batch (and stage 2's
    posterior noise), on the live weights."""
    jm, params = tiny
    raw = _raw(0)
    return {s: _encoded(jm, params["live"], raw, s) for s in (1, 2)}


@pytest.fixture(scope="module")
def batches(encoded):
    return {s: batch for s, (batch, _) in encoded.items()}


@pytest.mark.parametrize("stage", [1, 2])
def test_encode_batch_matches_jax(tiny, encoded, stage):
    _, params = tiny
    port, raw = _port(params["live"]), _raw(0)
    want, noise = encoded[stage]
    praw = _port_raw(raw)
    if stage == 1:
        got = stage1.encode_batch(port.text_s1, port.vision, praw)
    else:
        got = stage2.encode_batch(port.vae, port.text_s2, port.vision, praw,
                                  noise=tuple(map(_t, noise)))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), w), name
        else:
            _close(g, w, 1e-4, name)


# ---- the trainers ----------------------------------------------------------


def _trainers(jm, params, dtype=jnp.float32):
    """Per stage: (the JAX trainer, its trainable params, the port's
    trainer module on the same weights, the JAX tree -> port state dict)."""
    port = _port(params)
    prior, unet, fusion = jm["prior"], jm["unet"], jm["fusion"]
    j1 = jstage1.Stage1Trainer(JPrior(prior.cfg, dtype=dtype))
    j2 = jstage2.Stage2Trainer(JUNet(unet.cfg, dtype=dtype),
                               JFusion(fusion.cfg, dtype=dtype))
    p2 = {"params": {"unet": params["unet"]["params"],
                     "fusion": params["fusion"]["params"]}}
    return {
        1: (j1, params["prior"], stage1.Stage1Trainer(port.prior),
            functools.partial(bridge.stage1_state_dict, cfg=prior.cfg)),
        2: (j2, p2, stage2.Stage2Trainer(port.unet, port.fusion),
            functools.partial(bridge.stage2_state_dict, cfg=unet.cfg)),
    }


def _noise(trainer, batch, key) -> loop.TrainNoise:
    """The JAX trainer's draws from `key` (`loss_fn`'s three splits)."""
    k_noise, k_offset, k_t = jax.random.split(key, 3)
    if isinstance(trainer, jstage1.Stage1Trainer):
        x = batch.target_embed
        offset, t = x.shape[:2] + (1,), x.shape[:2]
    else:
        x = batch.latents
        offset, t = x.shape[:2] + (1, 1, x.shape[-1]), x.shape[:1]
    return loop.TrainNoise(
        _t(jax.random.normal(k_noise, x.shape)),
        _t(jax.random.normal(k_offset, offset)),
        _t(jax.random.randint(k_t, t, 0, 1000)).long())


def _port_batch(batch, dtype=torch.float32):
    return type(batch)(*(torch.from_numpy(np.array(x)) if x.dtype == bool
                         else torch.from_numpy(np.array(x)).to(dtype)
                         for x in batch))


@functools.lru_cache(maxsize=None)
def _value_and_grad(trainer):
    return jax.jit(jax.value_and_grad(trainer.loss_fn))


def _zero_set(grads: dict) -> set:
    return {n for n, g in grads.items() if not np.any(_np(g))}


# gradients zero but for float noise: a key projection's bias shifts every
# score of a query alike, and the softmax does not see it
ANALYTIC_ZERO = ".to_k.bias"


@pytest.mark.parametrize("weights", ["zero_temporal", "live"])
@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_loss_and_gradients_match_jax(tiny, batches, stage,
                                              weights):
    """With zero temporal output projections every gradient inside a
    temporal module is exactly zero on both sides. The key projections'
    biases have analytically zero gradients: both sides hold them below
    1e-6 of the largest gradient instead."""
    jm, params = tiny
    jtrainer, jparams, trainer, to_sd = _trainers(jm, params[weights])[stage]
    batch, key = batches[stage], jax.random.PRNGKey(11)
    loss, jgrads = _value_and_grad(jtrainer)(jparams, batch, key)
    state = TrainState.create(trainer, make_optimizer(OptimizerConfig()))
    got_loss, grads = loop.compute_gradients(
        state, _port_batch(batch), _noise(jtrainer, batch, key))
    _close(got_loss, loss, 1e-5, "loss")
    want = to_sd(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for n, g in grads.items():
        if n.endswith(ANALYTIC_ZERO):
            assert max(g.abs().max().item(), np.abs(want[n]).max()) \
                <= 1e-6 * top, n
        else:
            _close(g, want[n], 1e-4, n)
    zeros = _zero_set(grads)
    assert zeros == _zero_set(want)
    if weights == "zero_temporal":
        assert any("temporal_transformer.transformer_blocks" in n
                   for n in zeros)


def test_optimizer_step_on_the_bridged_jax_state(tiny, batches):
    """Two JAX steps (warmup 3, clip 1.0), the state bridged into the
    port, then the third step's JAX gradients applied on both sides."""
    jm, params = tiny
    jtrainer, jparams, trainer, to_sd = _trainers(jm, params["live"])[2]
    kw = dict(learning_rate=LR, warmup_steps=3, grad_clip_norm=1.0)
    jstate = JTrainState.create(jparams, jmake_optimizer(
        JOptimizerConfig(**kw)))
    vag, apply = _value_and_grad(jtrainer), jax.jit(
        lambda s, g: s.apply_gradients(g))
    batch = batches[2]
    for i in range(2):
        _, g = vag(jstate.params, batch, jax.random.PRNGKey(i))
        jstate = apply(jstate, g)
    _, g = vag(jstate.params, batch, jax.random.PRNGKey(2))
    state = TrainState.create(trainer, make_optimizer(OptimizerConfig(**kw)))
    state.load_state_dicts(bridge.train_state_dicts(
        jax.device_get(jstate), to_sd))
    norm = state.apply_gradients({n: _t(v) for n, v in to_sd(
        jax.tree.map(np.asarray, g)).items()})
    jstate = jax.device_get(apply(jstate, g))
    want = bridge.train_state_dicts(jstate, to_sd)
    assert (state.step, state.opt_state.count) == (3, 3) == (
        want["step"], want["count"])
    assert float(norm) > 1.0  # the step clipped
    # each parameter within 1e-6 relative, or a millionth of a step where
    # the step takes it near zero; a moment, where the new gradient
    # cancels most of it, within 1e-6 of its tensor's largest value
    for n, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want["params"][n],
                                   rtol=1e-6, atol=1e-6 * LR, err_msg=n)
    for key in ("mu", "nu"):
        for n, t in getattr(state.opt_state, key).items():
            _close(t, want[key][n], 1e-6, f"{key} {n}")


def test_remat_gradients_equal_and_recompute(tiny, batches):
    """cfg.remat checkpoints each down/up sub-block: the same loss and
    gradients, and those sub-blocks' resnets run again in the backward
    pass (the mid block's do not)."""
    jm, params = tiny
    _, _, trainer, _ = _trainers(jm, params["live"])[2]
    key = jax.random.PRNGKey(11)
    batch, noise = batches[2], None
    results = []
    for remat in (False, True):
        t = copy.deepcopy(trainer)
        for level in list(t.unet.down_blocks) + list(t.unet.up_blocks):
            level.remat = remat
        calls = []
        for m in t.unet.modules():
            if isinstance(m, ResnetBlock):
                m.register_forward_hook(lambda *a: calls.append(1))
        noise = noise or _noise(jstage2.Stage2Trainer(None, None), batch, key)
        state = TrainState.create(t, make_optimizer(OptimizerConfig()))
        loss, grads = loop.compute_gradients(state, _port_batch(batch),
                                             noise)
        results.append((loss, grads, len(calls)))
    (loss0, g0, n0), (loss1, g1, n1) = results
    sub_blocks = sum(len(lv.resnets) for lv in list(trainer.unet.down_blocks)
                     + list(trainer.unet.up_blocks))
    assert n1 == n0 + sub_blocks
    assert torch.equal(loss0, loss1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=0)


@pytest.mark.parametrize("stage", [1, 2])
def test_loss_decreases_over_five_steps(tiny, batches, stage):
    """As tests/test_training.py: one batch, one noise, lr 1e-3."""
    jm, params = tiny
    jtrainer, _, trainer, _ = _trainers(jm, params["live"])[stage]
    batch = batches[stage]
    noise = _noise(jtrainer, batch, jax.random.PRNGKey(42))
    state = TrainState.create(trainer, make_optimizer(OptimizerConfig(
        learning_rate=LR, warmup_steps=0, grad_clip_norm=10.0)))
    losses = [loop.train_step(state, _port_batch(batch), noise,
                              return_float=True) for _ in range(5)]
    assert losses[-1] < losses[0], losses
    assert state.step == 5 and state.opt_state.count == 5
