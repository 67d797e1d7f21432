"""The port's measuring entry points (rcdms_tpu_torch/bench.py,
rcdms_tpu_torch/tools/profile_bench.py and tools/bench_feeder.py) against
the JAX package's root bench.py, on the CPU:

(a) for the tiny and the full settings, by default and with each of the
    diagnostic and sampling flags, the port's stage-2 builder gives the
    JAX `bench.build`'s configs field for field (`port_config`), its
    conditioning's shapes and dtypes, its sampler's fields (with
    `bench.main`'s replace for --steps, --batched-cfg and
    --encoder-propagation) and its UNet + fusion parameter count (the JAX
    tree from `jax.eval_shape` of the whole `build`, so nothing is
    allocated; the port's full-width build on the meta device);
(b) the tiny stage-2 sampler the bench builds, on parameters bridged from
    the JAX modules' trees (shapes of their `init`, seeded numpy values)
    through io/bridge.py and on the same initial latents, against the JAX
    `StorySampler`, both in fp32 at tests/test_torch_pipeline.py's
    SAMPLER_TOL (5e-4: an fp32 tolerance; the bf16 rounding of the same
    modules is held by tests/test_torch_bf16.py);
(c) one tiny `--train-step` step (bf16 compute) against the JAX
    `Stage2Trainer.train_step` on the JAX bench's optimizer, over fp32
    masters and over bf16 parameters (and so bf16 moments), at the
    bench's lr and at 1e-2, the noise injected as
    tests/test_torch_training.py injects it and the JAX layers on their
    Pallas kernels in interpret mode, as tests/test_torch_training_bf16.py
    runs them: the loss, the gradients (also against an fp32 trainer's),
    Adam's moments and the parameters' move, at the tolerances of the
    test's docstring, each failed by a zero or sign-flipped gradient or
    a state left unchanged;
(d) the `--attn` routing of A against the JAX gates it ports
    (`rcdms_tpu/ops/attention.py::dot_product_attention` under each impl
    on a TPU backend) at a grid of (dtype, dh, queries, masked), and of
    B, C/D against `core/attention.py::_use_frame_kernel` and
    `core/layers.py::_fused_ff_route`; the setting is read at the routing
    layer, never by a kernel wrapper: "plain" calls the plain functions,
    "kernel" raises on CPU tensors, and the wrappers keep their dispatch
    by device;
(e) `python -m rcdms_tpu_torch.bench --tiny --device cpu` in each mode
    prints one JSON line with exactly the JAX mode's keys (read from
    bench.py with `ast`) less the three TPU-figure keys, plus the added
    ones, every number finite and the card-only keys null;
(f) `--shard-story --tiny --device cpu` on two gloo ranks prints from
    rank 0 alone, world_size 2 on one device;
and the profile tool's three paths and the feeder benchmark at
`--batches 1`.
"""

import ast
import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench  # the root bench.py: the JAX package's
from rcdms_tpu.configs import FusionConfig as JFusionConfig
from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.configs import StoryUNetConfig as JUNetConfig
from rcdms_tpu.core import attention as jcore_attention
from rcdms_tpu.core import layers as jlayers
from rcdms_tpu.models.fusion import FusionModule as JFusion
from rcdms_tpu.models.unet3d import StoryUNet as JUNet
from rcdms_tpu.ops import attention as jattention
from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.sample import story_sampler as jss
from rcdms_tpu.train import stage2 as jstage2
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch import bench, ops
from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.core.attention import Attention
from rcdms_tpu_torch.core.layers import FeedForward
from rcdms_tpu_torch.ops.attention import (
    dot_product_attention,
    multihead_attention,
    uses_kernel,
)
from rcdms_tpu_torch.ops.flash import _split_heads, flash_attention
from rcdms_tpu_torch.ops.frame_attention import (
    frame_attention,
    frame_attention_plain,
)
from rcdms_tpu_torch.ops.geglu import (
    geglu_ff,
    geglu_ff_plain,
    gelu_ff,
    gelu_ff_plain,
)
from rcdms_tpu_torch.ops.impl import routes_to_wrapper
from rcdms_tpu_torch.tools import bench_feeder, profile_bench
from rcdms_tpu_torch.train import loop
from rcdms_tpu_torch.train.optim import make_optimizer
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_training import _draw, _noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
LR = 1e-5  # the bench's optimizer (bench.py:383)
FLAGS = {"default": [], "no_temporal": ["--no-temporal"],
         "temporal_attn_layers1": ["--temporal-attn-layers", "1"],
         "frames1": ["--frames", "1"], "image_size256": ["--image-size",
                                                         "256"],
         "batch2": ["--batch", "2"], "steps5": ["--steps", "5"],
         "batched_cfg": ["--batched-cfg"],
         "encoder_propagation2": ["--encoder-propagation", "2"]}
# keys of the port's line beyond the JAX mode's: every mode's, then each
# mode's own (`attn`, and the train step's `params_dtype`, where the JAX
# line lacks them; `world_size` beside `n_chips`)
ADDED = ("device_name", "power_limit_w", "gb_in_use", "peak_gb_in_use",
         "gb_limit")
MODES = {"stage2": ([], "main", ("world_size",)),
         "full_pipeline": (["--full-pipeline"], "main_full_pipeline",
                           ("attn",)),
         "train_step": (["--train-step"], "main_train_step",
                        ("attn", "params_dtype"))}
CARD_KEYS = ("power_limit_w", "gb_in_use", "peak_gb_in_use", "gb_limit")
# a TPU target and a TPU model: not the port's
DROPPED = ("vs_baseline", "vs_baseline_denominator",
           "modeled_v5e8_full_story_p50_s")


@pytest.fixture(autouse=True)
def default_settings():
    """Every test starts and ends with the default routing and no int8."""
    ops.set_attention_impl("auto")
    quant.set_quant_mode(None)
    yield
    ops.set_attention_impl("auto")
    quant.set_quant_mode(None)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---- (a) the stage-2 build against the JAX bench's -------------------------


@functools.lru_cache(maxsize=None)
def _jax_build(tiny, use_temporal, layers, batch, image_size, frames,
               guidance):
    """The JAX `bench.build` traced by `jax.eval_shape`: (its sampler, its
    frames, the conditioning's ShapeDtypeStructs, the UNet + fusion
    parameter count)."""
    out = {}

    def build():
        sampler, unet_p, fusion_p, cond, f, steps = jbench.build(
            tiny, "bfloat16", use_temporal=use_temporal,
            temporal_attn_layers=layers, batch=batch, image_size=image_size,
            frames=frames, guidance=guidance)
        out.update(sampler=sampler, frames=f)
        return unet_p, fusion_p, cond

    unet_p, fusion_p, cond = jax.eval_shape(build)
    count = sum(math.prod(x.shape)
                for x in jax.tree_util.tree_leaves((unet_p, fusion_p)))
    return out["sampler"], out["frames"], cond, count


def _jax_stage2(args):
    """The JAX bench's stage-2 sampler for the flags, `bench.main`'s way."""
    sampler, frames, cond, count = _jax_build(
        args.tiny, not args.no_temporal, args.temporal_attn_layers,
        args.batch, args.image_size, args.frames, args.guidance_scale)
    if args.steps or args.encoder_propagation or args.batched_cfg:
        sampler = dataclasses.replace(
            sampler, num_steps=args.steps or sampler.num_steps,
            encoder_propagation=args.encoder_propagation,
            sequential_cfg=not args.batched_cfg)
    return sampler, frames * args.batch, cond, count


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_stage2_build_matches_the_jax_bench(size, flags):
    tiny = size == "tiny"
    args = bench.parse_args((["--tiny"] if tiny else []) + flags)
    want, frames, cond, count = _jax_stage2(args)
    rig = bench.build_stage2(args, torch.device("cpu" if tiny else "meta"))
    got = rig.sampler
    assert got.unet.cfg == rig.spec.unet == port_config(want.unet.cfg)
    assert rig.spec.fusion == port_config(want.fusion.cfg)
    for name in ("num_steps", "guidance_scale", "eta", "sequential_cfg",
                 "encoder_propagation"):
        assert getattr(got, name) == getattr(want, name), name
    assert rig.frames == frames
    assert rig.cond._fields == cond._fields
    for name, g, w in zip(cond._fields, rig.cond, cond):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype)[6:] == str(w.dtype), name
    assert sum(p.numel() for m in (got.unet, got.fusion)
               for p in m.parameters()) == count


# ---- (b) the tiny sampler against the JAX StorySampler ----------------------


def _jax_params(module, *args, seed: int):
    """Seeded numpy values in `module`'s parameter tree (shapes from
    `jax.eval_shape` of its `init`)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(functools.partial(_draw, rng),
                                            shapes)


def test_stage2_sampler_matches_jax():
    """The bench's bf16 build widened to fp32 (its conditioning holds
    bf16 values) before the bridged weights load."""
    args = bench.parse_args(["--tiny"])
    rig = bench.build_stage2(args, torch.device("cpu"))
    rig.sampler.unet.float()
    rig.sampler.fusion.float()
    rig = rig._replace(cond=type(rig.cond)(*(
        t if t.dtype == torch.bool else t.float() for t in rig.cond)))
    sampler, _, _, _ = _jax_stage2(args)
    f32 = jnp.float32
    unet, fusion = sampler.unet.clone(dtype=f32), sampler.fusion.clone(
        dtype=f32)
    jsampler = dataclasses.replace(sampler, unet=unet, fusion=fusion)
    cond = jss.StoryConditioning(*(jnp.asarray(t.numpy()) for t in rig.cond))
    b, f, t = cond.text_hidden.shape[:3]
    uparams = _jax_params(
        unet, jnp.zeros(cond.masked_latents.shape[:-1] + (9,)),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b, f, t, unet.cfg.cross_attention_dim)), seed=3)
    fparams = _jax_params(fusion, cond.image_tokens, cond.image_proj,
                          cond.text_hidden, cond.frame_known, seed=4)
    bridge.load_state_dict(rig.sampler.unet,
                           bridge.unet_state_dict(uparams, unet.cfg))
    bridge.load_state_dict(rig.sampler.fusion,
                           bridge.fusion_state_dict(fparams))
    init = np.random.default_rng(5).standard_normal(
        cond.masked_latents.shape).astype(np.float32)
    want = jsampler(uparams, fparams, cond, jax.random.PRNGKey(42),
                    jnp.asarray(init))
    got = rig.sampler(rig.cond, torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLER_TOL)


# ---- (c) one train step against the JAX trainer's ---------------------------


@pytest.fixture
def jax_kernels():
    """The JAX layers on their Pallas kernels in interpret mode."""
    jflash.set_kernel_interpret(True)
    jattention.set_default_attention_impl("pallas")
    try:
        yield
    finally:
        jattention.set_default_attention_impl("auto")
        jflash.set_kernel_interpret(False)


# (masters' dtype, lr) by test id: the bench's lr, then one at which a bf16
# parameter's move is many of its ulps
STEP_CASES = {"float32": ("float32", LR), "bfloat16": ("bfloat16", LR),
              "float32-lr0.01": ("float32", 1e-2),
              "bfloat16-lr0.01": ("bfloat16", 1e-2)}
STEP_KEY = 7
# of the reference's L2 norm, all tensors as one vector (the step test's
# docstring says why)
GRAD_TOL = 5e-2    # the gradients and mu
GRAD_NOISE = 1.25  # the port's distance from the fp32 gradients, to JAX's
NU_TOL = 1e-1      # nu = g^2: twice g's relative error
MOVE_TOL = 0.3     # the step's move


def _rel_l2(got: dict, want: dict) -> float:
    """|got - want| / |want| over every tensor as one vector (numpy, any
    float dtype)."""
    diff = norm = 0.0
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        diff += float(np.sum((np.asarray(got[n], np.float64) - w) ** 2))
        norm += float(np.sum(w ** 2))
    return math.sqrt(diff / norm)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 bits of precision to fp32's
    24)."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0 ** 16


@functools.lru_cache(maxsize=None)
def _jax_step_side(params_dtype: str):
    """The JAX side of the step tests, once a dtype: the bf16 trainer, the
    bench's batch, seeded parameters cast as the JAX bench casts them
    (every fp32 leaf to `params_dtype`), and at `STEP_KEY` its loss and
    gradients, and the gradients of an fp32 trainer at the same
    parameter values (by the port's names)."""
    args = bench.parse_args(["--tiny", "--train-step"])
    port_batch = bench.build_train(args, torch.device("cpu")).batch
    ucfg = JUNetConfig.tiny()
    fcfg = JFusionConfig.tiny(hidden_dim=ucfg.cross_attention_dim,
                              text_dim=ucfg.cross_attention_dim)

    def trainer(dtype):
        return jstage2.Stage2Trainer(JUNet(ucfg, dtype=dtype),
                                     JFusion(fcfg, dtype=dtype))

    bf16 = jnp.bfloat16
    batch = jstage2.Stage2Batch(*(
        jnp.asarray(x.numpy()) if x.dtype != torch.bfloat16
        else jnp.asarray(_np(x), bf16) for x in port_batch))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng), jax.eval_shape(
            trainer(bf16).init_params, jax.random.PRNGKey(0), batch))
    pdt = jnp.dtype(params_dtype)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, pdt), params)
    key = jax.random.PRNGKey(STEP_KEY)
    loss, grads = jax.jit(jax.value_and_grad(trainer(bf16).loss_fn))(
        params, batch, key)
    f32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                 (params, batch))
    _, grads32 = jax.jit(jax.value_and_grad(
        trainer(jnp.float32).loss_fn))(*f32, key)
    to_sd = functools.partial(bridge.stage2_state_dict, cfg=ucfg)
    return dict(trainer=trainer(bf16), batch=batch, params=params,
                loss=float(loss), grads=grads, to_sd=to_sd,
                grads32=to_sd(jax.device_get(grads32)))


@pytest.mark.parametrize("params_dtype,lr", list(STEP_CASES.values()),
                         ids=list(STEP_CASES))
def test_train_step_matches_jax(params_dtype, lr, jax_kernels):
    """The port's rig gets the JAX state's masters and moments
    (`bridge.train_state_dicts`); then each side takes one step on the
    same batch and noise, as the two halves of its `train_step`: the loss
    and the gradients, then the optimizer's update (both the bench's
    AdamW but for `lr`). The JAX side is `_jax_step_side`'s.

    Held: the loss (2e-2 relative over fp32 masters, the existing test's;
    1e-2 with bf16 parameters). The gradients, all tensors as one vector,
    within GRAD_TOL of the JAX ones' L2 norm, and no farther from the fp32
    trainer's than the JAX bf16 ones are, times GRAD_NOISE: at these
    weights each side's bf16 gradients lie 2.2-2.8% from the fp32 ones
    and 3.2% from each other (tests/test_torch_training_bf16.py's 2e-2
    holds at its own weights), where a zero or sign-flipped gradient lies
    at 100% or 200%. Adam's moments after the step: mu at GRAD_TOL, nu at
    NU_TOL (3.2-3.4% and 2.2-3.2% measured). The step's move of the
    parameters at MOVE_TOL of its norm (0.22 measured: Adam's first move
    is lr * sign(g), and the elements whose gradient is float noise,
    about 1%, move 2 lr apart), which a state left unchanged fails
    (checked); not with bf16 parameters at the bench's lr, whose moves
    are mostly rounding (0.56 there; the lr-0.01 case holds them). And
    each parameter within 2.01 lr of the JAX one (that sign of float
    noise, and fp32 rounding); with bf16 parameters that times
    1 + 2^-7 (each side's move is lr times Adam's ratio mu / sqrt(nu),
    a bf16 value there, within a bf16 ulp of 1 of +-1), plus one bf16
    ulp of the larger of the two (each side rounds the new value).
    """
    side = _jax_step_side(params_dtype)
    to_sd = side["to_sd"]
    args = bench.parse_args(["--tiny", "--train-step", "--params-dtype",
                             params_dtype])
    rig = bench.build_train(args, torch.device("cpu"))
    state = rig.state
    opt = dict(learning_rate=lr, warmup_steps=0, grad_clip_norm=1.0)
    state.optimizer = make_optimizer(OptimizerConfig(**opt))
    jstate = JTrainState.create(side["params"], jmake_optimizer(
        JOptimizerConfig(**opt)))
    state.load_state_dicts(bridge.train_state_dicts(jax.device_get(jstate),
                                                    to_sd))
    for n, p in state.params.items():
        assert p.dtype == (torch.float32 if params_dtype == "float32"
                           else state.module.get_parameter(n).dtype), n
        assert state.opt_state.mu[n].dtype == p.dtype, n
    if params_dtype == "bfloat16":
        assert all(p is state.module.get_parameter(n)
                   for n, p in state.params.items())
    old = {n: _np(p).copy() for n, p in state.params.items()}

    got, grads = loop.compute_gradients(state, rig.batch, _noise(
        side["trainer"], side["batch"], jax.random.PRNGKey(STEP_KEY)))
    tol = 2e-2 if params_dtype == "float32" else 1e-2
    assert abs(got.item() - side["loss"]) <= tol * abs(side["loss"])
    assert all(g.dtype == state.params[n].dtype for n, g in grads.items())
    port = {n: _np(g) for n, g in grads.items()}
    want = to_sd(jax.device_get(side["grads"]))
    errs = dict(grads=_rel_l2(port, want),
                port_fp32=_rel_l2(port, side["grads32"]),
                jax_fp32=_rel_l2(want, side["grads32"]))

    new = jax.device_get(jax.jit(lambda s, g: s.apply_gradients(g))(
        jstate, side["grads"]))
    state.apply_gradients(grads)
    want = bridge.train_state_dicts(new, to_sd)
    assert state.step == 1 and state.opt_state.count == 1 == want["count"]
    for name in ("mu", "nu"):
        errs[name] = _rel_l2({n: _np(m) for n, m in getattr(
            state.opt_state, name).items()}, want[name])
    moved = {n: want["params"][n] - old[n] for n in old}
    errs["move"] = _rel_l2({n: _np(p) - old[n]
                            for n, p in state.params.items()}, moved)
    assert errs["grads"] <= GRAD_TOL, errs
    assert errs["port_fp32"] <= GRAD_NOISE * errs["jax_fp32"], errs
    assert errs["mu"] <= GRAD_TOL and errs["nu"] <= NU_TOL, errs
    if params_dtype == "float32" or lr > LR:
        assert errs["move"] <= MOVE_TOL, errs
    assert _rel_l2({n: 0 * m for n, m in moved.items()}, moved) > MOVE_TOL
    for n, p in state.params.items():
        p, w = _np(p), np.asarray(want["params"][n], np.float32)
        atol = 2.01 * lr
        if params_dtype == "bfloat16":  # a bf16 ratio, a bf16 rounding
            atol = atol * (1 + 2.0 ** -7) + _bf16_ulp(
                np.maximum(np.abs(p), np.abs(w)))
        assert np.all(np.abs(p - w) <= atol), n


# ---- (d) the --attn routing against the JAX gates ---------------------------


GRID = [(dtype, dh, queries, masked)
        for dtype in (torch.float32, torch.bfloat16)
        for dh in (8, 12, 40, 64, 160, 256, 264)
        for queries in (64, 255, 256, 512) for masked in (False, True)]
JAX_IMPL = {"auto": "auto", "plain": "xla", "kernel": "pallas"}


def _jax_routes_to_kernel(impl: str, dh: int, queries: int, masked: bool,
                          monkeypatch) -> bool:
    """Whether the JAX `dot_product_attention` under `impl`, on a TPU
    backend, calls its flash kernel."""
    called = []

    def kernel(q, *args, **kwargs):
        called.append(1)
        return q

    monkeypatch.setattr(jflash, "flash_attention", kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q = jnp.zeros((1, 1, queries, dh))
    mask = jnp.zeros((1, 1, queries, queries)) if masked else None
    jattention.dot_product_attention(q, q, q, mask, impl=impl)
    return bool(called)


@pytest.mark.parametrize("impl", ["auto", "plain", "kernel"])
def test_attention_routing_matches_the_jax_gates(impl, monkeypatch):
    """A takes dh <= 256 and, in bf16, dh a multiple of 8 (the wgmma
    kernel's tiles); within that, the port routes as JAX's gate does."""
    ops.set_attention_impl(impl)
    for dtype, dh, queries, masked in GRID:
        takes = dh <= 256 and (dtype != torch.bfloat16 or dh % 8 == 0)
        want = takes and _jax_routes_to_kernel(JAX_IMPL[impl], dh, queries,
                                               masked, monkeypatch)
        assert uses_kernel(dtype, dh, queries, masked) == want, (
            dtype, dh, queries, masked)


@pytest.mark.parametrize("impl", ["auto", "plain", "kernel"])
def test_story_op_routing_matches_the_jax_gates(impl, monkeypatch):
    """B and C/D: their callers' gate (`routes_to_wrapper`) and the
    wrappers' own dispatch by device launch a kernel on a card as the JAX
    frame-attention and fused FF gates route on a TPU; on the CPU as on a
    CPU backend, except that "kernel" raises where the JAX package runs
    Pallas's interpreter."""
    ops.set_attention_impl(impl)
    jattention.set_default_attention_impl(JAX_IMPL[impl])
    try:
        for backend, device in (("tpu", "cuda"), ("cpu", "cpu")):
            monkeypatch.setattr(jax, "default_backend", lambda: backend)
            frame = jcore_attention._use_frame_kernel()
            ff = jlayers._fused_ff_route((1, 256, 320), 320, 1280) \
                is not None
            assert frame == ff
            for name in ("frame_attention", "geglu_ff", "gelu_ff"):
                if impl == "kernel" and device == "cpu":
                    with pytest.raises(RuntimeError, match="kernel"):
                        routes_to_wrapper(name, torch.device(device))
                else:
                    launches = device == "cuda" and routes_to_wrapper(
                        name, torch.device(device))
                    assert launches == frame
    finally:
        jattention.set_default_attention_impl("auto")


def _dot_product(q, k, v, heads):
    """A's router's plain path (`dot_product_attention`), token-major."""
    o = dot_product_attention(*(_split_heads(t, heads) for t in (q, k, v)))
    return o.transpose(-3, -2).reshape(q.shape)


def _story_sites():
    """The story ops' sites through the routing layer on CPU tensors, by
    name: (the routed call, the plain function the "plain" route calls,
    the kernel wrapper the "auto" route calls)."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q, fx, x = r(1, 256, 64), r(1, 5, 16, 32), r(1, 16, 32)
    frame = Attention(32, 2, 16, frame_axis=True)
    fqkv = [lin(fx) for lin in (frame.to_q, frame.to_k, frame.to_v)]
    sites = {
        "A, 256 queries": (
            lambda: multihead_attention(q, q, q, 2, row_sum="rounded"),
            lambda: _dot_product(q, q, q, 2),
            lambda: flash_attention(q, q, q, 2, row_sum="rounded")),
        "B": (lambda: frame(fx),
              lambda: frame.to_out[0](frame_attention_plain(
                  *fqkv, 2, 16 ** -0.5)),
              lambda: frame.to_out[0](frame_attention(*fqkv, 2)))}
    for act, plain, wrapper in (("geglu", geglu_ff_plain, geglu_ff),
                                ("gelu", gelu_ff_plain, gelu_ff)):
        ff = FeedForward(32, act)
        w = (ff.net[0].proj.weight, ff.net[0].proj.bias, ff.net[2].weight,
             ff.net[2].bias)
        sites[act] = (functools.partial(ff, x),
                      functools.partial(plain, x, *w),
                      functools.partial(wrapper, x, *w))
    return sites


def test_kernel_impl_raises_on_cpu_tensors():
    """At the routing layer, also for A below its 256-query floor; the
    wrappers themselves keep their dispatch by device."""
    ops.set_attention_impl("kernel")
    q = torch.ones(1, 64, 16)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="kernel"):
            multihead_attention(q, q, q, 2, row_sum="fp32")
        for call, _, wrapper in _story_sites().values():
            with pytest.raises(RuntimeError, match="kernel"):
                call()
            wrapper()  # its plain version: CPU operands


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_plain_and_auto_run_the_plain_versions_on_the_cpu(impl):
    """Each site equals, bit for bit, the plain function the "plain"
    route calls, or under "auto" the wrapper (its plain version on the
    CPU); nothing launches."""
    ops.reset_launch_counts()
    with torch.no_grad():
        for name, (call, plain, wrapper) in _story_sites().items():
            ops.set_attention_impl("auto")
            want = (plain if impl == "plain" else wrapper)()
            ops.set_attention_impl(impl)
            torch.testing.assert_close(call(), want, rtol=0, atol=0,
                                       msg=name)
    assert not any(ops.launch_counts().values())


# ---- (e) the CLI's JSON lines ----------------------------------------------


def _jax_keys(function: str) -> set:
    """The string keys of the largest dict literal in the root bench.py's
    `function`: the keys its JSON line prints."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)]
    biggest = max(dicts, key=lambda d: len(d.keys))
    return {k.value for k in biggest.keys if isinstance(k, ast.Constant)}


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_prints_the_jax_keys(mode):
    flags, function, own = MODES[mode]
    proc = subprocess.run(
        [sys.executable, "-m", "rcdms_tpu_torch.bench", "--tiny",
         "--device", "cpu", "--repeats", "2"] + flags, cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    want = (_jax_keys(function) - set(DROPPED)) | set(ADDED) | set(own)
    assert set(line) == want, set(line) ^ want
    assert line["backend"] == "cpu" and line["tiny"] is True
    for k, v in line.items():
        if k in CARD_KEYS:
            assert v is None, k
        elif isinstance(v, float):
            assert math.isfinite(v), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_shard_story_prints_from_rank_0_alone():
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rcdms_tpu_torch.bench", "--shard-story",
         "--tiny", "--device", "cpu", "--repeats", "1"], cwd=REPO,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert outs[1][0].strip() == ""
    lines = outs[0][0].strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert (line["world_size"], line["n_chips"]) == (2, 1)
    assert line["metric"] == "stage2_frames_per_sec_per_chip"
    assert math.isclose(line["value"], 5 / line["p50_story_latency_s"],
                        rel_tol=1e-3)


# ---- the flags a mode does not take, and the settings run() restores --------


@pytest.mark.parametrize("flags", [
    ["--params-dtype", "float32"],
    ["--shard-story", "--full-pipeline"],
    ["--shard-story", "--train-step"],
])
def test_flags_a_mode_does_not_take_raise(flags):
    with pytest.raises(ValueError):
        bench.run(["--tiny", "--device", "cpu"] + flags)


def test_run_restores_the_routing_and_the_quant_mode():
    line = bench.run(["--tiny", "--device", "cpu", "--repeats", "1",
                      "--steps", "1", "--attn", "plain", "--int8"])
    assert (line["attn"], line["int8"]) == ("plain", True)
    assert ops.attention_impl() == "auto"
    assert quant.get_quant_mode() is None


def test_run_counts_each_timed_calls_launches():
    launches = []
    bench.run(["--tiny", "--device", "cpu", "--repeats", "3", "--steps",
               "1"], launches)
    assert len(launches) == 3
    assert all(set(c) == set(ops.PATHS["story"]) | {"frame_attention_tiled"}
               and not any(c.values()) for c in launches)


# ---- the profile tool and the feeder benchmark ------------------------------


@pytest.mark.parametrize("path", [[], ["--full-pipeline"], ["--prior"]],
                         ids=["stage2", "full_pipeline", "prior"])
def test_profile_bench_on_the_cpu(path, capsys):
    result = profile_bench.run(["--tiny", "--device", "cpu", "--steps",
                                "2", "--top", "5"] + path)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    assert result["device"] == "cpu" and len(result["top"]) == 5
    assert set(result["groups"]) == {"A", "B", "C/D", "cuDNN", "other"}
    assert result["device_s"] > 0 and result["wall_s"] > 0
    assert math.isclose(sum(g["s"] for g in result["groups"].values()),
                        result["device_s"])
    assert ops.attention_impl() == "auto"


def test_bench_feeder_one_batch():
    result = bench_feeder.run(["--batches", "1", "--batch-size", "2",
                               "--threads", "2"])
    assert result["stories"] == 2
    assert result["python_stories_per_s"] > 0
    assert result["native_stories_per_s"] > 0  # g++ builds it here
