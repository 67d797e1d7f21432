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
* the time MLP in fp32 in a bf16 model, as the JAX package builds it (no
  dtype, so flax's fp32): the UNet's and the prior's against the flax
  `TimestepEmbedding` on the same parameters and the same bf16-rounded
  sinusoid, within 1e-5 relative (the two differ in summation order only);
* the prior's residual stream in fp32 in a bf16 model, as jnp promotes the
  fp32 time embedding through the concatenation and every residual add:
  forward hooks see its blocks take fp32 and the UNet's take bf16; and a
  tiny bf16 prior call against the flax prior in bf16 (the FF in interpret
  mode). Tolerance: max|port - ref| <= 2e-2 max|ref| and mean|port - ref|
  <= 5e-3 max|ref|. The output is rounded to bf16 by the last projection,
  one ulp of which is 3.9e-3 of its magnitude, and the JAX package's own
  bf16 output lies up to 9.6e-3 max|ref| from its fp32 output here. At this
  size the port before the fp32 stream was as close (1.15e-2 max, 3.2e-3
  mean), so the hook test is what holds the stream;
* `build_pipeline(..., dtype=torch.bfloat16)` keeps every norm parameter
  and the time MLP in fp32, as the JAX modules hold them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import PriorConfig, StoryUNetConfig
from rcdms_tpu.core import layers as jlayers
from rcdms_tpu.io import convert
from rcdms_tpu.models import prior as jprior
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops.frame_attention import frame_attention_bfnc as jflash_frame
from rcdms_tpu.ops.attention import set_default_attention_impl
from rcdms_tpu.ops.geglu import geglu_ff as jgeglu_ff, gelu_ff as jgelu_ff
from rcdms_tpu_torch.core.attention import BasicTransformerBlock
from rcdms_tpu_torch.core.layers import (
    GroupNorm,
    LayerNorm,
    TimestepEmbedding,
    init_like_flax_,
    sinusoidal_time_embedding,
)
from rcdms_tpu_torch.core.temporal import TemporalModule
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.models import prior as tprior
from rcdms_tpu_torch.models import unet3d as tunet
from rcdms_tpu_torch.ops.flash import attention_plain
from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.ops.geglu import geglu_ff, gelu_ff
from rcdms_tpu_torch.sample.pipeline import build_pipeline, tiny_configs
from tests.test_torch_configs import port_config

NORMS = (GroupNorm, LayerNorm)
FP32_MODULES = NORMS + (TimestepEmbedding,)


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


def _temporal_live(cfg):
    return dataclasses.replace(cfg, temporal=dataclasses.replace(
        cfg.temporal, zero_init_output=False))


def test_bf16_story_unet_matches_jax(jax_kernels):
    cfg = _temporal_live(StoryUNetConfig.tiny())
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
    fp32 = {f"{n}.{k}" for n, m in pipe.named_modules()
            if isinstance(m, FP32_MODULES) for k, _ in m.named_parameters()}
    assert any(".time_embedding." in n for n in fp32)
    ref_params = dict(ref.named_parameters())
    for name, p in pipe.named_parameters():
        if name in fp32:
            assert p.dtype == torch.float32, name
            assert torch.equal(p, ref_params[name]), name
        else:
            assert p.dtype == torch.bfloat16, name


def test_norm_parameters_load_bit_for_bit_into_a_bf16_module():
    """bridge.load_state_dict keeps each parameter's dtype: flax's fp32
    norm and time-MLP parameters arrive unrounded in a bf16 model."""
    rng = np.random.default_rng(0)
    m = LayerNorm(8).to(torch.bfloat16)
    scale = (1.0 + rng.standard_normal(8) * 0.3).astype(np.float32)
    bridge.load_state_dict(m, {"weight": scale, "bias": scale[::-1].copy()})
    np.testing.assert_array_equal(m.weight.detach().numpy(), scale)
    np.testing.assert_array_equal(m.bias.detach().numpy(), scale[::-1])

    flax_mlp = {name: {"kernel": rng.standard_normal((8, 8)).astype(
        np.float32), "bias": rng.standard_normal(8).astype(np.float32)}
        for name in ("linear_1", "linear_2")}
    sd = {}
    bridge._time_embedding(sd, "time_embedding", flax_mlp)
    m = torch.nn.ModuleDict({"time_embedding": TimestepEmbedding(8, 8)})
    bridge.load_state_dict(m.to(torch.bfloat16), sd)
    for name, p in m.time_embedding.named_parameters():
        assert p.dtype == torch.float32, name
        np.testing.assert_array_equal(p.detach().numpy(),
                                      sd[f"time_embedding.{name}"])


def _time_mlp_ref(params, sinusoid):
    """The flax TimestepEmbedding on the JAX package's bf16-rounded
    sinusoid, fp32 out."""
    dim = params["linear_1"]["kernel"].shape[1]
    return np.asarray(jlayers.TimestepEmbedding(dim).apply(
        {"params": params}, jnp.asarray(sinusoid).astype(jnp.bfloat16)))


@pytest.mark.parametrize("tower", ["unet", "prior"])
def test_time_mlp_is_fp32_in_a_bf16_model(tower):
    if tower == "unet":
        cfg = StoryUNetConfig.tiny()
        m = tunet.StoryUNet(port_config(cfg))
        dim = cfg.block_channels[0]
    else:
        cfg = PriorConfig.tiny()
        m = tprior.FramePrior(port_config(cfg))
        dim = cfg.inner_dim
    _unet_params(m)
    m = m.to(torch.bfloat16)
    mlp = m.time_embedding
    assert all(p.dtype == torch.float32 for p in mlp.parameters())
    params = {n: {"kernel": l.weight.detach().numpy().T,
                  "bias": l.bias.detach().numpy()}
              for n, l in (("linear_1", mlp.linear_1),
                           ("linear_2", mlp.linear_2))}
    t = torch.tensor([1, 250, 999])
    sinusoid = sinusoidal_time_embedding(t, dim)
    with torch.no_grad():
        out = (m.time_embed(t, torch.bfloat16) if tower == "unet"
               else mlp(sinusoid.bfloat16()))
    assert out.dtype == torch.float32
    ref = _time_mlp_ref(params, sinusoid.numpy())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _prior_args(seed=0):
    b, f, d, t = 2, 5, 16, 7
    rng = np.random.default_rng(seed)

    def x(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    mask = np.ones((b, f, t), bool)
    mask[0, :, 4:] = False
    return (x(b, f, d), np.full((b, f), 700, np.int32), x(b, f, d),
            x(b, f, t, d), x(b, f, d), x(b, f, d), mask)


def _bf16(a):
    return (torch.from_numpy(a).bfloat16() if a.dtype == np.float32
            else torch.from_numpy(a))


def _block_input_dtypes(m, *args):
    """The input dtype of every BasicTransformerBlock and TemporalModule
    that `m` runs on `args`, in call order."""
    seen = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].dtype))
        for mod in m.modules()
        if isinstance(mod, (BasicTransformerBlock, TemporalModule))]
    try:
        with torch.no_grad():
            out = m(*args)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def test_bf16_residual_stream_dtypes():
    """The prior's blocks take the fp32 stream in a bf16 model, and the
    UNet's take bf16; both give the model dtype out."""
    prior = tprior.FramePrior(port_config(PriorConfig.tiny()))
    init_like_flax_(prior, torch.Generator().manual_seed(0))
    out, seen = _block_input_dtypes(prior.to(torch.bfloat16),
                                    *map(_bf16, _prior_args()))
    assert out.dtype == torch.bfloat16
    assert len(seen) == 2 * PriorConfig.tiny().num_layers
    assert set(seen) == {torch.float32}

    cfg = StoryUNetConfig.tiny()
    unet = tunet.StoryUNet(port_config(cfg))
    init_like_flax_(unet, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    out, seen = _block_input_dtypes(
        unet.to(torch.bfloat16),
        _bf16(rng.standard_normal((1, 5, 8, 8, 9)).astype(np.float32)),
        torch.tensor([500]),
        _bf16(rng.standard_normal((1, 5, 7, 24)).astype(np.float32)))
    assert out.dtype == torch.bfloat16
    assert seen and set(seen) == {torch.bfloat16}


def test_bf16_prior_matches_jax(jax_kernels):
    cfg = _temporal_live(PriorConfig.tiny())
    params = convert.convert_rcdms_prior(
        _unet_params(tprior.FramePrior(port_config(cfg))), cfg)
    args = _prior_args()
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32
             else jnp.asarray(a) for a in args]
    ref = jax.jit(jprior.FramePrior(cfg, dtype=jnp.bfloat16).apply)(
        {"params": params}, *jargs)
    ref = np.asarray(ref.astype(jnp.float32))

    m = tprior.FramePrior(port_config(cfg)).to(torch.bfloat16)
    bridge.load_state_dict(m, bridge.prior_state_dict({"params": params},
                                                      port_config(cfg)))
    with torch.no_grad():
        out = m(*map(_bf16, args))
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    diff = np.abs(out.float().numpy() - ref)
    top = np.abs(ref).max()
    # `pytest -s` shows the error, e.g. to compare two versions of the port
    print(f"bf16 prior vs flax: max {diff.max() / top:.3g}, mean "
          f"{diff.mean() / top:.3g} of max|ref|")
    assert diff.max() <= 2e-2 * top
    assert diff.mean() <= 5e-3 * top


def _strict(call, *args):
    """`call` jitted with excess precision off, so XLA rounds every bf16
    intermediate the kernel body rounds (as in
    tests/test_torch_attn_studies.py)."""
    return jax.jit(call).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _bf16_pair(ref, out):
    """max|out - ref| / max|ref| and the share of outputs off ref's bits."""
    out = out.float().numpy()
    return (np.abs(out - ref).max() / np.abs(ref).max(),
            float((out != ref).mean()))


@pytest.mark.parametrize("f,dh,n", [(5, 40, 37), (5, 80, 37), (5, 160, 19),
                                    (5, 256, 11), (3, 40, 37), (8, 80, 13)])
def test_bf16_frame_attention_rounds_like_the_tpu_kernel(jax_kernels, f, dh,
                                                         n):
    """Kernel B's plain version against `frame_attention_bfnc` in bf16 (the
    interpret-mode Pallas kernel, 8 heads, n ragged against its token
    block, pad lanes zero): the scale, q * scale and every per-channel
    product q_i k_j round to bf16 before the fp32 head sums, as in
    `_kernel_bfnc`. The two sides differ in the order of fp32 sums only;
    the parent's fp32 products and scale moved about 37% of the outputs."""
    heads, b = 8, 2
    c = heads * dh
    c_pad = -(-c // 128) * 128
    rng = np.random.default_rng(dh + f)
    qkv = [rng.standard_normal((b, f, n, c)).astype(np.float32)
           for _ in range(3)]
    padded = [jnp.asarray(np.pad(a, ((0, 0),) * 3 + ((0, c_pad - c),)))
              .astype(jnp.bfloat16) for a in qkv]
    ref = _strict(lambda q, k, v: jflash_frame(q, k, v, heads, c),
                  *padded)
    ref = np.asarray(ref.astype(jnp.float32))
    assert not ref[..., c:].any()
    out = frame_attention(*(torch.from_numpy(a).bfloat16() for a in qkv),
                          heads)
    assert out.dtype == torch.bfloat16
    worst, off = _bf16_pair(ref[..., :c], out)
    # `pytest -s` shows the error, e.g. to compare two versions of the port
    print(f"bf16 B vs the TPU kernel, f {f} dh {dh}: max {worst:.3g} of "
          f"max|ref|, {off:.3g} of the outputs off")
    assert worst <= 2.0 ** -7
    assert off <= 1e-3


@pytest.mark.parametrize("family", ["nt", "token_major"])
@pytest.mark.parametrize("dh", [40, 80])
def test_bf16_attention_plain_rounds_p_like_the_tpu_kernels(jax_kernels,
                                                            family, dh):
    """Kernel A's plain version against both TPU attention kernels in bf16,
    in interpret mode: `flash_attention_nt` (the UNet's sites; 91 real keys
    in its 128-row pad, row_sum "rounded": l from the bf16 P) and
    `flash_attention` (the CLIP vision sites; row_sum "fp32": l from the
    fp32 P). Both round the unnormalised P to bf16 before P.V. The
    parent's fp32 P moved 21-39% of the outputs."""
    b, heads, sq, kv_len = 2, 2, 256, 91
    c = heads * dh
    rng = np.random.default_rng(dh)
    q = rng.standard_normal((b, sq, c)).astype(np.float32) * 2
    k = rng.standard_normal((b, kv_len, c)).astype(np.float32) * 2
    v = rng.standard_normal((b, kv_len, c)).astype(np.float32)
    scale = dh ** -0.5
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    if family == "nt":
        qt, kt, vt = (jnp.swapaxes(a, 1, 2) for a in bf)
        pad = ((0, 0), (0, 0), (0, 128 - kv_len))
        ref = _strict(lambda a, b_, c_: jflash.flash_attention_nt(
            a, b_, c_, heads, scale, 128, kv_len), qt, jnp.pad(kt, pad),
            jnp.pad(vt, pad))
        ref = np.asarray(jnp.swapaxes(ref, 1, 2).astype(jnp.float32))
        row_sum = "rounded"
    else:
        def split(a):  # (b, s, c) -> (b, heads, s, dh)
            return jnp.swapaxes(a.reshape(b, -1, heads, dh), 1, 2)

        ref = _strict(lambda a, b_, c_: jflash.flash_attention(
            a, b_, c_, scale, 128, True), *map(split, bf))
        ref = np.asarray(jnp.swapaxes(ref, 1, 2).reshape(b, sq, c)
                         .astype(jnp.float32))
        row_sum = "fp32"
    out = attention_plain(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)), heads, scale,
                          row_sum=row_sum)
    assert out.dtype == torch.bfloat16
    worst, off = _bf16_pair(ref, out)
    print(f"bf16 A's plain version vs the TPU kernel, {family} dh {dh}: "
          f"max {worst:.3g} of max|ref|, {off:.3g} of the outputs off")
    assert worst <= 2.0 ** -7
    assert off <= 2e-3
