"""The port's ResNet-block study kernels (`rcdms_tpu_torch/ops/cm_conv.py`,
`ops/group_norm.py`) and studies (`rcdms_tpu_torch/tools/`) against the JAX
studies in `tools/`, on the CPU, on the same numpy inputs. The Pallas
kernels `cm_conv_pallas` and `_gn_pallas` run in interpret mode;
`pallas_moments` has no interpret switch and fixes its shape at module
level, so the moments are held against the study's own reference,
`xla_mean2`. On the CPU each port wrapper runs its plain PyTorch version;
tests/test_torch_cuda.py launches the CUDA kernels on a card.

Tolerances: both sides compute in fp32 and differ only in summation order.
GroupNorm and the moments: atol = rtol = 2e-5. The conv sums 9 * C terms
an output: |diff| <= 1e-4 * max|ref|. The layout helpers: exact."""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.ops import flash as jflash
from rcdms_tpu_torch import ops
from rcdms_tpu_torch.io.bridge import hwio_to_conv_weight
from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3, tap_offsets
from rcdms_tpu_torch.ops.group_norm import gn_moments, group_norm_act
from rcdms_tpu_torch.tools import cm_conv_study as pcs
from rcdms_tpu_torch.tools import gn_fused_study as pgf
from rcdms_tpu_torch.tools import gn_study as pgs

TOL = dict(atol=2e-5, rtol=2e-5)
CONV_REL = 1e-4
_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jstudy():
    """The JAX studies. gn_study and gn_fused_study set two global JAX
    compile-cache settings when imported; they are saved and restored so
    that nothing leaks into the tests that share this process."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    try:
        mods = {m: importlib.import_module(f"tools.{m}")
                for m in ("cm_conv_study", "gn_study", "gn_fused_study")}
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return types.SimpleNamespace(cm=mods["cm_conv_study"],
                                 gn=mods["gn_study"],
                                 gf=mods["gn_fused_study"],
                                 settings_before=saved)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jflash.set_kernel_interpret(True)
    try:
        yield
    finally:
        jflash.set_kernel_interpret(False)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _conv_close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=CONV_REL * np.abs(ref).max())


def test_jax_settings_survive_the_study_imports(jstudy):
    now = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    assert now == jstudy.settings_before
    assert (jstudy.gn.B, jstudy.gn.N, jstudy.gn.C) == (pgs.B, pgs.N, pgs.C)
    assert (jstudy.gf.GROUPS, jstudy.gf.EPS) == (pgf.GROUPS, pgf.EPS)


# --- the conv -------------------------------------------------------------


@pytest.mark.parametrize("shifts", [True, False])
@pytest.mark.parametrize("b,c,cout", [(2, 16, 24), (1, 3, 5)])
def test_cm_conv_matches_pallas(jstudy, shifts, b, c, cout):
    """cm_conv_pallas (interpret mode) against ops.cm_conv3x3 on the study's
    64 x 64 frame padded to TPAD tokens; (1, 3, 5) has odd widths."""
    rng = np.random.default_rng(0)
    x_cmp = np.array(jstudy.cm.to_cm_pad(jnp.asarray(
        _f32(rng, b, 64, 64, c))))
    w9 = _f32(rng, 9, c, cout, scale=(9 * c) ** -0.5)
    bias = _f32(rng, cout)
    mask = np.array(jstudy.cm.interior_mask_pad())
    ref = jstudy.cm.cm_conv_pallas(jnp.asarray(x_cmp), jnp.asarray(w9),
                                   jnp.asarray(bias), jnp.asarray(mask),
                                   shifts=shifts)
    out = cm_conv3x3(torch.from_numpy(x_cmp), torch.from_numpy(w9),
                     torch.from_numpy(bias),
                     torch.from_numpy(mask.reshape(-1)), pcs.WP,
                     shifts=shifts)
    _conv_close(out.numpy(), ref)


def test_layout_helpers_match(jstudy):
    x = _f32(np.random.default_rng(1), 2, 64, 64, 3)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cm = jstudy.cm
    np.testing.assert_array_equal(pcs.to_cm(tx).numpy(),
                                  np.asarray(cm.to_cm(jx)))
    np.testing.assert_array_equal(pcs.from_cm(pcs.to_cm(tx)).numpy(),
                                  np.asarray(cm.from_cm(cm.to_cm(jx))))
    np.testing.assert_array_equal(pcs.to_cm_pad(tx).numpy(),
                                  np.asarray(cm.to_cm_pad(jx)))
    np.testing.assert_array_equal(pcs.interior_mask().numpy(),
                                  np.asarray(cm.interior_mask()))
    np.testing.assert_array_equal(pcs.interior_mask_pad().numpy(),
                                  np.asarray(cm.interior_mask_pad()))
    assert (pcs.B, pcs.H, pcs.W, pcs.WP, pcs.TPAD) == (
        cm.B, cm.H, cm.W, cm.WP, cm.TPAD)
    assert tap_offsets(pcs.WP) == cm.TAPS


def _conv_inputs(seed=2, b=2, c=8, cout=12):
    rng = np.random.default_rng(seed)
    return (_f32(rng, b, 64, 64, c),
            _f32(rng, 3, 3, c, cout, scale=(9 * c) ** -0.5),
            _f32(rng, cout))


def _port_conv_row(name, x, w_hwio, bias):
    """The port study's row `name` on the CPU, as NHWC interior outputs."""
    tx, tw, tb = map(torch.from_numpy, (x, w_hwio, bias))
    if name == "native":
        return pcs.native(tx, hwio_to_conv_weight(tw), tb)
    if name == "taps9_tok":
        return pcs.taps9_tok(tx, tw, tb)
    w9 = tw.reshape(9, tw.shape[2], tw.shape[3])
    return pcs.from_cm(pcs.cm_conv(pcs.to_cm(tx), w9, tb,
                                   pcs.interior_mask(), name[3:]))


@pytest.mark.parametrize("name", ["native", "taps9_tok", "cm_wx", "cm_xw"])
def test_conv_rows_match_jax_study(jstudy, name):
    """Each plain row of the port's conv study against the JAX study's row
    of the same name (native: lax.conv against F.conv2d)."""
    x, w_hwio, bias = _conv_inputs()
    jx, jw, jb = map(jnp.asarray, (x, w_hwio, bias))
    cm = jstudy.cm
    if name == "native":
        ref = cm.native_conv(jx, jw, jb)
    elif name == "taps9_tok":
        ref = cm.taps9_tok(jx, jw, jb)
    else:
        ref = cm.from_cm(cm.cm_conv(cm.to_cm(jx), jw.reshape(9, 8, 12), jb,
                                    cm.interior_mask(), name[3:]))
    _conv_close(_port_conv_row(name, x, w_hwio, bias).numpy(), ref)


def test_conv_plain_rows_agree():
    """taps9_tok = cm_wx = cm_xw = native on the interior, and the kernel's
    plain version on the padded frame, all in the port on the CPU."""
    x, w_hwio, bias = _conv_inputs(seed=3, b=1, c=5, cout=7)
    ref = _port_conv_row("native", x, w_hwio, bias).numpy()
    for name in ("taps9_tok", "cm_wx", "cm_xw"):
        _conv_close(_port_conv_row(name, x, w_hwio, bias).numpy(), ref)
    tx = torch.from_numpy(x)
    out = cm_conv3x3(pcs.to_cm_pad(tx), torch.from_numpy(w_hwio).reshape(
        9, 5, 7), torch.from_numpy(bias), pcs.interior_mask_pad().reshape(-1),
        pcs.WP)
    _conv_close(pcs.from_cm(out[:, :, :pcs.TP]).numpy(), ref)
    assert (out[:, :, pcs.TP:] == 0).all()


# --- GroupNorm ------------------------------------------------------------


@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 128, 96)])
def test_group_norm_matches_pallas(jstudy, act, shape):
    """_gn_pallas (interpret mode) against ops.group_norm_act, 32 groups;
    (3, 128, 96) has 3 channels a group."""
    rng = np.random.default_rng(4)
    c = shape[-1]
    x = _f32(rng, *shape)
    scale = _f32(rng, c, scale=0.5) + 1.0
    bias = _f32(rng, c, scale=0.2)
    assert jstudy.gf.fits_kernel(shape[1], c)
    ref = jstudy.gf._gn_pallas(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 32, 1e-6, act)
    out = group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 32, 1e-6, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_two_pass_row_matches_xla_reference(jstudy):
    """The port study's two_pass row is the JAX study's _xla_reference."""
    rng = np.random.default_rng(5)
    x = _f32(rng, 2, 5, 16, 64)  # leading dims flatten like the kernel's
    scale, bias = _f32(rng, 64) + 1.0, _f32(rng, 64, scale=0.2)
    ref = jstudy.gf._xla_reference(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias), groups=32, eps=1e-6,
                                   act="silu")
    out = group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 32, 1e-6, "silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_moments_match_xla_mean2(jstudy):
    x = _f32(np.random.default_rng(6), 3, 256, 64)
    ref = jstudy.gn.xla_mean2(jnp.asarray(x))
    out = gn_moments(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_matmul_red_matches_jax_study(jstudy):
    """The JAX study's matmul_red fixes N = 4096 at module level."""
    x = _f32(np.random.default_rng(7), 2, jstudy.gn.N, 16)
    ref = jstudy.gn.matmul_red(jnp.asarray(x))
    out = pgs.matmul_red(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_gn_plain_rows_agree():
    """matmul_red = xla_mean2 in the port on the CPU."""
    x = torch.from_numpy(_f32(np.random.default_rng(8), 3, 256, 64))
    for o, r in zip(pgs.matmul_red(x), pgs.xla_mean2(x)):
        torch.testing.assert_close(o, r, **TOL)


def test_torch_gn_row_matches_two_pass():
    """F.group_norm + SiLU on the channels-first copy = the plain version."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_f32(rng, 2, 64, 64))
    scale = torch.from_numpy(_f32(rng, 64, scale=0.5) + 1.0)
    bias = torch.from_numpy(_f32(rng, 64, scale=0.2))
    ref = group_norm_act(x, scale, bias, pgf.GROUPS, pgf.EPS, "silu")
    out = pgf.torch_gn(x.transpose(1, 2).contiguous(), scale, bias)
    torch.testing.assert_close(out.transpose(1, 2), ref, **TOL)


# --- the wrappers and the studies' contract --------------------------------


def test_cpu_wrappers_do_not_count():
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 64)
    gn_moments(x)
    group_norm_act(x, torch.ones(64), torch.zeros(64), 32, 1e-6, "silu")
    cm_conv3x3(torch.zeros(1, 2, 16), torch.zeros(9, 2, 3), torch.zeros(3),
               torch.ones(16), 4)
    c = torch.zeros(1, 40, 512, dtype=torch.bfloat16)
    seeds = torch.ones(1, 8, 128, dtype=torch.bfloat16)
    ops.smallk_attention(c, c, c, 1.0, channel_major=True, norm="rounded")
    ops.attn_scores(c, c, channel_major=True)
    ops.attn_pv(c, seeds=seeds, channel_major=True, cells=1)
    ops.attn_softmax(seeds=seeds, skv=512, cells=1)
    assert ops.launch_counts("studies") == dict.fromkeys(
        ops.PATHS["studies"], 0)


def test_paths_split_the_kernels():
    assert set(ops.PATHS["story"]) == {"attention", "frame_attention",
                                       "geglu_ff", "gelu_ff"}
    assert set(ops.PATHS["studies"]) == {
        "cm_conv3x3", "gn_moments", "group_norm_act", "smallk_attention",
        "attn_scores", "attn_pv", "attn_softmax"}
    assert len(ops.KERNELS) == 11
    assert ops.KERNELS == {**ops.PATHS["story"], **ops.PATHS["studies"]}


@pytest.mark.parametrize("bad", [
    dict(w9=(9, 3, 4)),       # C of w9 differs from x's
    dict(mask=(15,)),         # mask is not (T,)
    dict(bias=(5,)),          # bias is not (Cout,)
])
def test_cm_conv_rejects_bad_shapes(bad):
    shapes = dict(x=(1, 2, 16), w9=(9, 2, 4), bias=(4,), mask=(16,)) | bad
    t = {k: torch.zeros(s) for k, s in shapes.items()}
    with pytest.raises(ValueError):
        cm_conv3x3(t["x"], t["w9"], t["bias"], t["mask"], 4)


def test_group_norm_rejects_bad_groups_and_act():
    x = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError):
        group_norm_act(x, torch.ones(64), torch.zeros(64), 5, 1e-6, "silu")
    with pytest.raises(ValueError):
        group_norm_act(x, torch.ones(64), torch.zeros(64), 32, 1e-6, "gelu")


@pytest.mark.parametrize("study", [pcs, pgs, pgf])
def test_studies_refuse_the_cpu(study):
    with pytest.raises(RuntimeError):
        study.run(torch.device("cpu"))
