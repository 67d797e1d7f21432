"""The port's measuring tools of the conv, the contraction pads, the strips
and the chain slope (`rcdms_tpu_torch/tools/{conv_variants_study,
conv_study, mxu_pad_study, strip_efficiency, chainbench}.py`) against the
JAX tools of the same names in `tools/`, on the CPU. The tools measure a
card, so here they must refuse the CPU; what they compute is held here:

* conv_variants_study: each formulation against the JAX tool's function
  of the same name (`cudnn_conv` against `xla_conv`) on the same seeded
  numpy inputs, in fp32 at (2, 8, 8, 16) -> 16, and the anchors against
  the product they stand for; |diff| <= 1e-4 max |ref| (tests/
  test_torch_studies.py's CONV_REL: both sides sum 9 * C terms an output
  in fp32, in other orders). Its LEVELS are the JAX tool's.
* conv_study and mxu_pad_study: the rows (names, shapes, flops) equal the
  calls the JAX tools' `main`s make, recorded by monkeypatching their
  `bench_conv` and `bench_matmul`; the pad study's ratios are the JAX
  `main`'s arithmetic.
* chainbench: `feedback` equals the JAX `feedback` bit for bit in fp32
  and bf16, on arrays larger and smaller than the output.
* strip_efficiency: the heights and `strip_factor` equal what the JAX
  tool's `main` prints for the same times (its UNet and slope stubbed).

The JAX tools set two global JAX compile-cache settings when imported;
the fixture saves and restores them."""

import importlib
import io
import re
import sys
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu_torch.tools import chainbench as pcb
from rcdms_tpu_torch.tools import conv_study as pcs
from rcdms_tpu_torch.tools import conv_variants_study as pcv
from rcdms_tpu_torch.tools import mxu_pad_study as pmx
from rcdms_tpu_torch.tools import strip_efficiency as pse
from tests.test_torch_configs import one_torch_thread  # noqa: F401

CONV_REL = 1e-4
_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")
TOOLS = ("chainbench", "conv_study", "conv_variants_study",
         "mxu_pad_study", "strip_efficiency")


@pytest.fixture(scope="module")
def jtools():
    """The JAX tools, imported with the JAX compile-cache settings they
    change saved and restored (`tools/` is put on the path, as the tools
    themselves put it to import `chainbench`)."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    path = list(sys.path)
    try:
        mods = {m: importlib.import_module(f"tools.{m}") for m in TOOLS}
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return types.SimpleNamespace(settings_before=saved, **mods)


def test_jax_settings_survive_the_tool_imports(jtools):
    now = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    assert now == jtools.settings_before


def _conv_close(out, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=CONV_REL * np.abs(ref).max())


# ---- conv_variants_study ---------------------------------------------------

@pytest.fixture(scope="module")
def conv_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 16)) * 0.02).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name", list(pcv.FORMULATIONS))
def test_conv_formulation_equals_the_jax_one(jtools, conv_inputs, name):
    x, w = conv_inputs
    jname = "xla_conv" if name == "cudnn_conv" else name
    jfn = getattr(jtools.conv_variants_study, jname)
    fn = pcv.FORMULATIONS[name]
    if name == "taps9_cm":
        xt = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        ref = jfn(jnp.asarray(xt), jnp.asarray(w))
        out = fn(torch.from_numpy(xt), torch.from_numpy(w))
    else:
        ref = jfn(jnp.asarray(x), jnp.asarray(w))
        out = fn(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    _conv_close(out.numpy(), ref)


def test_conv_anchors_compute_their_products(jtools, conv_inputs):
    """The anchors against the JAX main's (`p @ q`; `nine_cm`: nine rolled
    (cout, c) @ (b, c, n) products summed in fp32)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((12, 36)).astype(np.float32)
    wb = rng.standard_normal((36, 8)).astype(np.float32)
    _conv_close(pcv.matmul_im2col(torch.from_numpy(a),
                                  torch.from_numpy(wb)).numpy(),
                jnp.asarray(a) @ jnp.asarray(wb))
    wm = rng.standard_normal((8, 6)).astype(np.float32)
    xm = rng.standard_normal((2, 6, 10)).astype(np.float32)
    ref = sum(jnp.einsum("dc,bcn->bdn", jnp.roll(jnp.asarray(wm), i, axis=0),
                         jnp.asarray(xm)) for i in range(9))
    _conv_close(pcv.matmul_taps_cm(torch.from_numpy(wm),
                                   torch.from_numpy(xm)).numpy(), ref)


def test_conv_levels_and_flops_are_the_jax_tools(jtools):
    jv = jtools.conv_variants_study
    assert pcv.LEVELS == jv.LEVELS
    for b, h, w, c in pcv.LEVELS.values():
        assert pcv.conv_flops(b, h, w, c, c) == jv.conv_flops(b, h, w, c, c)


# ---- conv_study and mxu_pad_study ------------------------------------------

def _recorded_main(monkeypatch, module, bench: str) -> list:
    """The calls `module.main()` makes to `module.<bench>`, recorded
    instead of timed (argv emptied; a result of 1 ms each)."""
    calls = []

    def record(*args, **kw):
        calls.append(args)
        if kw.get("results") is not None:
            kw["results"][args[0]] = 1e-3
        return 1e-3

    monkeypatch.setattr(module, bench, record)
    monkeypatch.setattr(sys, "argv", [module.__name__])
    with redirect_stdout(io.StringIO()):
        module.main()
    return calls


def test_conv_study_rows_are_the_jax_mains_calls(jtools, monkeypatch):
    calls = _recorded_main(monkeypatch, jtools.conv_study, "bench_conv")
    assert [tuple(c) for c in calls] == [tuple(r) for r in pcs.ROWS]
    for name, b, h, w, cin, cout in pcs.ROWS:
        assert pcs.flops(b, h, w, cin, cout) == 2 * b * h * w * 9 * cin * cout


def test_mxu_pad_rows_are_the_jax_mains_calls(jtools, monkeypatch):
    calls = _recorded_main(monkeypatch, jtools.mxu_pad_study, "bench_matmul")
    assert [tuple(c) for c in calls] == [tuple(r) for r in pmx.ROWS]
    for name, m, k, n, b in pmx.ROWS:
        assert pmx.flops(m, k, n, b) == 2 * b * m * k * n


def test_mxu_pad_ratios_are_the_jax_mains(jtools, monkeypatch):
    """The JAX main's four printed ratios for the same (made-up) times."""
    times = {name: 0.1 + 0.01 * i for i, (name, *_) in enumerate(pmx.ROWS)}

    def timed(name, m, k, n, b, dtype=None, results=None):
        results[name] = times[name]
        return times[name]

    monkeypatch.setattr(jtools.mxu_pad_study, "bench_matmul", timed)
    monkeypatch.setattr(sys, "argv", ["mxu_pad_study"])
    out = io.StringIO()
    with redirect_stdout(out):
        jtools.mxu_pad_study.main()
    printed = re.findall(r"(?:ratio|scaling):\s+(-?\d+\.\d+)",
                         out.getvalue())
    assert printed == [f"{v:.2f}" for v in pmx.ratios(times).values()]


# ---- chainbench -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shapes", [((4, 6), (3, 5)), ((2, 3), (4, 4, 2))],
                         ids=["y_smaller", "y_larger"])
def test_feedback_equals_the_jax_feedback(jtools, dtype, shapes):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shapes[0]).astype(np.float32)
    y = (rng.standard_normal(shapes[1]) * 1e18).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = jtools.chainbench.feedback(jnp.asarray(a, jdt), jnp.asarray(y))
    got = pcb.feedback(torch.from_numpy(a).to(getattr(torch, dtype)),
                       torch.from_numpy(y))
    assert got.shape == a.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert not np.array_equal(got.float().numpy(),
                              np.asarray(jnp.asarray(a, jdt), np.float32))


# ---- strip_efficiency -------------------------------------------------------

def test_strip_factors_are_the_jax_mains(jtools, monkeypatch):
    """The JAX main with its UNet stubbed and its slope taken from a table
    by height: its heights and printed factors against the port's."""
    import rcdms_tpu.models.unet3d as junet

    times = {64: 0.2, 32: 0.13, 16: 0.08, 8: 0.061}

    class Unet:
        def __init__(self, cfg, dtype=None):
            self.cfg = cfg

        def init(self, key, x, tb, ctx):
            return {}

    monkeypatch.setattr(junet, "StoryUNet", Unet)
    monkeypatch.setattr(jtools.strip_efficiency, "slope_time",
                        lambda fn, x, params: times[x.shape[2]])
    out = io.StringIO()
    with redirect_stdout(out):
        jtools.strip_efficiency.main()
    printed = [(int(h), f) for h, f in re.findall(
        r"H=\s*(\d+):.*strip_factor\s+(\d+\.\d+)", out.getvalue())]
    assert [h for h, _ in printed] == list(pse.HEIGHTS)
    assert printed == [(h, f"{pse.strip_factor(times[h], times[64], h):.2f}")
                       for h in pse.HEIGHTS]


def test_strip_inputs_are_the_jax_tools_shapes():
    """b 1, 5 frames, 64 columns, 91 tokens, as the JAX main's."""
    assert (pse.B, pse.FRAMES, pse.COLS, pse.TOKENS) == (1, 5, 64, 91)
    assert pse.WHOLE == 64


# ---- the tools need a card --------------------------------------------------

@pytest.mark.parametrize("run", [
    lambda dev: pcs.run(dev), lambda dev: pmx.run(dev),
    lambda dev: pcv.run(0, dev), lambda dev: pse.run(dev),
    lambda dev: pcb.slope_ms(lambda t: t, torch.zeros(2, device=dev))],
    ids=["conv_study", "mxu_pad_study", "conv_variants_study",
         "strip_efficiency", "chainbench"])
def test_tools_refuse_the_cpu(run):
    with pytest.raises(RuntimeError):
        run(torch.device("cpu"))
