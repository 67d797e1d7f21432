"""The port's studies of the main path's feed-forwards and prior
(`rcdms_tpu_torch/tools/{geglu_study, prior_ff_study, prior_floor_study,
qkv_fusion_study, int8_study}.py`) against the JAX studies in `tools/`, on
the CPU, on the same numpy inputs; and C/D's plan override
(`rcdms_tpu_torch/ops/geglu.py::set_plan_override`), whose plans are pure
Python. The studies measure a card, so here they must refuse the CPU; what
they compute (their functions, constants, quantizer and flop count) is
held here. JAX's layout keeps Dense kernels (in, out), the port's Linear
weights (out, in).

The JAX studies define their constants and some formulations inside
`main`; those are taken from `main`'s source with `ast` (constants
evaluated, functions run with the study's names bound), so the port is
held against the JAX code itself.

Tolerances: fp32 on both sides, differing only in the order of sums:
max |diff| <= 2e-5 max |ref|. bf16 anchor: both round the products, the
biases, the gate and the product h * gelu(g) to bf16 where `_xla_reference`
rounds, but a sum may round the other way: max |diff| <= 2^-6 max |ref|.
The quantizer and the flop count: exact."""

import ast
import importlib
import inspect
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops import geglu as jgeglu
from rcdms_tpu.ops.frame_attention import (
    _bfnc_xla_reference,
    frame_attention_bfnc,
)
from rcdms_tpu_torch import ops, tools
from rcdms_tpu_torch.configs import PriorConfig
from rcdms_tpu_torch.ops import geglu
from rcdms_tpu_torch.ops.frame_attention import frame_attention_plain
from rcdms_tpu_torch.tools import geglu_study as pgs
from rcdms_tpu_torch.tools import int8_study as pis
from rcdms_tpu_torch.tools import prior_ff_study as pps
from rcdms_tpu_torch.tools import prior_floor_study as pfs
from rcdms_tpu_torch.tools import qkv_fusion_study as pqs
from tests.test_torch_configs import one_torch_thread  # noqa: F401
from tests.test_torch_kernel_plans import FF_SITES, SMEM_LIMIT

REL = 2e-5
BF16_REL = 2.0 ** -6
_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")
STUDIES = ("geglu_study", "prior_ff_study", "prior_floor_study",
           "qkv_fusion_study", "int8_study")
FF_CU = Path(geglu.__file__).resolve().parents[1] / "csrc" / "ff.cu"


@pytest.fixture(scope="module")
def jstudy():
    """The JAX studies. Four of them set two global JAX compile-cache
    settings when imported; they are saved and restored so that nothing
    leaks into the tests that share this process."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    try:
        mods = {m: importlib.import_module(f"tools.{m}") for m in STUDIES}
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return types.SimpleNamespace(settings_before=saved, **{
        m.removesuffix("_study"): mod for m, mod in mods.items()})


@pytest.fixture(autouse=True)
def _reset_override():
    """No test leaves a plan override behind."""
    yield
    geglu.set_plan_override(None)


def _main_body(module) -> list:
    tree = ast.parse(inspect.getsource(module))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return main.body


def _main_constants(module, *names) -> dict:
    """The values of `main`'s top-level assignments to `names` (constant
    expressions of the module's globals, as `M, K = 970, 2048`)."""
    out = {}
    for node in _main_body(module):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        targets = (target.elts if isinstance(target, ast.Tuple)
                   else [target])
        if not any(isinstance(t, ast.Name) and t.id in names
                   for t in targets):
            continue
        value = eval(compile(ast.Expression(node.value), "<main>", "eval"),
                     vars(module))
        values = value if isinstance(target, ast.Tuple) else (value,)
        for t, v in zip(targets, values):
            out[t.id] = v
    assert set(out) == set(names), (module.__name__, out)
    return out


def _main_function(module, name, **bound):
    """`main`'s nested function `name`, built with `bound` as its
    globals."""
    node = next(n for n in _main_body(module)
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(bound)
    exec(compile(ast.Module(body=[node], type_ignores=[]), "<main>",
                 "exec"), ns)
    return ns[name]


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(out, ref, rel=REL):
    out = np.asarray(out, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _ff_weights(rng, c, inner, geglu_):
    """JAX-layout FF weights: w1 (c, up), b1 (up,), w2 (inner, c), b2."""
    up = 2 * inner if geglu_ else inner
    return (_f32(rng, c, up, scale=c ** -0.5), _f32(rng, up, scale=0.1),
            _f32(rng, inner, c, scale=inner ** -0.5), _f32(rng, c, scale=0.1))


def _torch_ff(x, w1, b1, w2, b2, dtype=torch.float32):
    """The same operands in torch's Linear layout."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                 for a in (x, w1.T, b1, w2.T, b2))


# --- the constants ---------------------------------------------------------


def test_jax_settings_survive_the_study_imports(jstudy):
    now = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    assert now == jstudy.settings_before


def test_constants_match_the_jax_studies(jstudy):
    assert pgs.SHAPES[:3] == jstudy.geglu.SHAPES
    assert [(b * n, c, True) for _, b, n, c in pgs.SHAPES] == \
        [s for s in FF_SITES if s[2]]
    j = jstudy.prior_ff
    assert (pps.B, pps.F_, pps.N, pps.C, pps.ROWS, pps.INNER) == (
        j.B, j.F, j.N, j.C, j.ROWS, j.INNER)
    assert pps.PADDED - pps.ROWS == _main_constants(j, "pad")["pad"]
    assert _main_constants(jstudy.qkv_fusion, "M", "K") == dict(
        M=pqs.M, K=pqs.K)
    k = _main_constants(jstudy.int8, "N", "B", "sq", "skv", "dh", "blk")
    assert k == dict(N=pis.N, B=pis.BATCH, sq=pis.SQ, skv=pis.SKV,
                     dh=pis.DH, blk=pis.BLK)
    # the conv shapes of item 2: the list `main` loops over
    loop = next(n for n in _main_body(jstudy.int8)
                if isinstance(n, ast.For) and isinstance(n.iter, ast.List))
    assert eval(compile(ast.Expression(loop.iter), "<main>", "eval")) == \
        pis.CONV_SHAPES


def test_flop_formulas_match(jstudy):
    """geglu_study's `fl` (main) and prior_ff_study's pair flops."""
    for _, b, n, c in pgs.SHAPES:
        inner = 4 * c
        fl = 2 * b * n * c * 2 * inner + 2 * b * n * inner * c
        assert pgs.flops(b * n, c, inner) == fl
    f_down = 2 * pps.ROWS * pps.INNER * pps.C
    f_up = 2 * pps.ROWS * pps.C * pps.INNER
    assert pgs.flops(pps.ROWS, pps.C, pps.INNER, False) == f_up + f_down


# --- geglu_study: the anchor -------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(2, 24, 32), (1, 37, 48)])
def test_anchor_matches_xla_reference(dtype, b, n, c):
    """The study's anchor (two products, the biases and the GEGLU between
    them) against `geglu._xla_reference`, at the JAX study's (B, n, c)
    layout cut to size; (1, 37, 48) is ragged everywhere."""
    rng = np.random.default_rng(c)
    x = _f32(rng, b, n, c)
    w = _ff_weights(rng, c, 4 * c, True)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jgeglu._xla_reference(*(jnp.asarray(a).astype(jdt)
                                  for a in (x, *w)))
    out = pgs.anchor(*_torch_ff(x, *w, dtype=dtype))
    assert out.dtype == dtype
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           REL if dtype == torch.float32 else BF16_REL)


def test_sweep_rows_run_c_on_the_cpu():
    """The kernel the sweep times, with an override set, is C's plain
    version on CPU tensors: the override changes only a card's plan."""
    rng = np.random.default_rng(3)
    args = _torch_ff(_f32(rng, 40, 32), *_ff_weights(rng, 32, 128, True))
    ref = geglu.geglu_ff_plain(*args)
    geglu.set_plan_override(32, 96)
    torch.testing.assert_close(geglu.geglu_ff(*args), ref, rtol=0, atol=0)


def test_pass_us_splits_the_passes():
    kernels = {"void rcdms::(anonymous namespace)::ff_gemm_kernel<128, 2>"
               "(CUtensorMap, ...)": 30.0,
               "void rcdms::(anonymous namespace)::ff_gemm_kernel<160, 0>"
               "(CUtensorMap, ...)": 12.5,
               "void rcdms::(anonymous namespace)::ff_gemm_kernel<256, 1>"
               "(CUtensorMap, ...)": 1.0,
               "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": 7.0}
    assert pgs.pass_us(kernels) == (31.0, 12.5)
    assert pgs.gemm_ms(kernels) == pytest.approx(0.007)


@pytest.mark.parametrize("lost", [0, 3])
def test_per_call_us_reads_the_calls_after_the_marker(lost):
    """`tools.per_call_us`: the warm-up calls before the marker (some of
    them unseen) do not count; each kernel's time after it, over reps."""
    reps = 4
    warm = [(n, t, 9.0) for t, n in enumerate(["a", "b"] * 5)][lost:]
    marker = [(tools.MARKER + "(long)", 20, 0.5)]
    timed = [(n, 30 + 2 * i + j, us) for i in range(reps)
             for j, (n, us) in enumerate((("a", 3.0), ("b", 1.5)))]
    got = tools.per_call_us(timed[::-1] + marker + warm, reps)
    assert got == {"a": 3.0, "b": 1.5}


@pytest.mark.parametrize("drop", ["marker", "a call's kernel"])
def test_per_call_us_refuses_a_partial_profile(drop):
    reps = 4
    timed = [(n, 30 + 2 * i + j, 1.0) for i in range(reps)
             for j, n in enumerate("ab")]
    marker = [(tools.MARKER, 20, 0.5)]
    kernels = timed if drop == "marker" else marker + timed[1:]
    assert tools.per_call_us(kernels, reps) is None


@pytest.mark.parametrize("drop", ["marker", "a call's kernel", "calls"])
def test_profile_fault_names_what_the_profile_missed(drop):
    """`tools.profile_fault`, which `device_us` raises with: the markers
    seen, the kernels whose counts are off, or no kernel after the
    marker; None on a whole profile."""
    reps = 4
    timed = [(n, 30 + 2 * i + j, 1.0) for i in range(reps)
             for j, n in enumerate("ab")]
    marker = [(tools.MARKER, 20, 0.5)]
    assert tools.profile_fault(marker + timed, reps) is None
    kernels = {"marker": timed, "a call's kernel": marker + timed[1:],
               "calls": marker}[drop]
    assert tools.profile_fault(kernels, reps) == {
        "marker": "0 markers among 8 kernels",
        "a call's kernel": "counts after the marker no multiple of 4: "
                           "{'a': 3}",
        "calls": "no kernel after the marker"}[drop]


# --- prior_ff_study -------------------------------------------------------


@pytest.mark.parametrize("pair", ["gelu", "geglu"])
def test_pairs_match_prior_ff_study(jstudy, pair):
    """The plain GELU and GEGLU pairs against the JAX study's `gelu_ff`
    and `geglu_xla` (main's own functions), fp32."""
    rng = np.random.default_rng(4)
    c, inner = 32, 128
    x = _f32(rng, 97, c)
    w1, b1, w2, b2 = _ff_weights(rng, c, inner, False)
    w1g, b1g = _f32(rng, c, 2 * inner, scale=c ** -0.5), _f32(
        rng, 2 * inner, scale=0.1)
    names = dict(jnp=jnp, jax=jax, dt=jnp.float32, w1=jnp.asarray(w1),
                 b1=jnp.asarray(b1), w2=jnp.asarray(w2), b2=jnp.asarray(b2),
                 w1g=jnp.asarray(w1g), b1g=jnp.asarray(b1g))
    if pair == "gelu":
        ref = _main_function(jstudy.prior_ff, "gelu_ff", **names)
        out = pps.gelu_pair(*_torch_ff(x, w1, b1, w2, b2))
    else:
        ref = _main_function(jstudy.prior_ff, "geglu_xla", **names)
        out = pps.geglu_pair(*_torch_ff(x, w1g, b1g, w2, b2))
    _close(out.numpy(), ref(jnp.asarray(x)))


def test_padded_rows_equal_the_ragged_rows():
    """The ->1024 row pads 970 rows and slices the pad off: on the CPU the
    same values as the rows as they are."""
    rng = np.random.default_rng(5)
    args = _torch_ff(_f32(rng, 97, 32), *_ff_weights(rng, 32, 128, False))
    torch.testing.assert_close(pps.padded(geglu.gelu_ff, 128)(*args),
                               geglu.gelu_ff(*args), rtol=0, atol=0)


@pytest.fixture
def interpret_kernels():
    jflash.set_kernel_interpret(True)
    try:
        yield
    finally:
        jflash.set_kernel_interpret(False)


@pytest.mark.parametrize("shape", [(2, 5, 7, 128), (1, 5, 13, 256)])
def test_frame_attention_rows_match_bfnc(interpret_kernels, shape):
    """B's rows (the wrapper, which runs its plain version here, and the
    plain version itself) against `_bfnc_xla_reference` and the Pallas
    `_kernel_bfnc` in interpret mode, 8 heads, fp32."""
    rng = np.random.default_rng(shape[-1])
    q, k, v = (_f32(rng, *shape) for _ in range(3))
    c = shape[-1]
    scale = (c // pps.HEADS) ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    refs = (_bfnc_xla_reference(jq, jk, jv, pps.HEADS, scale, c),
            frame_attention_bfnc(jq, jk, jv, pps.HEADS, c))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    outs = (ops.frame_attention(tq, tk, tv, pps.HEADS),
            frame_attention_plain(tq, tk, tv, pps.HEADS, scale))
    for out in outs:
        for ref in refs:
            _close(out.numpy(), ref)


# --- prior_floor_study ------------------------------------------------------


def _jax_rules(cfg, b):
    """The JAX study's token rules, as `main` passes them."""
    f, seq = cfg.num_frames, cfg.seq_len
    return [
        (lambda s: any(k in s for k in (
            "embedding_proj", "proj_in", "proj_to_clip_embeddings",
            "time_embedding")) and "block" not in s and "temporal" not in s,
         2 * b * f),
        (lambda s: "encoder_hidden_states_proj" in s,
         2 * b * f * cfg.num_text_tokens),
        (lambda s: True, 2 * b * f * seq),
    ]


def _jax_attention_flops(cfg, b):
    """The JAX study's analytic attention terms (`main`)."""
    seq, inner, f = cfg.seq_len, cfg.inner_dim, cfg.num_frames
    heads, dh = cfg.num_heads, cfg.head_dim
    per_step = cfg.num_layers * 2 * (2 * b * f) * heads * seq * seq * dh * 2
    t = cfg.temporal
    per_step += (cfg.num_layers * t.num_blocks * t.attn_layers_per_block
                 * 2 * (2 * b * seq) * t.num_heads * f * f
                 * (inner // t.num_heads) * 2)
    return per_step


@pytest.mark.parametrize("b", [1, 2])
def test_prior_flops_match_the_jax_count(jstudy, b):
    """`count_dense_flops` over the torch prior's Linear weights and the
    attention terms against the JAX study's count over the flax prior's
    Dense kernels, at the tiny PriorConfig: the same integer, and the
    same (rows, K, N) of every weight."""
    from rcdms_tpu import configs as jconfigs
    from rcdms_tpu.models.prior import FramePrior as JPrior
    from rcdms_tpu_torch.models.prior import FramePrior

    jcfg = jconfigs.PriorConfig.tiny()
    cfg = PriorConfig.tiny()
    f, t, d = cfg.num_frames, cfg.num_text_tokens, cfg.embedding_dim
    params = jax.eval_shape(lambda key: JPrior(jcfg).init(
        key, jnp.zeros((1, f, d)), jnp.zeros((1, f), jnp.int32),
        jnp.zeros((1, f, d)), jnp.zeros((1, f, t, d)), jnp.zeros((1, f, d)),
        jnp.zeros((1, f, d)), jnp.ones((1, f, t), bool)),
        jax.random.PRNGKey(0))
    jtotal, jrows = jstudy.prior_floor.count_dense_flops(
        params, _jax_rules(jcfg, b))
    ptotal, prows = pfs.count_dense_flops(FramePrior(cfg),
                                          pfs.token_rules(cfg, b))
    assert ptotal == jtotal and isinstance(ptotal, int)
    assert sorted(r[1:] for r in prows) == sorted(r[1:] for r in jrows)
    assert pfs.attention_flops(cfg, b) == _jax_attention_flops(jcfg, b)


def test_prior_flops_at_full_width():
    """The full-width prior's count, from its shapes alone (a meta-device
    model): one step's flops and the FF shapes' share of them, the
    weights the ceilings' harmonic mean takes (`SQUARE_SHARE`,
    `FF_SHARE`)."""
    cfg = PriorConfig()
    from rcdms_tpu_torch.models.prior import FramePrior

    with torch.device("meta"):
        model = FramePrior(cfg)
    total, rows = pfs.count_dense_flops(model, pfs.token_rules(cfg))
    ff = sum(2 * m * k * n for _, m, k, n in rows
             if max(k, n) >= 4 * cfg.inner_dim)
    assert all(m == 970 for name, m, _, _ in rows
               if name.startswith("transformer_blocks."))
    assert 0.5 < ff / total < 0.6  # the JAX study's 55%
    assert pfs.SQUARE_SHARE + pfs.FF_SHARE == 1.0


# --- qkv_fusion_study ------------------------------------------------------


def test_qkv_rows_match_the_jax_formulations(jstudy):
    """square, separate and fused against the JAX study's lambdas in
    `main` (tanh before any combine), fp32; fused = separate."""
    rng = np.random.default_rng(6)
    m, k = 33, 16
    wq, wk, wv = (_f32(rng, k, k, scale=k ** -0.5) for _ in range(3))
    x = _f32(rng, m, k)
    j = dict(x=jnp.asarray(x), wq=jnp.asarray(wq), wk=jnp.asarray(wk),
             wv=jnp.asarray(wv))
    w_qkv = np.concatenate([wq, wk, wv], axis=1)
    sep_ref = (jnp.tanh(j["x"] @ j["wq"]) + jnp.tanh(j["x"] @ j["wk"])
               + jnp.tanh(j["x"] @ j["wv"]))
    fus_ref = jnp.tanh(j["x"] @ jnp.asarray(w_qkv)).reshape(m, 3, k).sum(1)
    t = {n: torch.from_numpy(a) for n, a in dict(
        x=x, wq=wq, wk=wk, wv=wv, w_qkv=w_qkv).items()}
    _close(pqs.square(t["x"], t["wq"]).numpy(), jnp.tanh(j["x"] @ j["wq"]))
    _close(pqs.separate(t["x"], t["wq"], t["wk"], t["wv"]).numpy(), sep_ref)
    _close(pqs.fused(t["x"], t["w_qkv"]).numpy(), fus_ref)
    _close(pqs.fused(t["x"], t["w_qkv"]).numpy(), sep_ref)
    # the JAX study's own lambdas, as main writes them
    src = inspect.getsource(jstudy.qkv_fusion.main)
    assert "jnp.tanh(a @ wq) + jnp.tanh(a @ wk) + jnp.tanh(a @ wv)" in src
    assert "jnp.tanh(a @ w_qkv).reshape(M, 3, K).sum(1)" in src


def test_qkv_sites_of_a_prior_step():
    assert pqs.qkv_sites() == 60
    assert pqs.qkv_sites(PriorConfig.tiny()) == 2 * (1 + 2)


# --- int8_study ------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.0])
def test_quantizer_equals_quant_int8(jstudy, scale):
    """The port's `quant_int8` against `_quant_int8` bit for bit: the
    int8 values and the fp32 scale; values at half steps included."""
    rng = np.random.default_rng(7)
    x = _f32(rng, 64, 48, scale=scale)
    amax = np.abs(x).max()
    x[0, :8] = (np.arange(8) + 0.5) * (amax / 127.0)  # ties to even
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        tx = torch.from_numpy(x).to(dtype)
        jq, js = jstudy.int8._quant_int8(
            jnp.asarray(tx.float().numpy()).astype(jdt))
        q, s = pis.quant_int8(tx)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)


def test_int8_products_match_the_float_product():
    """Items 1, 3 and 4 on the CPU (the exact int32 product of
    `int_matmul`): within the study's int8 tolerance of the fp32 product,
    and the score and P.V loops equal one batched product of the same
    int8 operands."""
    g = torch.Generator().manual_seed(8)
    a = torch.randn(48, 64, generator=g).bfloat16()
    w = (torch.randn(64, 40, generator=g) * 0.125).bfloat16()
    w_q, w_s = pis.quant_int8(w)
    ref = a.float() @ w.float()
    assert ((pis.dot_i8(a, w_q, w_s).float() - ref).abs().max()
            / ref.abs().max()) <= pis.TOL["int8"]
    qm = torch.randn(2, 24, 8, generator=g).bfloat16()
    km = torch.randn(2, 32, 8, generator=g).bfloat16()
    kq8, ks = pis.quant_int8(km)
    out = pis.score_i8(qm, kq8.transpose(1, 2).contiguous(), ks)
    q8, s = pis.quant_int8(qm)
    want = (torch.bmm(q8.int(), kq8.int().transpose(1, 2)).float()
            * (s * ks)).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    p = torch.rand(2, 24, 32, generator=g).bfloat16()
    vt = torch.randn(2, 8, 32, generator=g).bfloat16()
    vq8, vs = pis.quant_int8(vt)
    out = pis.pv_i8(p, vq8.transpose(1, 2).contiguous(), vs)
    ref = torch.bmm(p.float(), vt.float().transpose(1, 2))
    assert (out.float() - ref).abs().max() / ref.abs().max() \
        <= pis.TOL["int8"]


# --- the plan override --------------------------------------------------


# every FF site's default plan, taken when this module is imported
_DEFAULTS = {site: geglu._plan(site[0], site[1], 4 * site[1], site[2])
             for site in FF_SITES}


def test_library_widths_are_the_kernels_instances():
    """`LIBRARY_WIDTHS` is `dispatch_gemm`'s list of instances in
    `csrc/ff.cu`; the default plans' widths are among them."""
    modes = {"kGeglu": "geglu", "kGelu": "gelu", "kBias": "bias"}
    found = {}
    for mode, bn in re.findall(r"RCDMS_GEMM_CASE\((k\w+), (\d+)\)",
                               FF_CU.read_text()):
        found.setdefault(modes[mode], []).append(int(bn))
    assert {m: tuple(sorted(v)) for m, v in found.items()} == \
        geglu.LIBRARY_WIDTHS
    for mode, widths in geglu.TILE_WIDTHS.items():
        assert set(widths) <= set(geglu.LIBRARY_WIDTHS[mode])
    assert set(geglu.PASS_MODES["pass1"]) | set(
        geglu.PASS_MODES["pass2"]) == set(geglu.LIBRARY_WIDTHS)


@pytest.mark.parametrize("rows,c,geglu_", FF_SITES)
def test_override_plans_and_their_smem(rows, c, geglu_):
    """Every (pass-1, pass-2) tile pair of the library at every FF site:
    the plan takes the tiles, its grid covers the output, and its shared
    memory is the kernel's layout (`GemmShape::BYTES`) within one
    block's."""
    inner = 4 * c
    mode = "geglu" if geglu_ else "gelu"
    nw = 2 if geglu_ else 1
    for bn1 in geglu.LIBRARY_WIDTHS[mode]:
        for bn2 in geglu.LIBRARY_WIDTHS["bias"]:
            geglu.set_plan_override(bn1, bn2)
            plan = geglu._plan(rows, c, inner, geglu_)
            for name, n, bn, w in (("pass1", inner, bn1, nw),
                                   ("pass2", c, bn2, 1)):
                p = plan[name]
                assert p["bn"] == bn and p["bm"] == 128
                assert p["grid"] == (-(-n // bn), -(-rows // 128))
                stage = 128 * 64 * 2 + w * bn * 64 * 2
                assert p["smem"] == 4 * stage + 2 * 4 * 8 + 1024
                assert p["smem"] <= SMEM_LIMIT
                assert bn * 64 * 2 % 1024 == 0  # tiles stay 1024-aligned


def test_override_of_one_pass_keeps_the_others_default():
    default = geglu._plan(20480, 320, 1280, True)
    geglu.set_plan_override(64)
    plan = geglu._plan(20480, 320, 1280, True)
    assert plan["pass1"]["bn"] == 64 and plan["pass2"] == default["pass2"]
    geglu.set_plan_override(None, 96)
    plan = geglu._plan(20480, 320, 1280, True)
    assert plan["pass1"] == default["pass1"] and plan["pass2"]["bn"] == 96


@pytest.mark.parametrize("override", [(40, None), (None, 48), (8, None),
                                      (None, 320), (0, 64)])
def test_override_refuses_a_width_the_library_lacks(override):
    with pytest.raises(ValueError):
        geglu.set_plan_override(*override)
    assert geglu._plan(970, 2048, 8192, True) == _DEFAULTS[(970, 2048, True)]


@pytest.mark.parametrize("bn,geglu_", [(32, False), (96, False),
                                       (192, True), (256, True)])
def test_plan_refuses_a_width_its_mode_lacks(bn, geglu_):
    """A pass-1 width of the other activation's instances: `_plan` raises
    before any launch."""
    geglu.set_plan_override(bn)
    with pytest.raises(ValueError):
        geglu._plan(970, 2048, 8192, geglu_)


def test_default_plans_return_after_a_reset():
    """Every FF site's plan after an override and a reset is the plan
    before it (taken when this module was imported), and none is
    overridden by the environment: the hook is a function only."""
    geglu.set_plan_override(None, 32)
    assert all(geglu._plan(r, c, 4 * c, g) != _DEFAULTS[(r, c, g)]
               for r, c, g in FF_SITES)
    geglu.set_plan_override(None)
    for (r, c, g), plan in _DEFAULTS.items():
        assert geglu._plan(r, c, 4 * c, g) == plan
    assert "environ" not in inspect.getsource(geglu)


# --- the studies need a card -------------------------------------------------


@pytest.mark.parametrize("study", [pgs, pps, pfs, pqs, pis])
def test_studies_refuse_the_cpu(study):
    with pytest.raises(RuntimeError):
        study.run(torch.device("cpu"))
