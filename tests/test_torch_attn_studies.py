"""The port's small-head-dim attention kernels (`rcdms_tpu_torch/ops/
smallk.py`: E-H) and studies against the JAX studies' Pallas kernel bodies
on the CPU, on the same numpy inputs: every row of
`tools/flash_smallk_study.py`, `tools/pv_overlap_study.py` and
`tools/pv_softmax_study.py` (19 rows).

The JAX studies have no interpret switch, so each kernel body runs here in
its own `pl.pallas_call(..., interpret=True)` with the study's block shapes
and index maps, at B = 1-2 batch rows and one or two 512-row q cells; Skv =
4096 and dh = 40 stay as the module constants fix them. `run_isolated`'s
kernels are closures: they are taken from the function's source with
`ast` and run in the study module's namespace. `pv_softmax_study.py` runs
its benchmarks when imported, so no test imports it: its `k_*` bodies and
its constant line are taken the same way. On the CPU each port wrapper runs
its plain PyTorch version; tests/test_torch_cuda.py holds the kernels.

Each interpret-mode call is compiled with XLA's excess precision off
(`xla_allow_excess_precision`), so that the JAX side rounds to bf16 where
a kernel body says so, as the TPU does: with it on, XLA drops the rounding
of the generated P before `.astype(float32)` in run_isolated's k_softmax,
and exp over scores up to about 100 magnifies the difference to a few
percent.

Tolerances: E's output is bf16 and both sides round p and o to bf16 with
sums in another order: max|diff| <= 1e-2 * max|ref|. F-H give fp32 from
the same bf16 operands, differing in summation order: <= 1e-4 * max|ref|.
The generated P tile: exact."""

import ast
import importlib
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rcdms_tpu_torch import ops
from rcdms_tpu_torch.ops import smallk as sk
from rcdms_tpu_torch.tools import attn_parts_device_times as apdt
from rcdms_tpu_torch.tools import flash_smallk_study as pfs
from rcdms_tpu_torch.tools import pv_overlap_study as pos
from rcdms_tpu_torch.tools import pv_softmax_study as pps
from rcdms_tpu_torch.tools import smallk_device_times as sdt
from rcdms_tpu_torch.tools.sass_mix import inner_loops, instruction_mix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL, F32_REL = 1e-2, 1e-4
BLK, SKV, DH, GROUP = 512, 4096, 40, 128
_CACHE_SETTINGS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")


def _defs(path, keep, namespace):
    """Exec the top-level statements of `path` (or of one function's body,
    keep=(name, pick)) that `pick` selects, in a copy of `namespace`."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    func, pick = keep
    body = tree.body if func is None else next(
        n for n in tree.body
        if isinstance(n, ast.FunctionDef) and n.name == func).body
    ns = dict(namespace)
    exec(compile(ast.Module(body=[n for n in body if pick(n)],
                            type_ignores=[]), path, "exec"), ns)
    return types.SimpleNamespace(**ns)


def _is_def(node):
    return isinstance(node, ast.FunctionDef)


def _is_kernel_or_constants(node):
    """pv_softmax_study's k_* bodies and its line of constants."""
    if isinstance(node, ast.FunctionDef):
        return node.name.startswith("k_")
    return isinstance(node, ast.Assign) and isinstance(
        node.value, ast.Tuple) and all(
        isinstance(e, ast.Constant) for e in node.value.elts)


@pytest.fixture(scope="module")
def jstudy():
    """The JAX studies. flash_smallk_study and pv_overlap_study set two
    global JAX compile-cache settings when imported; they are saved and
    restored so that nothing leaks into the tests that share this
    process."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    try:
        fs = importlib.import_module("tools.flash_smallk_study")
        po = importlib.import_module("tools.pv_overlap_study")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    iso = _defs(fs.__file__, ("run_isolated", _is_def), vars(fs))
    ps = _defs(os.path.join(REPO, "tools", "pv_softmax_study.py"),
               (None, _is_kernel_or_constants), {"jax": jax, "jnp": jnp})
    return types.SimpleNamespace(fs=fs, po=po, iso=iso, ps=ps,
                                 settings_before=saved)


def _bf16(rng, *shape, uniform=False, scale=1.0):
    """Seeded values, rounded to bf16 alike on both sides: (jax, torch)."""
    x = (rng.uniform(size=shape) if uniform
         else rng.standard_normal(shape)) * scale
    x = x.astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _close(out, ref, rel):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _strict(call, *args):
    """Run `call` jitted with excess precision off (module docstring)."""
    return jax.jit(call).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _jax_block(kernel, q, k, v, channel_major):
    """A whole-block kernel body over (B, Sq) in the study's blocks: one
    (batch row, 512-row q cell) a step, the whole K and V row."""
    b = q.shape[0]
    if channel_major:
        sq = q.shape[2]
        qspec = pl.BlockSpec((1, DH, BLK), lambda b_, i: (b_, 0, i))
        kvspec = pl.BlockSpec((1, DH, SKV), lambda b_, i: (b_, 0, 0))
        out_shape = (b, DH, sq)
    else:
        sq, d = q.shape[1], q.shape[2]
        qspec = pl.BlockSpec((1, BLK, d), lambda b_, i: (b_, i, 0))
        kvspec = pl.BlockSpec((1, SKV, d), lambda b_, i: (b_, 0, 0))
        out_shape = (b, sq, d)
    return _strict(pl.pallas_call(
        kernel, grid=(b, sq // BLK), in_specs=[qspec, kvspec, kvspec],
        out_specs=qspec,
        out_shape=jax.ShapeDtypeStruct(out_shape, q.dtype),
        interpret=True), q, k, v)


def _jax_iso(kernel, a, a_tile, a_index, b, b_tile, cells):
    """An isolated-part kernel body (the study's `_iso_call`, `_iso_gen`
    and `bench` blocks) over `cells` 512-row cells of each batch row; out
    (B, cells * 512, 128) fp32."""
    n = a.shape[0]
    return _strict(pl.pallas_call(
        kernel, grid=(n, cells),
        in_specs=[pl.BlockSpec((1,) + a_tile, a_index),
                  pl.BlockSpec((1,) + b_tile, lambda b_, i: (b_, 0, 0))],
        out_specs=pl.BlockSpec((1, BLK, GROUP), lambda b_, i: (b_, i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, cells * BLK, GROUP), jnp.float32),
        interpret=True), a, b)


def _cell0(b_, i):
    return (b_, 0, 0)


def test_constants_match_the_jax_studies(jstudy):
    fs, po, ps = jstudy.fs, jstudy.po, jstudy.ps
    assert (pfs.B, pfs.SQ, pfs.SKV, pfs.DH, pfs.GROUP, pfs.BLK_Q) == (
        fs.B, fs.SQ, fs.SKV, fs.DH, fs.GROUP, fs.BLK_Q)
    assert (pos.B, pos.SQ, pos.SKV, pos.DH, pos.BLK_Q) == (
        po.B, po.SQ, po.SKV, po.DH, po.BLK_Q)
    assert (pps.B, pps.SKV, pps.DH, pps.GROUP, pps.BLK, pps.CELLS) == (
        ps.B, ps.SKV, ps.DH, ps.GROUP, ps.BLK, ps.CELLS)
    assert pfs.SCALE == fs.SCALE == pos.SCALE == po.SCALE
    assert (sk.BLK, sk.GROUP) == (BLK, GROUP) == (fs.BLK_Q, fs.GROUP)
    now = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    assert now == jstudy.settings_before


# --- E: whole blocks -------------------------------------------------------


@pytest.mark.parametrize("name", ["base128", "slice40", "nt40", "nt_t40"])
def test_flash_smallk_block_rows_match(jstudy, name):
    """flash_smallk's whole-block rows: base128 and slice40 over (B, S,
    128) operands zero past 40 (as the study's main makes them), nt40 and
    nt_t40 channel-major; 2 batch rows x 1 cell, 1 x 2 cells."""
    kw = dict(pfs.BLOCK_ROWS)[name]
    cm = kw.get("channel_major", False)
    for b, sq in ((2, BLK), (1, 2 * BLK)):
        rng = np.random.default_rng(sq + b)
        (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng, b, DH, n)
                                        for n in (sq, SKV, SKV))
        if not cm:
            jq, jk, jv = (jnp.pad(jnp.swapaxes(t, 1, 2),
                                  ((0, 0), (0, 0), (0, GROUP - DH)))
                          for t in (jq, jk, jv))
            tq, tk, tv = (torch.nn.functional.pad(
                t.transpose(1, 2), (0, GROUP - DH)).contiguous()
                for t in (tq, tk, tv))
        ref = _jax_block(getattr(jstudy.fs, f"_kernel_{name}"), jq, jk, jv,
                         cm)
        out = sk.smallk_attention(tq, tk, tv, pfs.SCALE, **kw)
        assert out.shape == ref.shape and out.dtype == torch.bfloat16
        _close(out, ref.astype(jnp.float32), BF16_REL)


@pytest.mark.parametrize("name", ["base", "split2", "split4", "dscore"])
def test_pv_overlap_rows_match(jstudy, name):
    """pv_overlap's rows (channel-major, l from the rounded p) at 1 batch
    row x 2 cells; each also within the study's 0.02 of its fp32 oracle."""
    po = jstudy.po
    kernel = {"base": po._kernel_base, "dscore": po._kernel_dscore,
              "split2": po._make_split_kernel(2),
              "split4": po._make_split_kernel(4)}[name]
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng, 1, DH, n)
                                    for n in (2 * BLK, SKV, SKV))
    ref = _jax_block(kernel, jq, jk, jv, True)
    out = sk.smallk_attention(tq, tk, tv, pos.SCALE, channel_major=True,
                              norm="rounded", **pos.ROWS[name])
    _close(out, ref.astype(jnp.float32), BF16_REL)
    assert (out.float() - pos.oracle(tq, tk, tv)).abs().max() \
        <= pos.MAX_ABS_ERR


def test_overlap_oracle_matches_jax_oracle():
    """The port study's `oracle` is the JAX study's oracle_fn (fp32)."""
    rng = np.random.default_rng(12)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng, 1, DH, n)
                                    for n in (BLK, SKV, SKV))
    s = jnp.einsum("bdq,bdk->bqk", jq.astype(jnp.float32),
                   jk.astype(jnp.float32)) * pos.SCALE
    ref = jnp.einsum("bqk,bdk->bdq", jax.nn.softmax(s, axis=-1),
                     jv.astype(jnp.float32))
    _close(pos.oracle(tq, tk, tv), ref, F32_REL)


# --- F: scores ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["score_base", "score_nt"])
def test_score_rows_match(jstudy, name):
    """run_isolated's score kernels (with `redsum`) at 2 batch rows x 2
    cells; q and k random over all 128 columns, as the study draws them."""
    cm = name == "score_nt"
    rng = np.random.default_rng(13)
    if cm:
        (jq, tq), (jk, tk) = _bf16(rng, 2, DH, 2 * BLK), _bf16(rng, 2, DH, SKV)
        a_tile, a_index, b_tile = (DH, BLK), (lambda b_, i: (b_, 0, i)), (
            DH, SKV)
    else:
        (jq, tq), (jk, tk) = (_bf16(rng, 2, 2 * BLK, GROUP),
                              _bf16(rng, 2, SKV, GROUP))
        a_tile, a_index, b_tile = (BLK, GROUP), (lambda b_, i: (b_, i, 0)), (
            SKV, GROUP)
    ref = _jax_iso(getattr(jstudy.iso, f"k_{name}"), jq, a_tile, a_index, jk,
                   b_tile, 2)
    _close(sk.attn_scores(tq, tk, channel_major=cm), ref, F32_REL)


# --- G and H over generated P ---------------------------------------------


def test_gen_p_is_exact(jstudy):
    rng = np.random.default_rng(14)
    jd, td = _bf16(rng, 2, 8, 128)
    for b in range(2):
        ref = np.asarray(jstudy.iso.gen_p(jd[b, 0, 0]).astype(jnp.float32))
        np.testing.assert_array_equal(
            sk.gen_p(td[b:b + 1], BLK, SKV)[0].float().numpy(), ref)


@pytest.mark.parametrize("name", ["pv_base", "pv_narrow", "pv_nt",
                                  "softmax"])
def test_generated_p_rows_match(jstudy, name):
    """run_isolated's PV and softmax kernels over generated P, at 2 batch
    rows x 2 cells (the P tile depends only on the batch row's scalar and
    the row within its cell)."""
    rng = np.random.default_rng(15)
    jd, td = _bf16(rng, 2, 8, 128)
    jv, tv = _bf16(rng, 2, SKV, GROUP)
    if name == "pv_narrow" or name == "softmax":
        jv, tv = jv[..., :DH], tv[..., :DH].contiguous()
    cm = name == "pv_nt"
    if cm:
        jv, tv = jnp.swapaxes(jv[..., :DH], 1, 2), \
            tv[..., :DH].transpose(1, 2).contiguous()
    ref = _jax_iso(getattr(jstudy.iso, f"k_{name}"), jd, (8, 128), _cell0,
                   jv, tuple(jv.shape[1:]), 2)
    if name == "softmax":
        out = sk.attn_softmax(seeds=td, skv=SKV, cells=2)
    else:
        out = sk.attn_pv(tv, seeds=td, channel_major=cm, cells=2)
    _close(out, ref, F32_REL)


# --- G and H over an input P (pv_softmax_study) ------------------------------


@pytest.mark.parametrize("name", ["pv_lanes", "pv_std", "softmax",
                                  "softmax2", "reduce_only"])
def test_pv_softmax_rows_match(jstudy, name):
    """pv_softmax_study's kernels, one (512, 4096) P block per batch row
    read by both cells of the row, at 2 batch rows x 2 cells."""
    rng = np.random.default_rng(16)
    jp, tp = _bf16(rng, 2, BLK, SKV, uniform=True, scale=0.001)
    jvt, tvt = _bf16(rng, 2, DH, SKV)
    jv, tv = _bf16(rng, 2, SKV, GROUP)
    body = {"reduce_only": "k_noop"}.get(name, f"k_{name}")
    jb, b_tile = (jv, (SKV, GROUP)) if name == "pv_std" else (jvt, (DH, SKV))
    ref = _jax_iso(getattr(jstudy.ps, body), jp, (BLK, SKV), _cell0, jb,
                   b_tile, 2)
    if name == "pv_lanes":
        out = sk.attn_pv(tvt, p=tp, channel_major=True, cells=2)
    elif name == "pv_std":
        out = sk.attn_pv(tv, p=tp, cells=2)
    else:
        op = {"softmax": "exp", "softmax2": "exp2", "reduce_only": "sum"}
        out = sk.attn_softmax(p=tp, op=op[name], scale=pps.SOFTMAX_SCALE,
                              cells=2)
    _close(out, ref, F32_REL)


# --- the wrappers and the studies' contract --------------------------------


def test_plain_split_and_dscore_agree_with_base():
    """split changes no number; dscore only the product that forms p."""
    g = torch.Generator().manual_seed(17)
    q, k, v = (torch.randn(1, DH, n, generator=g).bfloat16()
               for n in (BLK, 1024, 1024))
    base = sk.smallk_attention(q, k, v, 0.2, channel_major=True,
                               norm="rounded")
    for split in (2, 4):
        assert torch.equal(base, sk.smallk_attention(
            q, k, v, 0.2, channel_major=True, norm="rounded", split=split))
    d = sk.smallk_attention(q, k, v, 0.2, channel_major=True, norm="rounded",
                            dscore=True)
    assert (d.float() - base.float()).abs().max() <= 1e-2


@pytest.mark.parametrize("call", [
    # not a study variant
    lambda t, c: sk.smallk_attention(t, t, t, 1.0, split=2),
    lambda t, c: sk.smallk_attention(c, c, c, 1.0, channel_major=True),
    lambda t, c: sk.smallk_attention(c, c, c, 1.0, channel_major=True,
                                     norm="pre", dscore=True),
    # misshaped operands
    lambda t, c: sk.smallk_attention(t, t[:, :, :64], t, 1.0),
    lambda t, c: sk.smallk_attention(t, t, t, 1.0, dk=200),
    lambda t, c: sk.attn_scores(c, t, channel_major=True),
    lambda t, c: sk.attn_scores(t[:, :, :40], t[:, :100, :40]),
    lambda t, c: sk.attn_pv(t, seeds=torch.zeros(2, 8, 128)),
    lambda t, c: sk.attn_pv(t),
    lambda t, c: sk.attn_pv(c, p=torch.zeros(1, 512, 100),
                            channel_major=True),
    lambda t, c: sk.attn_softmax(seeds=torch.zeros(1, 8, 128)),
    lambda t, c: sk.attn_softmax(p=torch.zeros(1, 512, 100)),
    lambda t, c: sk.attn_softmax(p=torch.zeros(1, 512, 128), op="max"),
])
def test_wrappers_reject_bad_variants_and_shapes(call):
    t = torch.zeros(1, 256, 128, dtype=torch.bfloat16)
    c = torch.zeros(1, 40, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        call(t, c)


def test_cpu_smallk_wrappers_do_not_count():
    ops.reset_launch_counts()
    c = torch.zeros(1, 40, 512, dtype=torch.bfloat16)
    sk.smallk_attention(c, c, c, 1.0, channel_major=True, norm="pre")
    sk.attn_scores(c, c, channel_major=True)
    seeds = torch.ones(1, 8, 128, dtype=torch.bfloat16)
    sk.attn_pv(c, seeds=seeds, channel_major=True, cells=1)
    sk.attn_softmax(seeds=seeds, skv=512, cells=1)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("study", [pfs, pos, pps])
def test_attention_studies_refuse_the_cpu(study):
    with pytest.raises(RuntimeError):
        study.run(torch.device("cpu"))


_QUIET_IMPORT = """
import torch

def _refuse(*a, **k):
    raise AssertionError("{module} made a tensor when imported")

for name in ("rand", "randn", "empty", "zeros", "ones", "full", "tensor"):
    setattr(torch, name, _refuse)
import rcdms_tpu_torch.tools.{module} as m
assert callable(m.run) and callable(m.main)
print("ok")
"""


def _import_quietly(module):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _QUIET_IMPORT.format(module=module)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"


def test_pv_softmax_study_import_does_no_work():
    _import_quietly("pv_softmax_study")


def test_attn_parts_device_times_refuses_the_cpu():
    """The F-H timing tool measures the card: no CPU path."""
    with pytest.raises(RuntimeError):
        apdt.run(torch.device("cpu"))


def test_attn_parts_device_times_refuses_the_cpu_for_one_kernel():
    with pytest.raises(RuntimeError):
        apdt.run(torch.device("cpu"), "attn_softmax")


def test_attn_parts_device_times_import_does_no_work():
    _import_quietly("attn_parts_device_times")


def _main_with_parent(monkeypatch, tool, tmp_path, *flags):
    """Run a timing tool's `main` with `--parent` as on a card (the card's
    presence and line faked); returns the JSON it wrote."""
    out = tmp_path / "turns.json"
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tool, "card_line", lambda: "card")
    monkeypatch.setattr(sys, "argv", [tool.__file__, "--parent",
                                      str(tmp_path / "parent"), "--out",
                                      str(out), *flags])
    tool.main()
    with open(out) as fh:
        return json.load(fh)


def test_attn_parts_device_times_turns_run_each_checkouts_own_module(
        monkeypatch, tmp_path):
    """`--parent`: parent, change, change, parent, each that checkout's own
    module (`-m`, from its root, on its path), its rows matched to the
    change's by kernel and variant whatever their order, and kept to one
    kernel's where asked."""
    parent = tmp_path / "parent"
    parent.mkdir()
    calls = []

    def row(kernel, variant, ms):
        return dict(kernel=kernel, variant=variant, device_ms=ms,
                    bound_ms=0.3)

    def fake_run(cmd, cwd, check, env):
        calls.append((cmd, cwd, env["PYTHONPATH"]))
        old = cwd == str(parent)
        rows = ([row("attn_softmax", "softmax", 0.7),
                 row("attn_scores", "score_nt", 1.0),
                 row("attn_softmax", "softmax gen", 1.5)] if old else
                [row("attn_softmax", "softmax gen", 0.42),
                 row("attn_softmax", "softmax", 0.40)])
        with open(cmd[cmd.index("--out") + 1], "w") as fh:
            json.dump(dict(card="card", rows=rows), fh)

    monkeypatch.setattr(subprocess, "run", fake_run)
    out = _main_with_parent(monkeypatch, apdt, tmp_path, "--kernel",
                            "attn_softmax")["turns"]
    assert [t["label"] for t in out] == ["parent", "change", "change",
                                         "parent"]
    assert [c[1] for c in calls] == [str(parent), REPO, REPO, str(parent)]
    for cmd, cwd, path in calls:
        assert cmd[1:3] == ["-m", apdt.MODULE] and path == cwd
    assert [r["variant"] for r in out[0]["rows"]] == ["softmax",
                                                      "softmax gen"]


def test_smallk_device_times_refuses_the_cpu():
    """E's timing tool measures the card: no CPU path."""
    with pytest.raises(RuntimeError):
        sdt.run(torch.device("cpu"))


def test_smallk_device_times_import_does_no_work():
    _import_quietly("smallk_device_times")


def test_smallk_device_times_rows_are_the_studies():
    """The seven rows are the studies' whole-block variants, as the
    wrapper takes them, and nt40 alone is "pre"."""
    assert [name for name, _ in sdt.ROWS] == [
        "base128", "slice40", "nt40", "nt_t40", "split2", "split4",
        "dscore"]
    for name, kw in sdt.ROWS:
        key = (kw.get("channel_major", False), kw["norm"],
               kw.get("split", 1), kw.get("dscore", False))
        assert key in sk.SMALLK_VARIANTS, name
        assert (kw["norm"] == "pre") == (name == "nt40")


def test_smallk_device_times_turns_run_this_file_in_each_checkout(
        monkeypatch, tmp_path):
    """`--parent`: parent, change, change, parent, each this file run by
    path from that checkout's root with that checkout on the path (a
    parent without the tool is timed the same way), its rows matched to
    the change's by name whatever their order."""
    parent = tmp_path / "parent"
    parent.mkdir()
    calls = []

    def fake_run(cmd, cwd, check, env):
        calls.append((cmd, cwd, env["PYTHONPATH"]))
        ms = 1.3 if cwd == str(parent) else 0.9
        rows = [dict(row="nt_t40", device_ms=ms, bound_ms=0.32),
                dict(row="base128", device_ms=3 * ms, bound_ms=0.32)]
        with open(cmd[cmd.index("--out") + 1], "w") as fh:
            json.dump(dict(card="card", rows=rows[::1 if ms > 1 else -1]),
                      fh)

    monkeypatch.setattr(subprocess, "run", fake_run)
    out = _main_with_parent(monkeypatch, sdt, tmp_path)["turns"]
    assert [t["label"] for t in out] == ["parent", "change", "change",
                                         "parent"]
    assert [c[1] for c in calls] == [str(parent), REPO, REPO, str(parent)]
    for cmd, cwd, path in calls:
        assert cmd[1] == os.path.abspath(sdt.__file__) and path == cwd
    assert [r["row"] for r in out[0]["rows"]] == ["nt_t40", "base128"]


@pytest.mark.parametrize("dh", [16, 40, 48])
def test_smallk_device_times_operands_and_work(dh):
    """The token-major copies are the channel-major operands transposed
    and zero past dh to 128 columns; SDPA's are base128's tensors and the
    unpadded ones; the work is what phase 3 bounds every row by: the score
    and P V products at dh, one exponential a score (nt40's second is the
    two-pass design's own), q, k, v read and o written once."""
    g = torch.Generator().manual_seed(dh)
    b, sq, skv = 3, 128, 64
    qt, kt, vt = (torch.randn(b, dh, s, generator=g).bfloat16()
                  for s in (sq, skv, skv))
    tok, sdpa = sdt.operands(qt, kt, vt)
    for t, c in zip(tok, (qt, kt, vt)):
        assert t.shape == (b, c.shape[2], sdt.WIDTH) and t.is_contiguous()
        assert torch.equal(t[..., :dh], c.transpose(1, 2))
        assert not t[..., dh:].any()
    assert set(sdpa) == set(sdt.SDPA_ROWS)
    assert all(torch.equal(s[:, 0], t) for s, t in zip(sdpa["base128"], tok))
    assert all(torch.equal(s[:, 0], c.transpose(1, 2))
               for s, c in zip(sdpa["nt_t40"], (qt, kt, vt)))
    assert sdt.work(qt, skv) == (4 * b * sq * skv * dh, b * sq * skv,
                                 4 * b * dh * sq * 2)
    assert [kw.get("dk") for _, kw in sdt.rows(dh)][:2] == [sdt.WIDTH, dh]


_SASS = """
        Function : _Z3expv
        /*0000*/                   FADD R2, R2, -R3 ;
        /*0010*/                   FMUL R2, R2, 1.4426950216293334961 ;
        /*0020*/              @!P0 MUFU.EX2 R2, R2 ;
        /*0030*/                   FFMA.FTZ R4, R2, R5, R4 ;
        /*0040*/                   EXIT ;
        Function : _Z3mmav
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   MUFU.RCP R2, R3 ;
        Function : _Z5wgmmav
        /*0000*/                   WARPGROUP.ARRIVE ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def test_sass_mix_counts_opcodes():
    mix = instruction_mix(_SASS)
    assert mix["_Z3expv"] == {"FADD": 1, "FMUL": 1, "MUFU.EX2": 1,
                              "FFMA": 1, "total": 5}
    assert mix["_Z3mmav"] == {"HMMA": 1, "total": 2}
    assert mix["_Z5wgmmav"] == {"HGMMA": 1, "total": 2}


_SASS_COPIES = """
        Function : _Z5framev
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   HMUL2.BF16_V2 R6, R4, R5 ;
        /*0030*/                   STS.128 [R2], R4 ;
        /*0040*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
        /*0050*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R6.64] ;
"""


def test_sass_mix_counts_copies_and_shuffles():
    """The opcodes that tell kernel B's tiled kernel from its general one:
    bulk copies and bf16x2 products against shuffles."""
    mix = instruction_mix(_SASS_COPIES)["_Z5framev"]
    assert mix == {"UBLKCP": 1, "LDS": 1, "HMUL2": 1, "STS": 1, "SHFL": 1,
                   "LDGSTS": 1, "total": 6}


_SASS_LOOPS = """
        Function : _Z3rowv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   VHMNMX R6, R4, R5, R6, !PT ;
        /*0030*/              @!P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0040*/                   LDS.128 R4, [R2] ;
        /*0050*/                   FFMA R5, R4, R3, R2 ;
        /*0060*/                   MUFU.EX2 R5, R5 ;
        /*0070*/                   FADD R8, R8, R5 ;
        /*0080*/               @P1 BRA 0x40 ;
        /*0090*/                   BRA 0x0 ;
        /*00a0*/                   EXIT ;
.L_x_3:
        /*00b0*/                   BRA `(.L_x_3) ;
"""


def test_sass_mix_finds_inner_loops():
    """A backward branch, by label or by address, spans a loop; the
    innermost ones are kept (not the outer loop holding both, nor the
    trap's branch to itself)."""
    loops = inner_loops(_SASS_LOOPS)["_Z3rowv"]
    assert [(lo, hi) for lo, hi, _, _ in loops] == [(0x10, 0x30),
                                                    (0x40, 0x80)]
    assert loops[0][3] == {"LDS": 1, "VHMNMX": 1, "BRA": 1}
    assert loops[0][2] == {"LDS": 1, "VHMNMX": 1, "total": 3}
    assert loops[1][2] == {"LDS": 1, "FFMA": 1, "MUFU.EX2": 1, "FADD": 1,
                           "total": 5}
    assert instruction_mix(_SASS_LOOPS)["_Z3rowv"]["total"] == 12
