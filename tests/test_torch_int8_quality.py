"""The port's int8 quality tool (rcdms_tpu_torch/tools/int8_quality.py)
against the JAX package's (`tools/int8_quality.py`) on the CPU.

* `--tiny --encprop --device cpu` prints JSON with every key of the JAX
  tool's (read from the JAX tool's source: its `out` dict and the
  encprop2_vs_bf16 row), the int8 and k = 2 runs engage (the tool raises
  otherwise), and int8 stays nearer bf16 than the unrelated story does;
* `latent_metrics` equals the JAX tool's (its source, run as it is) on
  the same arrays, and the report's rows are its rounding of them;
* the weights follow the JAX recipe: >= 2-d weights of std
  1/sqrt(fan in), norm scales 1, biases 0, all bf16 values;
* --device cuda without a card raises.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from rcdms_tpu_torch.tools import int8_quality
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

JAX_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "int8_quality.py")


def _jax_main():
    with open(JAX_TOOL) as fh:
        source = fh.read()
    tree = ast.parse(source)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    return source, main


def _keys(node) -> dict:
    """The string keys of a dict literal, nested dicts as dicts."""
    return {k.value: _keys(v) if isinstance(v, ast.Dict) else None
            for k, v in zip(node.keys, node.values)}


def jax_report_keys() -> dict:
    """The keys of the JAX tool's JSON: its `out = {...}` and the
    `out["encprop2_vs_bf16"] = {...}` it adds under --encprop."""
    _, main = _jax_main()
    keys = {}
    for n in ast.walk(main):
        if not isinstance(n, ast.Assign) or not isinstance(n.value,
                                                           ast.Dict):
            continue
        target = n.targets[0]
        if isinstance(target, ast.Name) and target.id == "out":
            keys.update(_keys(n.value))
        elif isinstance(target, ast.Subscript) and isinstance(
                target.value, ast.Name) and target.value.id == "out":
            keys[target.slice.value] = _keys(n.value)
    assert {"config", "int8_vs_bf16", "unrelated_bf16_noise_floor",
            "encprop2_vs_bf16"} <= set(keys)
    return keys


def jax_latent_metrics():
    """The JAX tool's `latent_metrics`, defined from its own source."""
    source, main = _jax_main()
    fn = next(n for n in ast.walk(main) if isinstance(n, ast.FunctionDef)
              and n.name == "latent_metrics")
    lines = ast.get_source_segment(source, fn).splitlines()
    # the nested def dedented to module level
    indent = len(lines[0]) - len(lines[0].lstrip())
    code = "\n".join(line[indent:] for line in lines)
    ns = {"np": np}
    exec(code, ns)
    return ns["latent_metrics"]


def _shape(d):
    return {k: _shape(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.fixture(scope="module")
def tiny_report():
    """The printed JSON of `--tiny --encprop --device cpu`."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = int8_quality.main(["--tiny", "--encprop", "--device", "cpu"])
    printed = json.loads(buf.getvalue())
    assert printed == out
    return printed


def test_tiny_report_has_every_jax_key(tiny_report):
    assert _shape(tiny_report) == jax_report_keys()
    assert tiny_report["config"] == "tiny"
    q, floor = tiny_report["int8_vs_bf16"], tiny_report[
        "unrelated_bf16_noise_floor"]
    for row in (q, tiny_report["encprop2_vs_bf16"]):
        assert len(row["ssim_per_frame"]) == len(
            row["latent_cos_per_frame"]) == 5
        assert 0 < row["latent_rel_rms"] and row["ssim_min"] < 1.0
        assert all(np.isfinite(row["ssim_per_frame"]))
    assert q["ssim_mean"] > floor["ssim_mean"]
    assert q["latent_rel_rms"] < floor["latent_rel_rms"]


def test_latent_metrics_equal_the_jax_formulas():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((1, 5, 8, 8, 4)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    want = jax_latent_metrics()(a, b)
    got = int8_quality.latent_metrics(a, b)
    assert got == want
    frames = rng.uniform(0, 1, (5, 16, 16, 3))
    row = int8_quality.delta(a, frames, b, frames)
    assert row["latent_rel_rms"] == round(want[0], 4)
    assert row["latent_cos_per_frame"] == [round(c, 4) for c in want[1]]
    assert row["ssim_per_frame"] == [1.0] * 5


def test_weights_follow_the_jax_recipe():
    rig = int8_quality.build(tiny=True, device="cpu")
    unet = rig.sampler.unet
    for name, p in list(unet.named_parameters()) + list(
            rig.sampler.fusion.named_parameters()):
        assert torch.equal(p, p.to(torch.bfloat16).to(p.dtype)), name
        if p.dim() >= 2:
            fan_in = int(np.prod(p.shape[1:]))
            if p.numel() >= 4096:
                std = p.float().std().item() * np.sqrt(fan_in)
                assert 0.9 < std < 1.1, (name, std)
        else:
            want = 1.0 if name.endswith("weight") else 0.0
            assert (p == want).all(), name
    # the temporal modules' output projections are drawn, not zero
    outs = [p for n, p in unet.named_parameters()
            if "motion_modules" in n and n.endswith("proj_out.weight")]
    assert outs and all(p.abs().sum() > 0 for p in outs)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        int8_quality.main(["--tiny"])
