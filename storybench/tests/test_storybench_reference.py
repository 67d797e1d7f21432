"""The plain reference against the port at a tiny size on the CPU, and the
control (the reference's products in fp8) failing the cells' limits."""

import ast
from pathlib import Path

import pytest
import torch

from storybench import check, port, run
from storybench.tests import tiny

CPU = torch.device("cpu")
REFERENCE = Path(check.__file__).resolve().parent / "reference"


def _port_outputs(cfg, mix, seed):
    pipe = run.build_program(torch, cfg, seed, CPU)
    cache = port.cond_cache(pipe, cfg)
    return run._call(pipe, cache, cfg, mix, seed, range(mix["batch"]), CPU)


def test_reference_matches_the_port():
    cfg, mix = tiny.config(), tiny.mix("offline-b4")
    frames, embeds = _port_outputs(cfg, mix, 5)
    model = check.reference_model(cfg, 5, CPU)
    for i in range(mix["batch"]):
        rf, re = check.reference_story(model, cfg, mix, 5, i, CPU)
        got = check.numbers(frames[i], rf[0], embeds[i], re[0])
        assert got["frames_mean_abs"] < 1e-5
        assert got["embeds_rel"] < 1e-4


@pytest.mark.parametrize("workload", ["flintstones-offline-b4",
                                      "pororosv-served-steady"])
def test_fp8_control_fails_and_the_port_passes(workload):
    cfg = tiny.config()
    mix = tiny.mix("offline-b4")
    model = check.reference_model(cfg, 9, CPU)
    limits = check.limits(workload)
    served = "served" in workload
    port_frames, port_embeds = _port_outputs(cfg, mix, 9)
    control, ours = [], []
    for i in range(2):
        rf, re = check.reference_story(model, cfg, mix, 9, i, CPU)
        with check.Fp8Products():
            cf, ce = check.reference_story(model, cfg, mix, 9, i, CPU)
        pf, pe = port_frames[i], port_embeds[i]
        if served:
            cf, ce = check.as_served(cf), None
            pf, pe = check.as_served(pf), None
        control.append(check.numbers(cf[0], rf[0], None if ce is None
                                     else ce[0], None if ce is None
                                     else re[0]))
        ours.append(check.numbers(pf, rf[0], pe, None if pe is None
                                  else re[0]))
    assert not check.verdict(check.worst(control), limits)[0]
    assert check.verdict(check.worst(ours), limits)[0]


def test_fp8_rounds_to_e4m3_under_one_scale():
    x = torch.tensor([448.0, 1.0, -3.3, 0.0]) * 2.0
    y = check.fp8(x)
    assert y[0] == x[0] and y[3] == 0
    assert torch.allclose(y, x, rtol=2 ** -3)
    assert not torch.equal(y, x)


def test_reference_imports_nothing_of_the_port():
    banned = {"rcdms_tpu_torch", "rcdms_tpu", "jax", "jaxlib", "flax"}
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
