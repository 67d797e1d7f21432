"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole), and the harness's check of it."""

import subprocess
import sys

from storybench import data, run

PROBE = """
import sys, torch
from storybench import run
from storybench.tests import tiny
cfg, mix = tiny.config(), tiny.mix("offline-b4")
rec = run.measure(cfg, mix, 4, 0.5, 0, torch.device("cpu"))
run.check(cfg, mix, 4, rec, torch.device("cpu"), "flintstones-offline-b4")
print(run.forbidden_modules())
"""


def test_a_tiny_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=data.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rcdms_tpu_torch_fake.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rcdms_tpu.fake", sys)
    assert run.forbidden_modules() == ["rcdms_tpu"]


def test_the_run_needs_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "flintstones-offline-b4", "--seed", "1",
                     "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
