"""The port's training CLIs (rcdms_tpu_torch/cli/train_stage{1,2}.py)
against the JAX package's and against the library loop, on the CPU.

* each parser has the JAX CLI's dests, defaults and choices, and
  --device (default cuda) besides;
* `python -m rcdms_tpu_torch.cli.train_stage{1,2} --synthetic --device
  cpu` for 3 steps gives, bit for bit, the losses (its metrics.jsonl) and
  the final masters and moments (its step-3 checkpoint) of a hand loop
  over `train.loop.train_step` on the same batches (the synthetic
  dataset's, in order) and the same per-step generators
  (`cli/common.py::step_generators`); the CLIs run in subprocesses, on
  one thread each, while the hand loops run here.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli import train_stage1 as ptrain1
from rcdms_tpu_torch.cli import train_stage2 as ptrain2
from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
from rcdms_tpu_torch.train.loop import train_step
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
PORT = {1: ptrain1, 2: ptrain2}


def _argv(out: str) -> list:
    return ["--synthetic", "--device", "cpu", "--max-train-steps",
            str(STEPS), "--batch-size", "1", "--log-every", "1",
            "--report-to", "none", "--output-dir", out]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs started at once, in subprocesses of one thread each; the
    tests read their output directories once they have exited."""
    root = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {}
    for stage in (1, 2):
        out = str(root / f"stage{stage}")
        procs[stage] = (out, subprocess.Popen(
            [sys.executable, "-m", f"rcdms_tpu_torch.cli.train_stage{stage}"]
            + _argv(out), cwd=str(root), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    yield procs
    for _, proc in procs.values():
        proc.kill()


def _parser_of(parse_args, monkeypatch):
    """The ArgumentParser a CLI's `parse_args` builds."""
    import argparse

    seen = []
    original = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.append(self)
        return original(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    parse_args([])
    monkeypatch.undo()
    return seen[-1]


@pytest.mark.parametrize("stage", [1, 2])
def test_parser_matches_the_jax_cli(stage, monkeypatch):
    import importlib

    jcli = importlib.import_module(f"rcdms_tpu.cli.train_stage{stage}")

    def table(parser):
        return {a.dest: (a.default, a.choices, a.option_strings)
                for a in parser._actions if a.dest != "help"}

    want = table(_parser_of(jcli.parse_args, monkeypatch))
    got = table(_parser_of(PORT[stage].parse_args, monkeypatch))
    assert got.pop("device") == ("cuda", None, ["--device"])
    assert got == want


def _hand_loop(stage: int, out: str):
    """The losses and the state of a loop written out here: the CLI's
    build (`build_state`), the synthetic dataset's batches in order, each
    step's two generators, `encode` without grad, `train_step`."""
    mod = PORT[stage]
    args = mod.parse_args(_argv(out))
    dataset = common.train_dataset(args)
    configs = mod._apply_flags(args, mod.default_configs(args, dataset.cfg))
    state, towers = mod.build_state(args, configs, torch.device("cpu"))
    batches = dataset.batches(args.batch_size, seed=args.seed)
    losses = []
    for i in range(STEPS):
        raw = common.batch_to_device(next(batches), "cpu")
        encode_gen, step_gen = common.step_generators(args.seed, i, "cpu")
        with torch.no_grad():
            batch = mod.encode(towers, raw, encode_gen)
        losses.append(train_step(state, batch, generator=step_gen).item())
    return losses, state.state_dicts()


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.dtype == want.dtype and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("stage", [2, 1])
def test_cli_equals_the_library_loop(stage, cli_runs, tmp_path):
    losses, want = _hand_loop(stage, str(tmp_path / "hand"))
    out, proc = cli_runs[stage]
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    assert "step 0 loss" in log
    lines = [json.loads(x) for x in
             open(os.path.join(out, "metrics.jsonl")).read().splitlines()]
    assert [r["step"] for r in lines] == list(range(STEPS))
    assert [r["loss"] for r in lines] == losses
    got, meta, step = restore_checkpoint(out)
    assert (step, meta) == (STEPS, {"last_global_step": STEPS})
    assert (got["step"], got["count"]) == (want["step"], want["count"]) \
        == (STEPS, STEPS)
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key]), key
        bad = [n for n, t in want[key].items()
               if not _bits_equal(got[key][n], t)]
        assert not bad, (key, bad[:5])


def test_step_generators_are_seeded_by_seed_and_step():
    """The same (seed, step) draws the same; the encode's and the step's
    draws differ from each other and from another step's or seed's."""
    def draws(seed, step):
        return [torch.randn(4, generator=g)
                for g in common.step_generators(seed, step, "cpu")]

    encode, step = draws(0, 0)
    again = draws(0, 0)
    assert torch.equal(encode, again[0]) and torch.equal(step, again[1])
    others = [step, *draws(0, 1), *draws(1, 0)]
    assert not any(torch.equal(encode, x) for x in others)
    assert not any(torch.equal(step, x) for x in others[1:])


def test_the_default_device_is_cuda_without_fallback():
    args = ptrain2.parse_args(["--synthetic"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain2.run(args, common.train_dataset(args))
