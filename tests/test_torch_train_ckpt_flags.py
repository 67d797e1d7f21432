"""Resume, and the inference CLIs reading the training CLIs' checkpoints,
on the CPU at tiny size.

* resume (the JAX tests/test_train_cli_resume.py assertions, for both
  stages): 2 steps, a checkpoint at step 2, a resume to 4 that prints
  "resumed from step 2" and "step 2 loss", a checkpoint at 4 with
  last_global_step 4 and step 4; with a dataset that repeats one batch
  (the data iterator restarts on resume), the resumed run's losses at
  steps 2-3 and its final masters and moments equal an unbroken 4-step
  run's bit for bit;
* `--stage1-ckpt` / `--stage2-ckpt` load a tiny run's fp32 masters into
  the prior, UNet and fusion stacks bit for bit (in bf16: the masters
  rounded to the towers' dtypes);
* `convert` then `--converted-ckpt` gives the source pipeline's frames on
  the same generator; a checkpoint of another kind, and an orbax one of
  the JAX package, raise.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from rcdms_tpu_torch.cli import convert as pconvert
from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.cli import generate as pgenerate
from rcdms_tpu_torch.cli import train_stage1 as ptrain1
from rcdms_tpu_torch.cli import train_stage2 as ptrain2
from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset
from rcdms_tpu_torch.io.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

PORT = {1: ptrain1, 2: ptrain2}
CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "2"]
CAPTIONS = [f"frame {i} of the story" for i in range(5)]


class OneBatch:
    """A dataset whose `batches` repeat its first batch: a resumed step
    sees the batch of the unbroken run's step."""

    def __init__(self, dataset, batch_size: int = 1):
        self.cfg = dataset.cfg
        self._batch = next(dataset.batches(batch_size, seed=0))

    def batches(self, batch_size, **_):
        while True:
            yield self._batch


def _dataset():
    return OneBatch(SyntheticStoryDataset(
        cfg=DatasetConfig(image_size=32, clip_size=28), num_items=2))


def _train(stage: int, out: str, steps: int, *extra):
    mod = PORT[stage]
    args = mod.parse_args(
        ["--synthetic", "--device", "cpu", "--batch-size", "1",
         "--log-every", "1", "--report-to", "none", "--dtype", "float32",
         "--checkpointing-steps", "2", "--max-train-steps", str(steps),
         "--output-dir", out, *extra])
    return mod.run(args, _dataset())


def _losses(out: str) -> dict:
    return {r["step"]: r["loss"] for r in map(json.loads, open(
        os.path.join(out, "metrics.jsonl")).read().splitlines())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each stage: 2 steps, then a resume to 4 (with what it printed), and
    an unbroken 4-step run, in directories of their own."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for stage in (1, 2):
        d, whole = str(root / f"s{stage}"), str(root / f"s{stage}-whole")
        _train(stage, d, 2)
        first = latest_step(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _train(stage, d, 4, "--resume-from-checkpoint", d)
        _train(stage, whole, 4)
        out[stage] = dict(dir=d, whole=whole, first=first,
                          printed=buf.getvalue())
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_resume_continues_from_the_saved_step(runs, stage):
    r = runs[stage]
    assert r["first"] == 2
    assert "resumed from step 2" in r["printed"]
    assert "step 2 loss" in r["printed"] and "step 0 loss" not in \
        r["printed"]  # continued at step 2, not 0
    assert latest_step(r["dir"]) == 4
    restored, meta, step = restore_checkpoint(r["dir"])
    assert step == 4 and meta["last_global_step"] == 4
    assert restored["step"] == 4 and restored["count"] == 4


@pytest.mark.parametrize("stage", [1, 2])
def test_resume_equals_an_unbroken_run(runs, stage):
    r = runs[stage]
    resumed, whole = _losses(r["dir"]), _losses(r["whole"])
    assert [resumed[s] for s in (2, 3)] == [whole[s] for s in (2, 3)]
    got, _, _ = restore_checkpoint(r["dir"])
    want, _, _ = restore_checkpoint(r["whole"])
    for key in ("params", "mu", "nu"):
        bad = [n for n, t in want[key].items() if not torch.equal(
            got[key][n].view(torch.int32), t.view(torch.int32))]
        assert not bad, (key, bad[:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_ckpt_flags_load_the_masters(runs, dtype):
    args = pevaluate.parse_args(
        CPU + ["--dtype", dtype, "--stage1-ckpt", runs[1]["dir"],
               "--stage2-ckpt", runs[2]["dir"]])
    pipeline, _, _ = pevaluate.build_pipeline(args)
    for stage, towers in ((1, ("prior",)), (2, ("unet", "fusion"))):
        masters = restore_checkpoint(runs[stage]["dir"])[0]["params"]
        for tower in towers:
            params = dict(getattr(pipeline, tower).named_parameters())
            assert {f"{tower}.{n}" for n in params} == {
                n for n in masters if n.startswith(tower + ".")}
            for n, p in params.items():
                want = masters[f"{tower}.{n}"].to(p.dtype)
                assert torch.equal(p, want), (tower, n)
            if dtype == "bfloat16":
                assert any(p.dtype == torch.bfloat16
                           for p in params.values())


def test_a_stage_ckpt_of_the_other_stage_raises(runs):
    args = pevaluate.parse_args(CPU + ["--stage1-ckpt", runs[2]["dir"]])
    with pytest.raises(KeyError, match="differ"):
        pevaluate.build_pipeline(args)


def test_convert_then_converted_ckpt_gives_the_source_frames(runs, tmp_path,
                                                             capsys):
    flags = ["--stage1-ckpt", runs[1]["dir"], "--stage2-ckpt",
             runs[2]["dir"]]
    out = str(tmp_path / "converted")
    line = pconvert.main(CPU + flags + ["--output-dir", out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert line["components"] == sorted(pevaluate.TOWERS)
    state, meta, step = restore_checkpoint(out)
    assert step == 0 and meta["kind"] == "rcdms_tpu-converted-pipeline"
    assert meta["sources"]["stage2_ckpt"] == runs[2]["dir"]
    source = pevaluate.parse_args(CPU + flags)
    converted = pevaluate.parse_args(CPU + ["--converted-ckpt", out])
    frames_a, embeds_a = pgenerate.run(source, CAPTIONS, [])
    frames_b, embeds_b = pgenerate.run(converted, CAPTIONS, [])
    assert torch.equal(frames_a, frames_b) and torch.equal(embeds_a,
                                                           embeds_b)
    pipeline, _, _ = pevaluate.build_pipeline(converted)
    assert line["total_params"] == sum(
        p.numel() for name in pevaluate.TOWERS
        for p in getattr(pipeline, name).parameters())


def test_converted_ckpt_of_another_kind_raises(runs, tmp_path):
    d = str(tmp_path / "other")
    save_checkpoint(d, 0, {"params": {}}, {"kind": "something-else"})
    with pytest.raises(ValueError, match="not a convert-CLI checkpoint"):
        pevaluate.build_pipeline(pevaluate.parse_args(
            CPU + ["--converted-ckpt", d]))
    # a training checkpoint is no converted pipeline either
    with pytest.raises(ValueError, match="kind=None"):
        pevaluate.build_pipeline(pevaluate.parse_args(
            CPU + ["--converted-ckpt", runs[1]["dir"]]))


def test_an_orbax_checkpoint_raises_naming_its_converter(tmp_path):
    import jax.numpy as jnp

    from rcdms_tpu.io.checkpoint import save_checkpoint as jsave

    d = str(tmp_path / "orbax")
    jsave(d, 0, {"params": {"w": jnp.zeros(2)}}, {"kind": "x"})
    for flag in ("--converted-ckpt", "--stage1-ckpt", "--stage2-ckpt"):
        with pytest.raises(ValueError, match="scripts/orbax_to_torch.py"):
            pevaluate.build_pipeline(pevaluate.parse_args(CPU + [flag, d]))


def test_unet_init_ckpt_warm_starts_from_the_masters(runs, tmp_path):
    """--unet-init-ckpt: a stage-2 checkpoint's masters become the new
    state's masters (and the rounded copies), the optimizer fresh."""
    args = ptrain2.parse_args(["--synthetic", "--device", "cpu",
                               "--unet-init-ckpt", runs[2]["dir"]])
    configs = ptrain2.default_configs(args, _dataset().cfg)
    state, _ = ptrain2.build_state(args, configs, torch.device("cpu"))
    masters = restore_checkpoint(runs[2]["dir"])[0]["params"]
    assert set(state.params) == set(masters)
    for n, t in state.params.items():
        assert torch.equal(t, masters[n]), n
    assert state.step == 0 and state.opt_state.count == 0
    assert not any(m.any() for m in state.opt_state.mu.values())


def test_rcdms_init_ckpt_warm_starts_both_stages(runs, tmp_path):
    """--rcdms-init-ckpt: a reference DeepSpeed blob of the trained towers
    (stage 2: `unet.` plus the fusion stacks' own names; stage 1: the
    prior's) warm-starts the trained set."""
    masters = {s: restore_checkpoint(runs[s]["dir"])[0]["params"]
               for s in (1, 2)}
    blobs = {1: {n[len("prior."):]: t for n, t in masters[1].items()},
             2: {n[len("fusion."):] if n.startswith("fusion.") else n: t
                 for n, t in masters[2].items()}}
    for stage, mod in PORT.items():
        path = str(tmp_path / f"stage{stage}.pt")
        torch.save({"module": blobs[stage]}, path)
        args = mod.parse_args(["--synthetic", "--device", "cpu",
                               "--rcdms-init-ckpt", path])
        state, _ = mod.build_state(
            args, mod.default_configs(args, _dataset().cfg),
            torch.device("cpu"))
        for n, t in state.params.items():
            assert torch.equal(t, masters[stage][n]), (stage, n)


@pytest.mark.parametrize("stage", [1, 2])
def test_config_yaml_reaches_the_trained_model(stage, tmp_path):
    from rcdms_tpu_torch.reference_yaml import (
        apply_to_unet_config,
        parse_reference_yaml,
    )
    from tests.test_torch_cli import TRAINING_YAML

    pytest.importorskip("yaml")
    path = tmp_path / "training.yaml"
    path.write_text(TRAINING_YAML)
    mod = PORT[stage]
    args = mod.parse_args(["--synthetic", "--device", "cpu", "--config",
                           str(path)])
    base = mod.default_configs(args, _dataset().cfg)
    got = mod._apply_flags(args, base)
    overrides, _ = parse_reference_yaml(str(path))
    field = "prior" if stage == 1 else "unet"
    assert getattr(got, field) == apply_to_unet_config(
        getattr(base, field), overrides)
    assert getattr(got, field).temporal.num_heads == 8
