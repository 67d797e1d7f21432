"""The orbax -> torch converter (scripts/orbax_to_torch.py) on the CPU, at
the JAX CLIs' --synthetic configs (`--tiny`).

* a tiny JAX pipeline saved by the JAX convert CLI (`rcdms_tpu/cli/
  convert.py`, its towers' seeded weights drawn into `jax.eval_shape`'s
  trees, so no flax init compiles), then converted: every tower of the
  port's `--converted-ckpt` build equals the bridge's state dict of the
  same params (rcdms_tpu_torch/io/bridge.py) bit for bit, and its story
  on injected noise equals that of the port loaded through
  `bridge.load_pipeline_params` bit for bit;
* a tiny JAX stage-1 TrainState (accumulation 2, after 3 micro-steps: the
  moments and the accumulated gradients nonzero) and a stage-2 one (after
  1 step), saved by orbax as the JAX training CLIs save them, then
  converted: the file holds `train_state_dicts` of the JAX state bit for
  bit, the port's training CLI resumed from it (`--resume-from-
  checkpoint`) holds it, and its next step equals one step from the
  bridged state on the same batch and noise bit for bit; a stage-1
  checkpoint of params alone converts to {params};
* `--stage1-ckpt` / `--stage2-ckpt` of the converted directories build the
  bridged prior, UNet and fusion stacks bit for bit.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from rcdms_tpu.cli import common as jcommon
from rcdms_tpu.cli import convert as jconvert
from rcdms_tpu.cli import evaluate as jevaluate
from rcdms_tpu.configs import FusionConfig as JFusionConfig
from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.configs import PriorConfig as JPriorConfig
from rcdms_tpu.configs import StoryUNetConfig as JUNetConfig
from rcdms_tpu.io.checkpoint import save_checkpoint as jsave
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.cli import train_stage1 as ptrain1
from rcdms_tpu_torch.cli import train_stage2 as ptrain2
from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
from rcdms_tpu_torch.sample.pipeline import StoryNoise
from rcdms_tpu_torch.train.loop import train_step
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_train_ckpt_flags import CPU, _dataset
from tests.test_torch_training import _draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
conv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conv)

SYNTH_TEXT_LEN = SyntheticStoryDataset().cfg.max_text_len
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _seeded(tree, seed: int):
    return jax.tree_util.tree_map_with_path(
        functools.partial(_draw, np.random.default_rng(seed)), tree)


def _equal_dicts(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for k, v in want.items():
        w = torch.tensor(np.asarray(v))
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), (what, k)


# ---- the converted pipeline ------------------------------------------------


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(the port's converted directory, the JAX params the convert CLI
    saved)."""
    root = tmp_path_factory.mktemp("converted")
    seeds = iter(range(100))
    captured = {}
    real_build = jevaluate.build_pipeline

    def seeded_init(model, key, *args, dtype=None):
        return _seeded(jax.eval_shape(lambda k: model.init(k, *args), key),
                       next(seeds))

    def spy(args):
        out = real_build(args)
        captured["params"] = jax.device_get(out[1])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "_init", seeded_init)
        mp.setattr(jevaluate, "build_pipeline", spy)
        jconvert.main(["--synthetic", "--output-dir", str(root / "jax")])
    line = conv.convert(str(root / "jax"), str(root / "port"), tiny=True)
    assert line["kind"] == "converted" and line["step"] == 0
    return str(root / "port"), captured["params"]


def _story_inputs(pipeline):
    ds = SyntheticStoryDataset()
    ex = ds.example(0, np.random.RandomState(0), known_length=1)
    uncond = ds.tokenizer([""] * ds.cfg.num_frames)["input_ids"]
    return pevaluate._batch_inputs([ex], uncond, pipeline.device), ds.cfg


def test_converted_pipeline_equals_the_bridged_port(converted):
    path, params = converted
    _, meta, _ = restore_checkpoint(path)
    assert meta["kind"] == conv.CONVERTED_KIND and meta["dataset"]
    assert meta["orbax_source"].endswith("jax")
    loaded, _, _ = pevaluate.build_pipeline(pevaluate.parse_args(
        CPU + ["--converted-ckpt", path]))
    bridged, _, _ = pevaluate.build_pipeline(pevaluate.parse_args(CPU))
    bridge.load_pipeline_params(bridged, params)
    sds = bridge.pipeline_state_dicts(params, bridged.configs)
    for name in pevaluate.TOWERS:
        _equal_dicts(getattr(loaded, name).state_dict(), sds[name], name)
    inputs, ds_cfg = _story_inputs(loaded)
    noise = StoryNoise.draw(loaded, 1, torch.Generator().manual_seed(5),
                            ds_cfg.image_size)
    frames_a, embeds_a = loaded.generate(inputs, noise=noise)
    frames_b, embeds_b = bridged.generate(inputs, noise=noise)
    assert torch.isfinite(frames_a).all()
    assert torch.equal(frames_a, frames_b) and torch.equal(embeds_a,
                                                           embeds_b)


# ---- the training states -------------------------------------------------


STAGES = {
    # stage: (the port CLI, its extra flags, accumulation, micro-steps)
    1: (ptrain1, ["--accumulate-steps", "2"], 2, 3),
    2: (ptrain2, [], 1, 1),
}


def _jax_params(stage: int) -> dict:
    """The JAX training CLI's trainable params, seeded, at its --synthetic
    configs."""
    if stage == 1:
        cfg = JPriorConfig.tiny(num_text_tokens=SYNTH_TEXT_LEN)
        shapes = jax.eval_shape(lambda: jcommon.build_prior(cfg, None)[1])
        return _seeded(shapes, 11)
    ucfg = JUNetConfig.tiny()
    fcfg = JFusionConfig.tiny(hidden_dim=ucfg.cross_attention_dim,
                              text_dim=ucfg.cross_attention_dim)
    unet = jax.eval_shape(lambda: jcommon.build_unet(ucfg, None)[1])
    fusion = jax.eval_shape(lambda: jcommon.build_fusion(fcfg)[1])
    return _seeded({"params": {"unet": unet["params"],
                               "fusion": fusion["params"]}}, 12)


def _to_state_dict(stage: int):
    if stage == 1:
        cfg = port_config(JPriorConfig.tiny(num_text_tokens=SYNTH_TEXT_LEN))
        return lambda p: bridge.stage1_state_dict(p, cfg)
    cfg = port_config(JUNetConfig.tiny())
    return lambda p: bridge.stage2_state_dict(p, cfg)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{stage: (the converted directory, the JAX state, its
    train_state_dicts)} after each stage's JAX micro-steps, saved as the
    JAX CLIs save them."""
    out = {}
    for stage, (_, _, accumulate, steps) in STAGES.items():
        root = tmp_path_factory.mktemp(f"stage{stage}")
        params = _jax_params(stage)
        st = JTrainState.create(params, jmake_optimizer(JOptimizerConfig(
            learning_rate=1e-3, warmup_steps=0, max_steps=100,
            accumulate_steps=accumulate)))
        # the optimizer's few ops a leaf compile faster unoptimised
        apply = jax.jit(lambda s, g: s.apply_gradients(g),
                        compiler_options=FAST_COMPILE)
        for i in range(steps):
            st = apply(st, _seeded(params, 100 + i))
        st = jax.device_get(st)
        jsave(str(root / "jax"), steps, {"params": st.params,
                                         "opt_state": st.opt_state,
                                         "step": st.step},
              {"last_global_step": steps, "preempted": True})
        line = conv.convert(str(root / "jax"), str(root / "port"),
                            tiny=True)
        assert line["kind"] == f"stage{stage}" and line["step"] == steps
        out[stage] = (str(root / "port"), st,
                      bridge.train_state_dicts(st, _to_state_dict(stage)))
    return out


def _state_equal(got: dict, want: dict, what: str) -> None:
    for key in ("params", "mu", "nu", "acc"):
        if want[key] is None:
            assert got[key] is None, (what, key)
        else:
            _equal_dicts(got[key], want[key], f"{what} {key}")
    for key in ("count", "mini_step", "gradient_step", "step"):
        assert int(got[key]) == want[key], (what, key)


def _cli_args(stage: int, resume: str, out: str, steps: int):
    mod, extra, _, _ = STAGES[stage]
    return mod.parse_args(
        ["--synthetic", "--device", "cpu", "--batch-size", "1",
         "--report-to", "none", "--dtype", "float32", "--learning-rate",
         "1e-3", "--warmup-steps", "0", "--max-train-steps", str(steps),
         "--resume-from-checkpoint", resume, "--output-dir", out, *extra])


@pytest.mark.parametrize("stage", [1, 2])
def test_converted_train_state_resumes_and_steps_like_the_bridge(
        trained, tmp_path, stage):
    path, st, want = trained[stage]
    mod = STAGES[stage][0]
    steps = int(st.step)
    assert want["count"] > 0 and any(
        np.abs(v).max() > 0 for v in want["mu"].values())
    if stage == 1:
        assert want["mini_step"] == 1 and any(
            np.abs(v).max() > 0 for v in want["acc"].values())

    saved, meta, step = restore_checkpoint(path)
    assert step == steps and meta["last_global_step"] == steps
    assert meta["preempted"] is True
    _state_equal(saved, want, "file")

    # the training CLI resumed at the checkpoint's step: no step taken
    resumed = mod.run(_cli_args(stage, path, str(tmp_path / "a"), steps),
                      _dataset()).state
    _state_equal(resumed.state_dicts(), want, "resumed")

    # one step of the CLI from the file against one from the bridged state
    args = _cli_args(stage, path, str(tmp_path / "b"), steps + 1)
    run = mod.run(args, _dataset())
    dataset = _dataset()
    configs = mod.default_configs(args, dataset.cfg)
    state, towers = mod.build_state(args, configs, torch.device("cpu"))
    state.load_state_dicts(want)
    raw = common.batch_to_device(next(dataset.batches(1)),
                                 torch.device("cpu"))
    encode_gen, step_gen = common.step_generators(args.seed, steps,
                                                  torch.device("cpu"))
    with torch.no_grad():
        batch = mod.encode(towers, raw, encode_gen)
    train_step(state, batch, generator=step_gen)
    got, ref = run.state.state_dicts(), state.state_dicts()
    assert got["step"] == ref["step"] == steps + 1
    _state_equal(got, {k: v if not isinstance(v, dict) else
                       {n: t.numpy() for n, t in v.items()}
                       for k, v in ref.items()}, "stepped")


def test_params_alone_convert_to_params(tmp_path):
    params = _jax_params(1)
    jsave(str(tmp_path / "jax"), 7, {"params": params},
          {"last_global_step": 7})
    line = conv.convert(str(tmp_path / "jax"), str(tmp_path / "port"),
                        tiny=True)
    assert line["kind"] == "stage1" and line["step"] == 7
    saved, meta, _ = restore_checkpoint(str(tmp_path / "port"))
    assert set(saved) == {"params"} and meta["last_global_step"] == 7
    _equal_dicts(saved["params"], _to_state_dict(1)(params), "params")


def test_stage_ckpt_flags_build_the_bridged_towers(trained):
    flags = ["--stage1-ckpt", trained[1][0], "--stage2-ckpt", trained[2][0]]
    pipeline, _, _ = pevaluate.build_pipeline(pevaluate.parse_args(
        CPU + flags))
    for stage, towers in ((1, ("prior",)), (2, ("unet", "fusion"))):
        masters = trained[stage][2]["params"]
        for name in towers:
            own = dict(getattr(pipeline, name).named_parameters())
            _equal_dicts(own, {n[len(name) + 1:]: v for n, v in
                               masters.items()
                               if n.startswith(name + ".")}, name)
