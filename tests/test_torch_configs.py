"""The port's own config dataclasses (rcdms_tpu_torch/configs.py) against
the JAX package's (rcdms_tpu/configs): the same fields, types, defaults and
presets, and the port's import boundary: with `rcdms_tpu`, `jax`, `flax`,
`optax`, `orbax` and Pillow blocked, every module of the port and
chip_smoke.py imports.

`port_config` turns a JAX config into the port's, field by field; the
tests that build JAX configs hand the port its own copy through it.
`one_torch_thread`, imported by the port's heavier test modules, runs
each such module's torch work on one intra-op thread."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from rcdms_tpu import configs as jconfigs
from rcdms_tpu_torch import configs as pconfigs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("TemporalConfig", "PriorConfig", "StoryUNetConfig", "VAEConfig",
         "CLIPTextConfig", "CLIPVisionConfig", "FusionConfig")
TRAIN_NAMES = ("OptimizerConfig", "MeshConfig", "Stage1TrainConfig",
               "Stage2TrainConfig")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: the suite runs several
    pytest workers on the CPU's cores at once, and the tiny towers gain
    nothing from threads that then contend for those cores (a module that
    took seconds alone took minutes beside five others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(cfg):
    """The port's config of the same class name and field values as the
    JAX config `cfg`, nested configs included."""
    cls = getattr(pconfigs, type(cfg).__name__)
    return cls(**{
        f.name: (port_config(v) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)})


def _fields(cls):
    return [(f.name, f.type, f.default,
             f.default_factory is not dataclasses.MISSING)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", NAMES + ("DatasetConfig",) + TRAIN_NAMES)
def test_fields_types_and_defaults_match(name):
    jcls, pcls = getattr(jconfigs, name), getattr(pconfigs, name)
    assert _fields(pcls) == _fields(jcls)
    assert pcls.__dataclass_params__.frozen
    assert dataclasses.asdict(pcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("name", [n for n in NAMES if n != "TemporalConfig"])
def test_tiny_presets_match(name):
    jcfg = getattr(jconfigs, name).tiny()
    assert dataclasses.asdict(getattr(pconfigs, name).tiny()) == \
        dataclasses.asdict(jcfg)
    assert port_config(jcfg) == getattr(pconfigs, name).tiny()


@pytest.mark.parametrize("preset", ["sd15", "bigg"])
@pytest.mark.parametrize("kw", [{}, dict(max_positions=85, vocab_size=49416)])
def test_clip_text_presets_match(preset, kw):
    want = getattr(jconfigs.CLIPTextConfig, preset)(**kw)
    got = getattr(pconfigs.CLIPTextConfig, preset)(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_prior_properties_match():
    for jcfg in (jconfigs.PriorConfig(), jconfigs.PriorConfig.tiny()):
        pcfg = port_config(jcfg)
        assert isinstance(pcfg.temporal, pconfigs.TemporalConfig)
        assert (pcfg.inner_dim, pcfg.additional_tokens, pcfg.seq_len) == (
            jcfg.inner_dim, jcfg.additional_tokens, jcfg.seq_len)


@pytest.mark.parametrize("name", TRAIN_NAMES[2:])
def test_train_configs_match(name):
    """The train configs' defaults (stage 1 clips at 10.0, stage 2 at 1.0;
    both global batch 8, noise offset 0.1, bf16), and `port_config` of a
    JAX train config with non-default nested configs."""
    jcls, pcls = getattr(jconfigs, name), getattr(pconfigs, name)
    assert pcls().optimizer.grad_clip_norm == (
        10.0 if name == "Stage1TrainConfig" else 1.0)
    assert (pcls().batch_size, pcls().noise_offset, pcls().compute_dtype) \
        == (8, 0.1, "bfloat16")
    jcfg = jcls(optimizer=jconfigs.OptimizerConfig(
        learning_rate=1e-3, accumulate_steps=2, schedule="cosine"),
        mesh=jconfigs.MeshConfig(data=4), seed=7)
    pcfg = port_config(jcfg)
    assert isinstance(pcfg, pcls)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("data,tensor,n", [(-1, 1, 8), (4, 2, 8), (-1, 2, 8),
                                           (3, 1, 8), (-1, 3, 8)])
def test_mesh_axis_sizes_match(data, tensor, n):
    def sizes(cfg):
        try:
            return cfg.axis_sizes(n)
        except ValueError as e:
            return str(e)

    assert sizes(pconfigs.MeshConfig(data, tensor)) == sizes(
        jconfigs.MeshConfig(data, tensor))


@pytest.mark.parametrize("dataset", ["flintstones", "pororosv"])
def test_dataset_properties_match(dataset):
    jcfg = jconfigs.DatasetConfig(name=dataset, image_size=64, clip_size=28)
    pcfg = port_config(jcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert (pcfg.max_text_len, pcfg.vocab_size, tuple(pcfg.new_tokens)) == (
        jcfg.max_text_len, jcfg.vocab_size, tuple(jcfg.new_tokens))


_BLOCKED = textwrap.dedent("""
    import importlib
    import pkgutil
    import sys

    blocked = ("rcdms_tpu", "jax", "flax", "optax", "orbax", "PIL")
    for name in blocked:
        sys.modules[name] = None

    import rcdms_tpu_torch

    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(rcdms_tpu_torch.__path__,
                                              "rcdms_tpu_torch.")]
    assert {"rcdms_tpu_torch.cli.serve", "rcdms_tpu_torch.ops.quant",
            "rcdms_tpu_torch.ops._grad", "rcdms_tpu_torch.train.loop",
            "rcdms_tpu_torch.train.optim", "rcdms_tpu_torch.train.stage1",
            "rcdms_tpu_torch.train.stage2",
            "rcdms_tpu_torch.train.train_state",
            "rcdms_tpu_torch.cli.train_stage1",
            "rcdms_tpu_torch.cli.train_stage2",
            "rcdms_tpu_torch.cli.convert", "rcdms_tpu_torch.io.checkpoint",
            "rcdms_tpu_torch.utils.logging",
            "rcdms_tpu_torch.utils.preemption",
            "rcdms_tpu_torch.data.prefetch",
            "rcdms_tpu_torch.data.native_feeder",
            "rcdms_tpu_torch.utils.video",
            "rcdms_tpu_torch.tools.parity_check",
            "rcdms_tpu_torch.tools.int8_quality",
            "rcdms_tpu_torch.bench", "rcdms_tpu_torch.ops.impl",
            "rcdms_tpu_torch.tools.profile_bench",
            "rcdms_tpu_torch.tools.bench_feeder"} <= set(names)
    for name in names:
        importlib.import_module(name)
    for name in blocked:
        del sys.modules[name]
    leaked = sorted(k for k in sys.modules
                    if k == "rcdms_tpu" or k.startswith("rcdms_tpu."))
    assert not leaked, leaked
    print(len(names), "modules")
""")


def test_port_imports_with_rcdms_tpu_and_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("modules")
    assert int(proc.stdout.split()[-2]) > 30
