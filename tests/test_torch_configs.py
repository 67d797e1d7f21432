"""The port's own config dataclasses (rcdms_tpu_torch/configs.py) against
the JAX package's (rcdms_tpu/configs): the same fields, types, defaults and
presets, and the port's import boundary: with `rcdms_tpu` and `jax`
blocked, every module of the port and chip_smoke.py imports.

`port_config` turns a JAX config into the port's, field by field; the
tests that build JAX configs hand the port its own copy through it."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

from rcdms_tpu import configs as jconfigs
from rcdms_tpu_torch import configs as pconfigs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("TemporalConfig", "PriorConfig", "StoryUNetConfig", "VAEConfig",
         "CLIPTextConfig", "CLIPVisionConfig", "FusionConfig")


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


@pytest.mark.parametrize("name", NAMES + ("DatasetConfig",))
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

    sys.modules["rcdms_tpu"] = None
    sys.modules["jax"] = None

    import rcdms_tpu_torch

    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(rcdms_tpu_torch.__path__,
                                              "rcdms_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    del sys.modules["rcdms_tpu"], sys.modules["jax"]
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
