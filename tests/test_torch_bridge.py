"""rcdms_tpu_torch/io/bridge.py and the port's import boundary.

Round trip, per tower: a flax parameter tree (the flax model's own
structure, from `jax.eval_shape` of its init, filled with seeded values) ->
bridge -> torch state dict, which the port's module loads strictly ->
the JAX package's converters (rcdms_tpu/io/convert.py) -> flax tree,
which must equal the original exactly (only transposes and renames).

Import guard: in a subprocess where jax, flax and transformers cannot be
imported, `import rcdms_tpu_torch` and a tiny pipeline's build and
`generate` succeed."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    FusionConfig,
    PriorConfig,
    StoryUNetConfig,
    VAEConfig,
)
from rcdms_tpu.io import convert
from rcdms_tpu.models import clip as jclip
from rcdms_tpu.models import fusion as jfusion
from rcdms_tpu.models import prior as jprior
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.models import vae as jvae
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.models import clip as tclip
from rcdms_tpu_torch.models import fusion as tfusion
from rcdms_tpu_torch.models import prior as tprior
from rcdms_tpu_torch.models import unet3d as tunet
from rcdms_tpu_torch.models import vae as tvae
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_tree(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes)["params"]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _fusion_back(sd):
    blob = convert.split_deepspeed_blob(sd)
    return {"seen_module": convert.convert_fusion_stack(blob["seen"]),
            "unseen_module": convert.convert_fusion_stack(blob["unseen"])}


_UNET = dataclasses.replace(StoryUNetConfig.tiny(), temporal_mid_block=True)
_PRIOR = PriorConfig.tiny()
_VAE = VAEConfig.tiny()
_TEXT = CLIPTextConfig.tiny()
_VISION = CLIPVisionConfig.tiny()
_FUSION = FusionConfig.tiny()
_f32 = np.float32

CASES = {
    "unet": (
        lambda: junet.StoryUNet(_UNET),
        (np.zeros((1, 5, 8, 8, 9), _f32), np.zeros((1,), np.int32),
         np.zeros((1, 5, 7, 24), _f32)),
        lambda: tunet.StoryUNet(port_config(_UNET)),
        lambda p: bridge.unet_state_dict(p, port_config(_UNET)),
        # convert_rcdms_unet3d has no mid-block temporal module (the
        # reference has none); it is checked through the strict load
        lambda sd: convert.convert_rcdms_unet3d(sd, _UNET),
        ("mid_temporal",)),
    "prior": (
        lambda: jprior.FramePrior(_PRIOR),
        (np.zeros((1, 5, 16), _f32), np.zeros((1, 5), np.int32),
         np.zeros((1, 5, 16), _f32), np.zeros((1, 5, 7, 16), _f32),
         np.zeros((1, 5, 16), _f32), np.zeros((1, 5, 16), _f32),
         np.ones((1, 5, 7), bool)),
        lambda: tprior.FramePrior(port_config(_PRIOR)),
        lambda p: bridge.prior_state_dict(p, port_config(_PRIOR)),
        lambda sd: convert.convert_rcdms_prior(sd, _PRIOR), ()),
    "vae": (
        lambda: jvae.VAE(_VAE),
        (np.zeros((1, 32, 32, 3), _f32), np.zeros((1, 16, 16, 4), _f32)),
        lambda: tvae.VAE(port_config(_VAE)),
        lambda p: bridge.vae_state_dict(p, port_config(_VAE)),
        lambda sd: convert.convert_sd_vae(sd, _VAE), ()),
    "clip_text": (
        lambda: jclip.CLIPTextEncoder(_TEXT),
        (np.zeros((1, 7), np.int32),),
        lambda: tclip.CLIPTextEncoder(port_config(_TEXT)),
        bridge.clip_text_state_dict,
        lambda sd: convert.convert_clip_text(sd, _TEXT), ()),
    "clip_vision": (
        lambda: jclip.CLIPVisionEncoder(_VISION),
        (np.zeros((1, 28, 28, 3), _f32),),
        lambda: tclip.CLIPVisionEncoder(port_config(_VISION)),
        bridge.clip_vision_state_dict,
        lambda sd: convert.convert_clip_vision(sd, _VISION), ()),
    "fusion": (
        lambda: jfusion.FusionModule(_FUSION),
        (np.zeros((1, 5, 5, 16), _f32), np.zeros((1, 5, 16), _f32),
         np.zeros((1, 5, 7, 24), _f32), np.zeros((1, 5), bool)),
        lambda: tfusion.FusionModule(port_config(_FUSION)),
        bridge.fusion_state_dict, _fusion_back, ()),
}


@pytest.mark.parametrize("tower", sorted(CASES))
def test_bridge_round_trip(tower):
    jmodule, args, tmodule, to_sd, back, not_converted = CASES[tower]
    params = _flax_tree(jmodule(), *args)
    sd = to_sd(params)
    module = tmodule()
    bridge.load_state_dict(module, sd)  # strict: names and shapes match
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    want = {k: v for k, v in params.items() if k not in not_converted}
    _assert_same_tree(back(sd), want)


_GUARD = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "transformers")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import torch
    import rcdms_tpu_torch
    from rcdms_tpu_torch.sample.pipeline import build_tiny_pipeline

    pipe, inputs = build_tiny_pipeline(num_steps=1)
    frames, embeds = pipe.generate(inputs,
                                   generator=torch.Generator().manual_seed(0))
    assert frames.shape == (1, 5, 32, 32, 3), frames.shape
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ok")
""")


def test_port_imports_without_jax_flax_transformers():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
