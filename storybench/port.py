"""The system under test, `rcdms_tpu_torch`, as the benchmark drives it:
its pipeline built from a configuration file and loaded with the
benchmark's seeded weights, its `StoryServer`, and the spans the traced
run puts around its module and op calls. The only module of the harness
that imports the port."""

from __future__ import annotations

import contextlib
import sys

import torch
from torch.profiler import record_function

from rcdms_tpu_torch import configs as pc
from rcdms_tpu_torch.cli import serve
from rcdms_tpu_torch.core.layers import FeedForward
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.ops.attention import multihead_attention
from rcdms_tpu_torch.sample.pipeline import (
    PipelineConfigs,
    StoryInputs,
    StoryNoise,
    StoryPipeline,
    for_inference,
)

from storybench import traffic, work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _temporal(group: dict) -> pc.TemporalConfig:
    return pc.TemporalConfig(**group)


def pipeline_configs(cfg: dict) -> PipelineConfigs:
    """The port's config objects of a configuration file's groups."""
    prior = dict(cfg["prior"], temporal=_temporal(cfg["prior"]["temporal"]))
    unet = dict(cfg["unet"], temporal=_temporal(cfg["unet"]["temporal"]))
    for key in ("block_channels", "cross_attn_levels"):
        unet[key] = tuple(unet[key])
    vae = dict(cfg["vae"], block_channels=tuple(cfg["vae"]["block_channels"]))
    return PipelineConfigs(
        text_s1=pc.CLIPTextConfig(**cfg["text_s1"]),
        text_s2=pc.CLIPTextConfig(**cfg["text_s2"]),
        vision=pc.CLIPVisionConfig(**cfg["vision"]),
        vae=pc.VAEConfig(**vae), prior=pc.PriorConfig(**prior),
        unet=pc.StoryUNetConfig(**unet), fusion=pc.FusionConfig(**cfg["fusion"]))


def build(cfg: dict, weights: dict, device, quantize=None) -> StoryPipeline:
    """The port's pipeline at the configuration's sizes and sampling
    settings, holding `weights` (every parameter, by name), cast to the
    configuration's dtype by the port's own `for_inference`. `quantize`
    is the port's opt-in quant mode, set before the cast as it asks."""
    quant.set_quant_mode(quantize)
    device = torch.device(device)
    with device:
        pipe = StoryPipeline(pipeline_configs(cfg),
                             num_steps=cfg["ddim_steps"],
                             guidance_scale=cfg["guidance_scale"],
                             sequential_cfg=cfg["sequential_cfg"])
    pipe.load_state_dict(weights, strict=True)
    return for_inference(pipe, DTYPES[cfg["dtype"]])


def inputs(batch: dict, device) -> StoryInputs:
    return StoryInputs(**{k: v.to(device) for k, v in batch.items()})


def noise(batch: dict) -> StoryNoise:
    return StoryNoise(**batch)


def cond_cache(pipe: StoryPipeline, cfg: dict):
    """The port's CondCache of the traffic's negative prompt and mask
    images, as its CLIs make it once per model."""
    dev = pipe.device
    uncond = traffic.uncond_row(cfg["text_s1"]["max_positions"], dev)
    white, black = traffic.mask_images(cfg, dev)
    return pipe.precompute_cond_cache(uncond, uncond, white, black)


def dataset_config(cfg: dict) -> pc.DatasetConfig:
    return pc.DatasetConfig(name=cfg["dataset"],
                            image_size=cfg["image_size"],
                            clip_size=cfg["vision"]["image_size"],
                            num_frames=cfg["num_frames"])


def story_server(pipe: StoryPipeline, cfg: dict, mix: dict):
    """The port's `StoryServer` at the mix's batching settings, serving
    `pipe` (the benchmark's seeded weights) instead of the towers that
    `cli.evaluate.build_pipeline` would make."""
    real = serve.build_pipeline
    serve.build_pipeline = lambda args: (pipe, None, dataset_config(cfg))
    try:
        return serve.StoryServer(None, mix["max_batch"], mix["max_wait_ms"],
                                 mix["max_queue"])
    finally:
        serve.build_pipeline = real


def request_inputs(story_inputs: dict) -> StoryInputs:
    """A request's batch-1 inputs on the CPU, as the server's handlers
    hand them to `submit`."""
    return StoryInputs(**{k: v.cpu() for k, v in story_inputs.items()})


def build_library() -> None:
    """The port's kernel library: built with nvcc into
    `build/rcdms_tpu_torch/` on a checkout's first run, loaded after."""
    from rcdms_tpu_torch.ops import _build

    _build.library()


# ---- spans of the traced run -------------------------------------------------

SPAN = "storybench."


class Spans:
    """record_function spans around the port's calls, and the work of each
    attention and feed-forward call from its argument shapes:

      storybench.call       a `generate` call (the window's unit of work)
      storybench.unet       `StoryUNet.forward`
      storybench.prior      `FramePrior.forward`
      storybench.attention  `ops.attention.multihead_attention`, where any
                            module of the port calls it
      storybench.ff         `FeedForward.forward` (the fused FF, C / D)
      storybench.text / vision / vae / fusion   the towers, for labels
    """

    def __init__(self, pipe: StoryPipeline):
        self.pipe = pipe
        self.work = {"attention": [], "ff": []}
        self._hooks = []
        self._patched = []

    def _module(self, module, name, on_enter=None):
        state = []

        def pre(mod, args):
            if on_enter is not None:
                on_enter(mod, args)
            rf = record_function(SPAN + name)
            rf.__enter__()
            state.append(rf)

        def post(mod, args, out):
            state.pop().__exit__(None, None, None)

        self._hooks += [module.register_forward_pre_hook(pre),
                        module.register_forward_hook(post)]

    def _ff_work(self, mod, args):
        x = args[0]
        proj_in, proj_out = mod.net[0].proj, mod.net[2]
        self.work["ff"].append(work.ff(
            rows=x.numel() // x.shape[-1], c=x.shape[-1],
            up=proj_in.weight.shape[0], inner=proj_out.weight.shape[1],
            itemsize=proj_in.weight.element_size()))

    def __enter__(self):
        p = self.pipe
        self._module(p.unet, "unet")
        self._module(p.prior, "prior")
        for name in ("text_s1", "text_s2"):
            self._module(getattr(p, name), "text")
        self._module(p.vision, "vision")
        self._module(p.vae.encoder, "vae")
        self._module(p.vae.decoder, "vae")
        self._module(p.fusion, "fusion")
        for m in p.modules():
            if isinstance(m, FeedForward):
                self._module(m, "ff", self._ff_work)
        spans = self

        def traced_attention(q, k, v, heads, mask=None, **kw):
            spans.work["attention"].append(work.attention(
                q.shape, k.shape, heads, q.element_size(),
                None if mask is None else mask.numel() * mask.element_size()))
            with record_function(SPAN + "attention"):
                return multihead_attention(q, k, v, heads, mask, **kw)

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("rcdms_tpu_torch.")
                    and getattr(mod, "multihead_attention", None)
                    is multihead_attention):
                self._patched.append(mod)
                mod.multihead_attention = traced_attention
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        for mod in self._patched:
            mod.multihead_attention = multihead_attention
        return False


@contextlib.contextmanager
def call_span():
    with record_function(SPAN + "call"):
        yield
