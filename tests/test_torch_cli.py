"""The port's entry points (rcdms_tpu_torch/cli/) and their `--config`
YAML loader (rcdms_tpu_torch/reference_yaml.py), on the CPU.

The slice as a whole: synthetic pretrained directories (CLIP text towers
with tables to resize, CLIP vision, SD VAE and UNet) and trained reference
blobs (a stage-1 prior .pt, a stage-2 DeepSpeed directory) go through both
packages' `evaluate.build_pipeline` at the `--synthetic` configs. Both load
the same tensors; both `build_story_inputs` give the same inputs for the
same captions and reference image; both cond caches agree within 1e-5;
and with the noise of `tools/capture_ref_noise.py::self_test` injected, as
tests/test_torch_pipeline.py injects it, the port's stage-1 embeds and
frames agree with the JAX package's within that file's tolerances (5e-4,
1e-3; fp32).

Then both CLIs end to end on `--synthetic --device cpu`: the files they
write, the caption-count check before the build, the flags left for later
and the default device, which is cuda and never falls back to the CPU."""

import dataclasses
import json
import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rcdms_tpu.cli import common as jcommon
from rcdms_tpu.cli import evaluate as jevaluate
from rcdms_tpu.configs import reference_yaml as jyaml
from rcdms_tpu.models.vae import VAE as JVAE
from rcdms_tpu.sample import pipeline as jpipeline
from rcdms_tpu_torch import reference_yaml as pyaml
from rcdms_tpu_torch.cli import common as pcommon
from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.cli import generate as pgenerate
from rcdms_tpu_torch.configs import StoryUNetConfig
from rcdms_tpu_torch.core.schedulers import DDIMSchedule
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.models.vae import VAE
from rcdms_tpu_torch.sample.pipeline import StoryNoise
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_models import _weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import capture_ref_noise  # noqa: E402

STEPS = 2
SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
FRAME_TOL = dict(atol=1e-3, rtol=1e-3)
CAPTIONS = ["Fred waves hello", "barney builds a snowman", "wilma joins in",
            "they laugh", "the sun sets over bedrock"]


def _save(sd, path, module=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"module": tensors} if module else tensors, path)


def _synthetic_files(root, configs):
    """Pretrained directories and trained blobs for the --synthetic
    configs: the text tables start at CLIP's 49408 x 77 and are resized
    to the configs' 49500 x 91 on load."""
    def small_text(cfg, seed):
        src = dataclasses.replace(cfg, vocab_size=49408, max_positions=77)
        return _weights(CLIPTextEncoder(src), seed)

    _save(small_text(configs.text_s1, 1),
          os.path.join(root, "text_s1", "pytorch_model.bin"))
    _save(small_text(configs.text_s2, 2),
          os.path.join(root, "sd", "text_encoder", "pytorch_model.bin"))
    _save(_weights(CLIPVisionEncoder(configs.vision), 3),
          os.path.join(root, "vision", "pytorch_model.bin"))
    _save(_weights(VAE(configs.vae), 4),
          os.path.join(root, "sd", "vae", "diffusion_pytorch_model.bin"))
    sd_unet = {k: v for k, v in _weights(StoryUNet(configs.unet), 5).items()
               if ".motion_modules." not in k and not k.startswith("conv_in")}
    _save(sd_unet, os.path.join(root, "sd", "unet",
                                "diffusion_pytorch_model.bin"))
    _save({f"module.{k}": v for k, v in
           _weights(FramePrior(configs.prior), 6).items()},
          os.path.join(root, "stage1.pt"), module=True)
    stage2 = {f"unet.{k}": v for k, v in
              _weights(StoryUNet(configs.unet), 7).items()}
    stage2.update(_weights(FusionModule(configs.fusion), 8))
    _save(stage2, os.path.join(root, "stage2", "step9",
                               "mp_rank_00_model_states.pt"), module=True)
    with open(os.path.join(root, "stage2", "latest"), "w") as fh:
        fh.write("step9")


def _flags(root):
    return ["--synthetic", "--num-inference-steps", str(STEPS),
            "--sd-pretrained", os.path.join(root, "sd"),
            "--text-s1-pretrained", os.path.join(root, "text_s1"),
            "--vision-pretrained", os.path.join(root, "vision"),
            "--rcdms-stage1-ckpt", os.path.join(root, "stage1.pt"),
            "--rcdms-stage2-ckpt", os.path.join(root, "stage2")]


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("weights"))
    configs = pevaluate._configs(pevaluate.parse_args(["--synthetic"]))[2]
    _synthetic_files(root, configs)
    jpipe, jparams, jdataset, jds_cfg = jevaluate.build_pipeline(
        jevaluate.parse_args(_flags(root)))
    pipe, dataset, ds_cfg = pevaluate.build_pipeline(
        pevaluate.parse_args(_flags(root) + ["--device", "cpu"]))
    ref = np.random.RandomState(11).randint(0, 256, (97, 131, 3), np.uint8)
    jinputs = jcommon.build_story_inputs(CAPTIONS, [ref], "", jdataset,
                                         jds_cfg)
    inputs = pcommon.build_story_inputs(CAPTIONS, [ref], "", dataset, ds_cfg,
                                        "cpu")
    return dict(jpipe=jpipe, jparams=jparams, jdataset=jdataset,
                jds_cfg=jds_cfg, jinputs=jinputs, pipe=pipe,
                dataset=dataset, ds_cfg=ds_cfg, inputs=inputs)


def test_both_loaders_give_the_same_tensors(slice_):
    pipe = slice_["pipe"]
    want = bridge.pipeline_state_dicts(slice_["jparams"], pipe.configs)
    for tower, sd in want.items():
        got = getattr(pipe, tower).state_dict()
        assert set(got) == set(sd), tower
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v,
                                          err_msg=f"{tower}.{k}")
    assert pipe.text_s1.text_model.embeddings.token_embedding.weight.shape \
        == (49500, 16)


def test_build_story_inputs_equal_jax(slice_):
    got, want = slice_["inputs"], slice_["jinputs"]
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert got.tokens_s1.dtype == torch.long
    assert got.frame_known[0].tolist() == [True] + [False] * 4


def test_cond_cache_matches_precompute_cond_cache(slice_):
    jcache = jcommon.build_cond_cache(slice_["jpipe"], slice_["jparams"],
                                      slice_["jdataset"], slice_["jds_cfg"])
    cache = pcommon.build_cond_cache(slice_["pipe"], slice_["dataset"],
                                     slice_["ds_cfg"])
    assert cache._fields == jcache._fields
    for name in jcache._fields:
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(getattr(jcache, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_cond_cache_takes_each_stage_its_own_row(slice_):
    pipe, ds_cfg = slice_["pipe"], slice_["ds_cfg"]
    tok = slice_["dataset"].tokenizer
    row1, row2 = (tok([t])["input_ids"][0] for t in ("", "a negative one"))
    cache = pcommon.cond_cache_from_row(pipe, ds_cfg, row1, row2)
    with torch.no_grad():
        h1, e1 = pipe.text_s1(torch.from_numpy(row1).long()[None])
        h2, _ = pipe.text_s2(torch.from_numpy(row2).long()[None])
    torch.testing.assert_close(cache.s1_hidden_u, h1[0])
    torch.testing.assert_close(cache.s1_embed_u, e1[0])
    torch.testing.assert_close(cache.s2_hidden_u, h2[0])


def test_slice_matches_jax_on_injected_noise(slice_, tmp_path):
    """Stage-1 embeds and frames of the port's generate against the JAX
    samplers and VAE on the same loaded weights, inputs and noise."""
    jpipe, jparams = slice_["jpipe"], slice_["jparams"]

    def fake_builder(**kw):
        assert kw.get("num_steps") == STEPS
        return jpipe, jparams, slice_["jinputs"]

    real = jpipeline.build_tiny_pipeline
    jpipeline.build_tiny_pipeline = fake_builder
    try:
        a = capture_ref_noise.self_test(str(tmp_path / "ref.npz"),
                                        steps=STEPS)
    finally:
        jpipeline.build_tiny_pipeline = real

    pipe, inputs = slice_["pipe"], slice_["inputs"]
    b, f = inputs.frame_known.shape
    rng = np.random.RandomState(42)  # self_test's draw order
    d = pipe.configs.prior.embedding_dim
    prior_init = rng.randn(b, f, d).astype(np.float32)
    prior_steps = rng.randn(STEPS, b, f, d).astype(np.float32)
    h8 = a["reference_latents"].shape[2]
    vae = rng.randn(b * f, h8, h8, 4).astype(np.float32)
    story_init = rng.randn(*a["reference_latents"].shape).astype(np.float32)
    np.testing.assert_array_equal(story_init, a["story_init_latents"])

    frames, embeds = pipe.generate(inputs, noise=StoryNoise(*map(
        torch.from_numpy, (prior_init, prior_steps, vae, story_init))))
    np.testing.assert_allclose(embeds.numpy(), a["reference_prior_embeds"],
                               **SAMPLER_TOL)
    z = a["reference_latents"].reshape((b * f, h8, h8, 4)) / pipe.vae_scale
    decode = jax.jit(lambda zi: jpipe.vae.apply(jparams["vae"], zi,
                                                method=JVAE.decode))
    ref = np.concatenate([np.asarray(decode(zi[None])) for zi in z])
    ref = np.clip(ref / 2 + 0.5, 0.0, 1.0).reshape(frames.shape)
    assert frames.shape == (1, 5, 64, 64, 3)
    np.testing.assert_allclose(frames.numpy(), ref, **FRAME_TOL)


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------

SUMMARY_KEYS = {"num_stories", "mean_clip_cosine", "elapsed_s",
                "stories_per_s", "mean_ssim", "mean_psnr"}
CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "1"]


def _read_metrics(out):
    with open(os.path.join(out, "metrics_0.jsonl")) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    with open(os.path.join(out, "summary_0.json")) as fh:
        return lines, json.load(fh)


@pytest.mark.parametrize("mode", ["continue", "visualization"])
def test_evaluate_writes_metrics_and_grids(tmp_path, mode):
    out = str(tmp_path / "out")
    pevaluate.main(CPU + ["--mode", mode, "--output-dir", out,
                          "--num-stories", "2"])
    lines, summary = _read_metrics(out)
    assert [m["story"] for m in lines] == [0, 1]
    for m in lines:
        assert set(m) == {"story", "ssim", "psnr", "clip_cosine"}
        assert all(np.isfinite(v) for v in m.values())
    assert set(summary) == SUMMARY_KEYS and summary["num_stories"] == 2
    assert all(np.isfinite(v) for v in summary.values())
    for i in range(2):
        with Image.open(os.path.join(out, f"story_{i}.png")) as im:
            assert im.size == (5 * 64, 2 * 64)
        for j in range(5):
            assert os.path.exists(os.path.join(out, f"story_{i}_frame{j}.png"))


def test_evaluate_story_noise_does_not_depend_on_the_shard(tmp_path):
    """Story 1 alone in shard 1 of 2 gets the frames it gets in the whole
    run: each story's generator is seeded from (--seed, index)."""
    full, shard = str(tmp_path / "full"), str(tmp_path / "shard")
    pevaluate.main(CPU + ["--output-dir", full, "--num-stories", "2"])
    pevaluate.main(CPU + ["--output-dir", shard, "--num-stories", "2",
                          "--num-shards", "2", "--shard-id", "1"])
    with open(os.path.join(shard, "metrics_1.jsonl")) as fh:
        assert [json.loads(line)["story"] for line in fh] == [1]
    a, b = (np.asarray(Image.open(os.path.join(d, "story_1.png")))
            for d in (full, shard))
    np.testing.assert_array_equal(a, b)
    assert pcommon.story_seed(42, 1) != pcommon.story_seed(42, 0) != \
        pcommon.story_seed(43, 0)


def test_generate_writes_the_story(tmp_path):
    ref = str(tmp_path / "ref.png")
    Image.fromarray(np.random.RandomState(2).randint(
        0, 256, (40, 50, 3), np.uint8)).save(ref)
    out = str(tmp_path / "gen" / "story.png")
    argv = sum((["--caption", c] for c in CAPTIONS), []) + [
        "--reference", ref, "--out", out] + CPU
    pgenerate.main(argv)
    with Image.open(out) as im:
        assert im.size == (5 * 64, 64)
    assert sorted(os.listdir(tmp_path / "gen")) == ["story.png"] + [
        f"story_frame{i}.png" for i in range(5)]


def test_generate_run_returns_frames_and_embeds():
    ev = pevaluate.parse_args(CPU)
    ref = np.random.RandomState(3).randint(0, 256, (64, 64, 3), np.uint8)
    frames, embeds = pgenerate.run(ev, CAPTIONS, [ref])
    assert frames.shape == (1, 5, 64, 64, 3) and embeds.shape == (1, 5, 16)
    assert torch.isfinite(frames).all() and frames.min() >= 0 \
        and frames.max() <= 1
    again, _ = pgenerate.run(ev, CAPTIONS, [ref])
    torch.testing.assert_close(again, frames, rtol=0, atol=0)


@pytest.mark.parametrize("captions,refs", [(4, 0), (6, 0), (5, 6)])
def test_generate_checks_counts_before_the_build(monkeypatch, captions,
                                                 refs):
    def no_build(_):
        raise AssertionError("built the pipeline")

    monkeypatch.setattr(pgenerate, "build_pipeline", no_build)
    ev = pevaluate.parse_args(CPU)
    with pytest.raises(SystemExit, match="caption|reference"):
        pgenerate.run(ev, ["c"] * captions,
                      [np.zeros((8, 8, 3), np.uint8)] * refs)
    argv = sum((["--caption", "c"] for _ in range(captions)), [])
    argv += sum((["--reference", "missing.png"] for _ in range(refs)), [])
    with pytest.raises(SystemExit, match="caption|reference"):
        pgenerate.main(argv + CPU)


@pytest.mark.parametrize("flag", [["--shard-story"]])
def test_flags_left_for_later_are_rejected(flag, capsys):
    """--shard-story, once left for later, parses in evaluate, generate
    (sharded single-story inference, tests/test_torch_sharded_inference.py)
    and serve (one server over the ranks, tests/
    test_torch_serve_sharded.py); off by default in each."""
    from rcdms_tpu_torch.cli import serve as pserve

    assert pevaluate.parse_args(CPU + flag).shard_story
    assert pgenerate.parse_args(["--caption", "c"] + CPU + flag
                                ).eval.shard_story
    assert pserve.parse_args(CPU + flag).eval.shard_story
    assert not pevaluate.parse_args(CPU).shard_story
    assert not pserve.parse_args(CPU).eval.shard_story
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("flag,dest", [
    ("--stage1-ckpt", "stage1_ckpt"), ("--stage2-ckpt", "stage2_ckpt"),
    ("--converted-ckpt", "converted_ckpt")])
def test_training_checkpoint_flags_parse(flag, dest):
    """The flags that read the training CLIs' and convert's checkpoints
    parse in evaluate, generate and serve (serve and generate take
    evaluate's model flags), default None."""
    from rcdms_tpu_torch.cli import serve as pserve

    assert getattr(pevaluate.parse_args(CPU), dest) is None
    assert getattr(pevaluate.parse_args(CPU + [flag, "d"]), dest) == "d"
    assert getattr(pgenerate.parse_args(
        ["--caption", "c"] + CPU + [flag, "d"]).eval, dest) == "d"
    assert getattr(pserve.parse_args(CPU + [flag, "d"]).eval, dest) == "d"


def test_default_device_is_cuda_without_fallback():
    args = pevaluate.parse_args(["--synthetic"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pevaluate.build_pipeline(args)


# ---------------------------------------------------------------------------
# --config YAML
# ---------------------------------------------------------------------------

TRAINING_YAML = textwrap.dedent("""\
    unet_additional_kwargs:
      use_motion_module              : true
      motion_module_resolutions      : [ 1,2,4,8 ]
      unet_use_cross_frame_attention : false
      unet_use_temporal_attention    : false
      motion_module_type: Vanilla
      motion_module_kwargs:
        num_attention_heads                : 8
        num_transformer_block              : 1
        attention_block_types              : [ "Temporal_Self", "Temporal_Self" ]
        temporal_position_encoding         : true
        temporal_position_encoding_max_len : 5
        temporal_attention_dim_div         : 1
        zero_initialize                    : true
""")

TESTING_TAIL = textwrap.dedent("""\

    noise_scheduler_kwargs:
      beta_start: 0.00085
      beta_end: 0.012
      beta_schedule: "linear"
""")


def _write(tmp_path, text, name="cfg.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _both(path):
    (po, ps), (jo, js) = (pyaml.parse_reference_yaml(path),
                          jyaml.parse_reference_yaml(path))
    assert set(po) == set(jo)
    for k, v in jo.items():
        assert po[k] == (port_config(v) if dataclasses.is_dataclass(v)
                         else v), k
    assert (ps is None) == (js is None)
    if js is not None:  # every field of the port's schedule is the JAX one's
        for k, v in dataclasses.asdict(ps).items():
            assert getattr(js, k) == v, k
    return po, ps


@pytest.mark.parametrize("text", [
    TRAINING_YAML, TRAINING_YAML + TESTING_TAIL,
    "unet_additional_kwargs:\n  use_motion_module: false\n", TESTING_TAIL,
    ""], ids=["training", "testing", "motion_off", "scheduler_only", "empty"])
def test_yaml_maps_like_jax(tmp_path, text):
    overrides, sched = _both(_write(tmp_path, text))
    if "noise_scheduler_kwargs" in text:
        assert sched == DDIMSchedule.stage2_inference()
    if "use_motion_module: false" in text:
        assert overrides == {"use_temporal": False}
    if "motion_module_kwargs" in text:
        t = overrides["temporal"]
        assert (t.num_heads, t.num_blocks, t.attn_layers_per_block,
                t.max_frames) == (8, 1, 2, 5)
        ucfg = pyaml.apply_to_unet_config(StoryUNetConfig(), overrides)
        assert ucfg.temporal == t
        assert dataclasses.replace(ucfg, temporal=StoryUNetConfig().temporal,
                                   use_temporal=True) == StoryUNetConfig()


@pytest.mark.parametrize("find,repl,match", [
    ("unet_use_cross_frame_attention : false",
     "unet_use_cross_frame_attention : true", "SparseCausal"),
    ("unet_use_temporal_attention    : false",
     "unet_use_temporal_attention    : true", "unet_use_temporal_attention"),
    ("motion_module_type: Vanilla", "motion_module_type: Fancy", "Vanilla"),
    ("[ 1,2,4,8 ]", "[ 1,2 ]", "resolutions"),
    ("temporal_attention_dim_div         : 1",
     "temporal_attention_dim_div         : 2", "dim_div"),
    ('[ "Temporal_Self", "Temporal_Self" ]',
     '[ "Temporal_Cross", "Temporal_Self" ]', "Temporal_Self"),
])
def test_yaml_unsupported_settings_raise_like_jax(tmp_path, find, repl,
                                                  match):
    path = _write(tmp_path, TRAINING_YAML.replace(find, repl, 1))
    with pytest.raises(jyaml.UnsupportedReferenceConfig, match=match):
        jyaml.parse_reference_yaml(path)
    with pytest.raises(pyaml.UnsupportedReferenceConfig, match=match):
        pyaml.parse_reference_yaml(path)


def test_config_reaches_the_pipeline(tmp_path):
    text = ("unet_additional_kwargs:\n  use_motion_module: false\n"
            + TESTING_TAIL.replace("0.012", "0.02"))
    args = pevaluate.parse_args(CPU + ["--config", _write(tmp_path, text)])
    pipe, _, _ = pevaluate.build_pipeline(args)
    assert not pipe.configs.unet.use_temporal
    assert not pipe.configs.prior.use_temporal
    assert not any(".motion_modules." in k for k in pipe.unet.state_dict())
    assert pipe.story_sampler.schedule == DDIMSchedule(
        beta_schedule="linear", beta_start=0.00085, beta_end=0.02)
    assert pipe.story_sampler.num_steps == 1
    out = str(tmp_path / "out")
    pevaluate.main(CPU + ["--config", args.config, "--output-dir", out,
                          "--num-stories", "1"])
    assert _read_metrics(out)[1]["num_stories"] == 1
