"""The port's parity gate (rcdms_tpu_torch/tools/parity_check.py) against
the JAX package's (`tools/parity_check.py`) on the CPU.

* `run_torch_side` on `tools/capture_ref_noise.py::self_test`'s npz (the
  JAX pipeline's conditioning, noise and outputs, built by
  test_torch_pipeline.py's `build_story` on the port's seeded weights)
  gives the JAX `reference_prior_embeds` and `reference_latents` within
  that file's SAMPLER_TOL;
* `_reference_check` passes there, and fails on reference latents with
  one frame replaced;
* the fusion does not read image_proj at a known frame: the JAX tool's
  whole prior output and the pipeline's rule give the same latents bit
  for bit (and the JAX fusion the same context);
* `_frame_ssim`, `_cos` and `_delta_row` equal the JAX helpers on the
  same arrays;
* the synthetic gate on the CPU passes, its report holding the JAX
  report's keys, rows and row keys (the JAX report's are those of its
  `run_gate` with the builds and runs stubbed, so nothing compiles), and
  --device cuda without a card raises;
* the weights mode's HF rows: the port's towers against tiny seeded
  `transformers` CLIP towers saved in the weights layout pass (outputs
  within 5e-4), a vision MLP the towers cannot hold fails, naming the
  load's error, and a missing transformers or weights directory skips,
  naming it.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.models.fusion import FusionModule as JFusion
from rcdms_tpu_torch.tools import parity_check
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)
from tests.test_torch_pipeline import SAMPLER_TOL, build_story

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import parity_check as jparity  # noqa: E402


@pytest.fixture(scope="module")
def story(tmp_path_factory):
    """(npz path, the port pipeline, the JAX params and pipeline, the
    self_test arrays)."""
    path = str(tmp_path_factory.mktemp("selftest") / "ref.npz")
    port, _, params, jpipe, arrays = build_story(path)
    return path, port, params, jpipe, arrays


def test_run_torch_side_matches_self_test(story):
    path, port, _, _, a = story
    embeds, latents = parity_check.run_torch_side(path, port)
    assert embeds.dtype == latents.dtype == np.float32
    np.testing.assert_allclose(embeds, a["reference_prior_embeds"],
                               **SAMPLER_TOL)
    np.testing.assert_allclose(latents, a["reference_latents"],
                               **SAMPLER_TOL)


def test_reference_check_passes_and_fails_on_one_frame(story, tmp_path):
    path, port, _, _, a = story
    row = parity_check._reference_check(path, port)
    assert row["status"] == "measured" and row["passed"] is True
    assert row["ssim_min"] >= 0.99 and row["prior_cos"] >= 0.999

    bad = dict(a)
    ref = a["reference_latents"].copy()
    ref[0, 2] = np.random.default_rng(0).standard_normal(ref[0, 2].shape)
    bad["reference_latents"] = ref
    bad_path = str(tmp_path / "bad.npz")
    np.savez(bad_path, **bad)
    row = parity_check._reference_check(bad_path, port)
    assert row["passed"] is False
    assert row["ssim_per_frame"][2] < 0.99
    assert min(row["ssim_per_frame"][:2] + row["ssim_per_frame"][3:]) >= 0.99


def test_fusion_does_not_read_image_proj_at_known_frames(story):
    """`parity_check.py::run_jax_side` passes the prior's whole output as
    image_proj, the pipeline `where(known, image_embed, prior output)`:
    the same latents, since both fusions take the seen stack at a known
    frame."""
    _, port, params, jpipe, a = story
    _, cond = parity_check.conditioning_from_npz(a,
                                                 a["reference_prior_embeds"])
    whole = cond._replace(image_proj=torch.tensor(
        a["reference_prior_embeds"]))
    assert not torch.equal(whole.image_proj, cond.image_proj)
    init = torch.from_numpy(a["story_init_latents"])
    assert torch.equal(port.story_sampler(cond, init),
                       port.story_sampler(whole, init))

    fusion = JFusion(jpipe.story_sampler.fusion.cfg)
    args = [jnp.asarray(a["story_image_tokens"]), None,
            jnp.asarray(a["story_text_hidden"]),
            jnp.asarray(a["story_frame_known"])]
    ctx = []
    for proj in (cond.image_proj, whole.image_proj):
        args[1] = jnp.asarray(proj.numpy())
        ctx.append(np.asarray(fusion.apply(params["fusion"], *args)))
    np.testing.assert_array_equal(ctx[0], ctx[1])


def test_metric_helpers_equal_jax():
    rng = np.random.default_rng(3)
    fa = rng.uniform(0, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    fb = np.clip(fa + 0.05 * rng.standard_normal(fa.shape), 0,
                 1).astype(np.float32)
    ea, eb = (rng.standard_normal((1, 5, 8)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(parity_check._frame_ssim(fa, fb),
                               jparity._frame_ssim(fa, fb), rtol=1e-12)
    assert parity_check._cos(ea, eb) == jparity._cos(ea, eb)
    assert parity_check._delta_row(fa, ea, fb, eb) == jparity._delta_row(
        fa, ea, fb, eb)


def _jax_report_shape(monkeypatch) -> dict:
    """The JAX `run_gate`'s report in synthetic mode, its builds and
    generates stubbed (fixed arrays; int8 differs from bf16)."""
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    embeds = rng.standard_normal((1, 5, 8)).astype(np.float32)
    calls = []

    def generate(*a, prop=0):
        calls.append(prop)
        # the 4th run is the int8 one
        return (frames * 0.9 if len(calls) == 4 else frames), embeds

    monkeypatch.setattr(jparity, "_build", lambda *a: (None, None, None))
    monkeypatch.setattr(jparity, "_generate", generate)
    return jparity.run_gate(None, None, "pororosv", 2, 2.0)


def _shape(report: dict):
    return (sorted(report), {name: sorted(row) for name, row in
                             report["checks"].items()})


def test_synthetic_gate_passes_with_the_jax_report_keys(tmp_path,
                                                        monkeypatch):
    out = str(tmp_path / "report.json")
    assert parity_check.main(["--synthetic", "--device", "cpu",
                              "--out", out]) == 0
    with open(out) as fh:
        report = json.load(fh)
    assert report["gate"] == "PASS" and report["mode"] == "synthetic"
    checks = report["checks"]
    assert checks["determinism_fp32"]["identical"] is True
    assert checks["int8_vs_bf16"]["engaged"] is True
    for name in ("bf16_vs_fp32", "int8_vs_bf16", "encoder_prop2_vs_bf16"):
        row = checks[name]
        assert row["status"] == "measured" and len(row["ssim_per_frame"]) == 5
        assert all(np.isfinite(row["ssim_per_frame"] + [row["prior_cos"]]))
    assert checks["int8_vs_bf16"]["ssim_min"] < 1.0
    assert _shape(report) == _shape(_jax_report_shape(monkeypatch))


def _tiny_hf_towers(root, vision_mlp: int = 128):
    """Seeded tiny `transformers` CLIP towers with projection, saved where
    the weights mode reads the bigG ones (gelu, as bigG; the vision MLP
    4 x the width unless `vision_mlp` says otherwise)."""
    import transformers

    torch.manual_seed(0)
    text = transformers.CLIPTextModelWithProjection(
        transformers.CLIPTextConfig(
            vocab_size=49408, hidden_size=32, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, projection_dim=16,
            hidden_act="gelu", eos_token_id=49407, bos_token_id=49406))
    vision = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=32,
            intermediate_size=vision_mlp, num_hidden_layers=2,
            num_attention_heads=4, projection_dim=16, hidden_act="gelu"))
    for model, sub in ((text, "text_encoder"), (vision, "image_encoder")):
        model.save_pretrained(os.path.join(root, "kandinsky-2-2-prior", sub),
                              safe_serialization=False)


def test_hf_rows_pass_on_tiny_transformers_towers(tmp_path):
    _tiny_hf_towers(str(tmp_path))
    for tower in ("text", "vision"):
        row = parity_check._hf_parity_check(str(tmp_path), tower, "cpu")
        assert row["status"] == "passed", row
        assert max(v for k, v in row.items() if k != "status") < 5e-4


def test_hf_row_fails_on_a_vision_mlp_the_tower_lacks(tmp_path):
    """The towers' MLP is 4 x the width (the JAX package's too); ViT-bigG's
    is 8192 on 1664: the row fails, naming the load's error."""
    _tiny_hf_towers(str(tmp_path), vision_mlp=160)
    row = parity_check._hf_parity_check(str(tmp_path), "vision", "cpu")
    assert row["status"] == "failed" and "cannot take" in row["reason"]


@pytest.mark.parametrize("missing", ["transformers", "weights"])
def test_hf_rows_skip_naming_what_is_missing(tmp_path, monkeypatch,
                                             missing):
    if missing == "transformers":
        monkeypatch.setitem(sys.modules, "transformers", None)
    row = parity_check._hf_parity_check(str(tmp_path), "text", "cpu")
    assert row["status"] == "skipped"
    assert (missing in row["reason"] if missing == "transformers"
            else "text_encoder" in row["reason"])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_check.main(["--synthetic"])
