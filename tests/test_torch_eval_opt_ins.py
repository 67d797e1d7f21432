"""The evaluate CLI's opt-ins on the CPU (`--synthetic --device cpu`):
`--autoreg` (stage 1 only, cosine metrics only), `--eval-batch` (each
story's metrics equal `--eval-batch 1`'s within 1e-5, the padded tail
discarded), `--encoder-propagation` and `--quantize int8`; and the
generate CLI reading `--reference` PNGs with Pillow blocked."""

import json
import os
import sys

import numpy as np
import pytest

from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.cli import generate as pgenerate
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.sample.eval import decode_png, encode_png
from tests.test_torch_configs import one_torch_thread  # noqa: F401

CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "1"]
CAPTIONS = ["Fred waves hello", "barney builds a snowman", "wilma joins in",
            "they laugh", "the sun sets over bedrock"]


@pytest.fixture(autouse=True)
def _exact_mode():
    try:
        yield
    finally:
        quant.set_quant_mode(None)


def _run(tmp_path, name, *flags, stories=5):
    out = str(tmp_path / name)
    summary = pevaluate.main(CPU + ["--output-dir", out, "--num-stories",
                                    str(stories), *flags])
    with open(os.path.join(out, "metrics_0.jsonl")) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    return lines, summary


@pytest.mark.parametrize("flags", [[], ["--autoreg"]],
                         ids=["story", "autoreg"])
def test_eval_batch_gives_each_story_its_batch_one_metrics(tmp_path, flags):
    one, _ = _run(tmp_path, "b1", *flags)
    three, summary = _run(tmp_path, "b3", "--eval-batch", "3", *flags)
    assert [m["story"] for m in three] == [0, 1, 2, 3, 4]  # tail discarded
    assert summary["num_stories"] == 5
    for a, b in zip(three, one):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_autoreg_writes_cosine_metrics_only(tmp_path):
    lines, summary = _run(tmp_path, "ar", "--autoreg", stories=2)
    assert [set(m) for m in lines] == [{"story", "clip_cosine"}] * 2
    assert set(summary) == {"num_stories", "mean_clip_cosine", "elapsed_s",
                            "stories_per_s"}
    assert all(np.isfinite(m["clip_cosine"]) for m in lines)
    assert not any(name.endswith(".png")
                   for name in os.listdir(tmp_path / "ar"))


def test_encoder_propagation_reaches_the_sampler(tmp_path):
    args = pevaluate.parse_args(CPU + ["--encoder-propagation", "2"])
    pipe = pevaluate.build_pipeline(args)[0]
    assert pipe.story_sampler.encoder_propagation == 2
    lines, summary = _run(tmp_path, "ep", "--encoder-propagation", "2",
                          stories=2)
    assert all(np.isfinite(v) for m in lines for v in m.values())
    assert np.isfinite(summary["mean_ssim"])


def test_quantize_int8_runs_the_int8_convs(tmp_path):
    calls = quant.int8_conv3x3.calls
    lines, summary = _run(tmp_path, "q", "--quantize", "int8", stories=2)
    assert quant.int8_enabled()
    # the tiny UNet's 64-channel level: 3x3 convs in both CFG branches
    assert quant.int8_conv3x3.calls > calls
    assert all(np.isfinite(v) for m in lines for v in m.values())


@pytest.mark.parametrize("flag", [
    ["--autoreg"], ["--encoder-propagation", "2"], ["--quantize", "int8"],
    ["--eval-batch", "2"]])
def test_opt_in_flags_parse_in_both_clis(flag):
    ev = pevaluate.parse_args(CPU + flag)
    gen = pgenerate.parse_args(["--caption", "c"] + CPU + flag).eval
    assert vars(ev) == vars(gen)
    assert ev.autoreg == (flag[0] == "--autoreg")


def test_generate_reads_reference_pngs_without_pillow(tmp_path, monkeypatch):
    ref = np.random.RandomState(2).randint(0, 256, (40, 50, 3), np.uint8)
    path = str(tmp_path / "ref.png")
    with open(path, "wb") as fh:
        fh.write(encode_png(ref))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    seen = []
    real = pgenerate.run
    monkeypatch.setattr(pgenerate, "run", lambda ev, caps, frames, neg:
                        seen.append(frames) or real(ev, caps, frames, neg))
    out = str(tmp_path / "gen" / "story.png")
    pgenerate.main(sum((["--caption", c] for c in CAPTIONS), [])
                   + ["--reference", path, "--out", out] + CPU)
    np.testing.assert_array_equal(seen[0][0], ref)
    with open(out, "rb") as fh:
        assert decode_png(fh.read()).shape == (64, 5 * 64, 3)


def test_generate_refuses_a_reference_that_is_not_png(tmp_path):
    path = str(tmp_path / "ref.jpg")
    with open(path, "wb") as fh:
        fh.write(b"\xff\xd8\xff\xe0 a jpeg header")
    with pytest.raises(ValueError, match="PNG"):
        pgenerate.main(sum((["--caption", c] for c in CAPTIONS), [])
                       + ["--reference", path, "--out",
                          str(tmp_path / "s.png")] + CPU)
