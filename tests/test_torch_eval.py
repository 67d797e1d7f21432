"""The port's eval metrics and story images (rcdms_tpu_torch/sample/eval.py)
against the JAX package's on the same inputs: cosine similarity, SSIM,
story_metrics, split_indices and the stage-1 accumulator within 1e-12,
and the PNGs of save_story_grid, read back with Pillow, pixel for pixel
(the JAX package writes them through Pillow, the port through its own
encoder)."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from rcdms_tpu.sample import eval as jeval
from rcdms_tpu_torch.sample import eval as peval

TOL = dict(rtol=1e-12, atol=1e-12)


def _story(seed, f=5, h=24, w=20):
    rng = np.random.RandomState(seed)
    return rng.rand(f, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
def test_cosine_similarity_matches_jax(axis):
    rng = np.random.RandomState(0)
    a, b = rng.randn(5, 16), rng.randn(5, 16)
    np.testing.assert_allclose(peval.cosine_similarity(a, b, axis),
                               jeval.cosine_similarity(a, b, axis), **TOL)


@pytest.mark.parametrize("shape", [(24, 20, 3), (32, 32), (8, 5, 3),
                                   (64, 48, 3)])
def test_ssim_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1)
    got, want = peval.ssim(a, b), jeval.ssim(a, b)
    np.testing.assert_allclose(got, want, **TOL)
    assert peval.ssim(a, a) == pytest.approx(1.0)


def test_ssim_rejects_what_jax_rejects():
    for a, b in (((2, 2), (2, 2)), ((8, 8), (8, 9))):
        for fn in (peval.ssim, jeval.ssim):
            with pytest.raises(ValueError):
                fn(np.zeros(a), np.zeros(b))


def test_story_metrics_match_jax():
    gen, gt = _story(1), _story(2)
    got, want = peval.story_metrics(gen, gt), jeval.story_metrics(gen, gt)
    assert set(got) == set(want) == {"ssim", "psnr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    same = peval.story_metrics(gen, gen)
    assert same["psnr"] == pytest.approx(100.0)


def test_accumulator_matches_jax():
    acc, jacc = peval.Stage1EvalAccumulator(), jeval.Stage1EvalAccumulator()
    rng = np.random.RandomState(3)
    for _ in range(3):
        a, b = rng.randn(5, 16), rng.randn(5, 16)
        np.testing.assert_allclose(acc.update(a, b), jacc.update(a, b), **TOL)
    assert acc.count == jacc.count == 15
    np.testing.assert_allclose(acc.mean, jacc.mean, **TOL)
    assert peval.Stage1EvalAccumulator().mean == 0.0


@pytest.mark.parametrize("n,shards", [(10, 3), (4, 1), (2, 4)])
def test_split_indices_match_jax(n, shards):
    for shard in range(shards):
        assert peval.split_indices(n, shard, shards) == \
            jeval.split_indices(n, shard, shards)


def _read(path):
    with Image.open(path) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


@pytest.mark.parametrize("with_gt", [True, False])
def test_save_story_grid_pixels_match_jax(tmp_path, with_gt):
    gen = _story(4) * 1.2 - 0.1  # values outside [0, 1] are clipped
    gt = _story(5) if with_gt else None
    mine, theirs = str(tmp_path / "p" / "s.png"), str(tmp_path / "j" / "s.png")
    peval.save_story_grid(mine, gen, gt)
    jeval.save_story_grid(theirs, gen, gt)
    grid = _read(mine)
    assert grid.shape == ((2 if with_gt else 1) * 24, 5 * 20, 3)
    np.testing.assert_array_equal(grid, _read(theirs))
    for i in range(5):
        np.testing.assert_array_equal(
            _read(str(tmp_path / "p" / f"s_frame{i}.png")),
            _read(str(tmp_path / "j" / f"s_frame{i}.png")))


def test_png_layout():
    img = np.random.RandomState(6).randint(0, 256, (7, 9, 3), np.uint8)
    data = peval.encode_png(img)
    assert data[:8] == peval.PNG_SIGNATURE
    length, kind = struct.unpack(">I4s", data[8:16])
    assert (length, kind) == (13, b"IHDR")
    assert struct.unpack(">IIBBBBB", data[16:29]) == (9, 7, 8, 2, 0, 0, 0)
    assert struct.unpack(">I", data[29:33])[0] == zlib.crc32(data[12:29])
    assert data.endswith(b"IEND" + struct.pack(">I", zlib.crc32(b"IEND")))
    with pytest.raises(ValueError):
        peval.encode_png(img[..., :2])


def test_save_story_grid_writes_into_the_working_directory(tmp_path,
                                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    peval.save_story_grid("story.png", _story(7, f=2))
    assert sorted(os.listdir(tmp_path)) == [
        "story.png", "story_frame0.png", "story_frame1.png"]
