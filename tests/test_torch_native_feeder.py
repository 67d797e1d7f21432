"""The port's binding of the native story feeder
(rcdms_tpu_torch/data/native_feeder.py), built here from
native/story_feeder.cpp with g++: its packs equal the port's numpy
protocol (rcdms_tpu_torch/data/protocol.py) and the JAX package's
`build_story_example` exactly, its bicubic and bilinear resizes equal the
numpy `_resize` and Pillow's, many stories packed across threads give
the same result, `StoryH5Dataset` batches are the same with and without
it, and a source that does not build raises."""

import ctypes
import itertools

import numpy as np
import pytest
from PIL import Image

from rcdms_tpu.configs import DatasetConfig as JDatasetConfig
from rcdms_tpu.data.protocol import StoryTokenizer as JTokenizer
from rcdms_tpu.data.protocol import build_story_example as jbuild
from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data import native_feeder
from rcdms_tpu_torch.data.protocol import (
    StoryTokenizer,
    _resize,
    build_story_example,
)

KEYS = ("target", "source", "reference_clip", "source_clip", "mask_clip",
        "mask_label")


def _native_resize(img: np.ndarray, oh: int, ow: int, filt: str
                   ) -> np.ndarray:
    """The feeder library's `resize_bicubic` / `resize_bilinear`."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    img = np.ascontiguousarray(img)
    out = np.empty((oh, ow, 3), np.uint8)
    getattr(native_feeder.load_library(), f"resize_{filt}")(
        img.ctypes.data_as(u8p), img.shape[0], img.shape[1], oh, ow,
        out.ctypes.data_as(u8p))
    return out


@pytest.fixture(scope="module")
def feeder():
    f = native_feeder.NativeFeeder(num_threads=2, buffer_depth=2)
    yield f
    f.close()


@pytest.mark.parametrize("filt,pil", [("bicubic", Image.BICUBIC),
                                      ("bilinear", Image.BILINEAR)])
@pytest.mark.parametrize("h,w,oh,ow", [(128, 128, 512, 512),
                                       (128, 128, 224, 224),
                                       (97, 133, 224, 307),
                                       (300, 200, 64, 64),
                                       (57, 91, 128, 128)])
def test_resize_equals_numpy_and_pillow(filt, pil, h, w, oh, ow):
    img = np.random.default_rng(h * w + oh).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    got = _native_resize(img, oh, ow, filt)
    np.testing.assert_array_equal(got, _resize(img, (oh, ow), filt))
    np.testing.assert_array_equal(got, np.asarray(
        Image.fromarray(img).resize((ow, oh), pil)))


@pytest.mark.parametrize("known", [0, 2, 5])
def test_pack_equals_the_port_and_jax_protocols(feeder, known):
    cfg = DatasetConfig(image_size=64, clip_size=28)
    jcfg = JDatasetConfig(image_size=64, clip_size=28)
    # non-square frames of another size take the whole resize path
    frames = np.random.RandomState(known).randint(0, 255, (5, 48, 80, 3),
                                                  np.uint8)
    out = feeder.pack_batch([frames], [known], size=64, csize=28)
    port = build_story_example(list(frames), ["c"] * 5, known,
                               StoryTokenizer(cfg), cfg=cfg)
    jax = jbuild(list(frames), ["c"] * 5, known, JTokenizer(jcfg), cfg=jcfg)
    for key in KEYS:
        assert out[key].dtype == np.float32 and not out[key].flags.writeable
        np.testing.assert_array_equal(out[key][0], port[key], err_msg=key)
        np.testing.assert_array_equal(out[key][0], jax[key], err_msg=key)
    assert out["frame_known"][0].tolist() == port["frame_known"].tolist() \
        == list(np.asarray(jax["frame_known"]))


def test_many_stories_across_threads(feeder):
    rng = np.random.RandomState(1)
    stories = [rng.randint(0, 255, (5, 32, 32, 3), np.uint8)
               for _ in range(8)]
    kls = [0, 1, 2, 3, 4, 0, 1, 2]
    wide = native_feeder.NativeFeeder(num_threads=4)
    out = wide.pack_batch(stories, kls, size=32, csize=28, copy=True)
    wide.close()
    assert out["target"].shape == (8, 5, 32, 32, 3)
    assert out["target"].flags.writeable
    for i, (story, kl) in enumerate(zip(stories, kls)):
        one = feeder.pack_batch([story], [kl], size=32, csize=28)
        for key in KEYS:
            np.testing.assert_array_equal(out[key][i], one[key][0],
                                          err_msg=f"{key} story {i}")
    np.testing.assert_array_equal(out["source"][0], -1.0)  # none known
    with pytest.raises(ValueError, match="known length"):
        feeder.pack_batch(stories[:1], [6], size=32, csize=28)
    with pytest.raises(ValueError, match="story 1"):
        feeder.pack_batch([stories[0], stories[1][:4]], [0, 0], size=32,
                          csize=28)


def test_the_ring_reuses_its_buffers_after_its_depth(feeder):
    rng = np.random.RandomState(2)
    a, b, c = (rng.randint(0, 255, (5, 16, 16, 3), np.uint8)
               for _ in range(3))
    first = feeder.pack_batch([a], [1], size=16, csize=28)
    kept = first["target"].copy()
    feeder.pack_batch([b], [1], size=16, csize=28)
    np.testing.assert_array_equal(first["target"], kept)  # depth 2: valid
    feeder.pack_batch([c], [1], size=16, csize=28)
    assert not np.array_equal(first["target"], kept)  # overwritten


def _write_tiny_h5(path, n=4, f=5, row=48):
    import cv2
    import h5py

    rng = np.random.RandomState(7)
    with h5py.File(path, "w") as hf:
        grp = hf.create_group("train")
        dt = h5py.vlen_dtype(np.uint8)
        for i in range(f):
            ds = grp.create_dataset(f"image{i}", (n,), dtype=dt)
            for j in range(n):
                # a stack of 2 candidate frames, JPEG-encoded
                img = rng.randint(0, 256, (2 * row, row, 3), np.uint8)
                ok, enc = cv2.imencode(".jpg", img)
                assert ok
                ds[j] = np.frombuffer(enc.tobytes(), np.uint8)
        texts = [("|".join(f"story {j} frame {i}" for i in range(f))).encode()
                 for j in range(n)]
        grp.create_dataset("text", data=texts)


def test_dataset_native_batches_equal_python(tmp_path):
    from rcdms_tpu_torch.data.datasets import StoryH5Dataset

    path = str(tmp_path / "tiny.h5")
    _write_tiny_h5(path)
    cfg = DatasetConfig(h5_path=path, image_size=64, clip_size=28)
    py = StoryH5Dataset(cfg, "train")
    nat = StoryH5Dataset(cfg, "train", use_native_feeder=True,
                         feeder_threads=2, feeder_buffer_depth=3)
    pairs = zip(py.batches(2, seed=3), nat.batches(2, seed=3))
    for b_py, b_nat in itertools.islice(pairs, 3):  # into the 2nd epoch
        assert set(b_py) == set(b_nat)
        for key in b_py:
            np.testing.assert_array_equal(b_py[key], b_nat[key],
                                          err_msg=key)


def test_a_source_that_does_not_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken_feeder.cpp"
    bad.write_text("extern \"C\" int feeder_create(int n) { return n +; }\n")
    with pytest.raises(native_feeder.FeederBuildError, match="error"):
        native_feeder.build_library(bad, tmp_path)
    # a dataset that asks for the feeder raises too: no numpy fallback
    from rcdms_tpu_torch.data.datasets import StoryH5Dataset

    monkeypatch.setattr(native_feeder, "SOURCE", bad)
    monkeypatch.setattr(native_feeder, "BUILD_DIR", tmp_path)
    with pytest.raises(native_feeder.FeederBuildError):
        StoryH5Dataset(DatasetConfig(h5_path="unused.h5"),
                       use_native_feeder=True)
    assert not native_feeder.available()
