"""The port's data protocol and datasets (rcdms_tpu_torch/data/) against
the JAX package's on the same inputs, bit for bit: the numpy resize
against Pillow, the CLIP and pixel preprocessing, the tokenizer's crc32
fallback, whole story examples, collate, and the h5 and synthetic
datasets."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from rcdms_tpu.configs import DatasetConfig as JDatasetConfig
from rcdms_tpu.data import datasets as jdatasets
from rcdms_tpu.data import protocol as jprotocol
from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data import datasets, protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (input h, w) -> (output h, w): up- and downscaling, odd and non-square
# sides, the story's own sizes (Flintstones rows of 128 to 224 and 512)
RESIZES = [((128, 128), (224, 224)), ((128, 128), (512, 512)),
           ((97, 131), (224, 302)), ((97, 131), (224, 224)),
           ((600, 400), (512, 512)), ((600, 400), (336, 224)),
           ((1000, 37), (224, 9)), ((5, 7), (3, 300))]


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("filt", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_equals_pillow(src, dst, filt):
    img = _image(*src, seed=src[0] + dst[1])
    pil = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[filt]
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], pil))
    got = protocol._resize(img, dst, filt)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_to_the_same_size_copies():
    img = _image(9, 11)
    out = protocol._resize(img, (9, 11))
    np.testing.assert_array_equal(out, img)
    assert out is not img


@pytest.mark.parametrize("shape", [(128, 128), (97, 131), (600, 400),
                                   (50, 50)])
@pytest.mark.parametrize("size", [224, 28])
def test_clip_preprocess_equals_jax(shape, size):
    img = _image(*shape, seed=size)
    got = protocol.clip_preprocess(img, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jprotocol.clip_preprocess(img, size))


@pytest.mark.parametrize("shape", [(128, 128), (97, 131), (600, 400)])
@pytest.mark.parametrize("size", [512, 64])
def test_pixel_preprocess_equals_jax(shape, size):
    img = _image(*shape, seed=size + 1)
    got = protocol.pixel_preprocess(img, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jprotocol.pixel_preprocess(img, size))


def test_protocol_runs_without_pillow():
    code = textwrap.dedent("""
        import sys
        sys.modules["PIL"] = None
        import numpy as np
        from rcdms_tpu_torch.configs import DatasetConfig
        from rcdms_tpu_torch.data import datasets, protocol
        from rcdms_tpu_torch.sample import eval as ev
        img = np.random.RandomState(0).randint(0, 256, (97, 131, 3),
                                               np.uint8)
        protocol.clip_preprocess(img, 224)
        protocol.pixel_preprocess(img, 64)
        ex = datasets.SyntheticStoryDataset().example(
            0, np.random.RandomState(0))
        ev.encode_png(img)
        print("ok", sorted(ex))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


CAPTIONS = [
    "Fred and Barney walk into the Slate quarry.",
    "",
    "WILMA laughs   at\tdino",
    " ".join(f"word{i}" for i in range(120)),  # past the max length
    "pororo, crong & eddy: snow!",
]


@pytest.mark.parametrize("dataset", ["flintstones", "pororosv"])
def test_tokenizer_fallback_equals_jax(dataset):
    got = protocol.StoryTokenizer(DatasetConfig(name=dataset))(CAPTIONS)
    want = jprotocol.StoryTokenizer(JDatasetConfig(name=dataset))(CAPTIONS)
    _assert_dicts_equal(got, want)
    assert got["input_ids"].shape == (5, {"flintstones": 91,
                                          "pororosv": 85}[dataset])
    assert protocol.StoryTokenizer(DatasetConfig()).eos_token_id == 49407


@pytest.mark.parametrize("known_length", [0, 1, 5])
def test_build_story_example_equals_jax(known_length):
    kw = dict(image_size=64, clip_size=28)
    cfg, jcfg = DatasetConfig(**kw), JDatasetConfig(**kw)
    frames = [_image(97, 131, seed=i) for i in range(5)]
    drop = [False, True, False, False, True]
    got = protocol.build_story_example(
        frames, CAPTIONS, known_length, protocol.StoryTokenizer(cfg),
        protocol.StoryTokenizer(cfg), cfg, text_drop_mask=drop)
    want = jprotocol.build_story_example(
        frames, CAPTIONS, known_length, jprotocol.StoryTokenizer(jcfg),
        jprotocol.StoryTokenizer(jcfg), jcfg, text_drop_mask=drop)
    _assert_dicts_equal(got, want)
    assert got["frame_known"].sum() == known_length


def test_collate_equals_jax():
    kw = dict(image_size=64, clip_size=28)
    ds = datasets.SyntheticStoryDataset(DatasetConfig(**kw))
    jds = jdatasets.SyntheticStoryDataset(JDatasetConfig(**kw))
    exs = [ds.example(i, np.random.RandomState(i)) for i in range(3)]
    jexs = [jds.example(i, np.random.RandomState(i)) for i in range(3)]
    _assert_dicts_equal(protocol.collate(exs), jprotocol.collate(jexs))


def test_synthetic_batches_equal_jax():
    got = datasets.SyntheticStoryDataset().batches(2, seed=3, shard_id=1,
                                                   num_shards=2)
    want = jdatasets.SyntheticStoryDataset().batches(2, seed=3, shard_id=1,
                                                     num_shards=2)
    for _ in range(2):
        _assert_dicts_equal(next(got), next(want))


def _write_tiny_h5(path, n=4, f=5, row=48):
    """An ARLDM-layout h5 with a 'test' split: per frame a vlen-uint8
    dataset of JPEG stacks of two candidate frames, and '|'-joined
    captions."""
    import cv2
    import h5py

    rng = np.random.RandomState(7)
    with h5py.File(path, "w") as hf:
        grp = hf.create_group("test")
        dt = h5py.vlen_dtype(np.uint8)
        for i in range(f):
            ds = grp.create_dataset(f"image{i}", (n,), dtype=dt)
            for j in range(n):
                img = rng.randint(0, 256, (2 * row, row, 3), np.uint8)
                ok, enc = cv2.imencode(".jpg", img)
                assert ok
                ds[j] = np.frombuffer(enc.tobytes(), np.uint8)
        texts = [("|".join(f"Story {j} frame {i}" for i in range(f))).encode()
                 for j in range(n)]
        grp.create_dataset("text", data=texts)


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "tiny.h5")
    _write_tiny_h5(path)
    return path


@pytest.mark.parametrize("known_length", [None, 1])
def test_h5_dataset_example_equals_jax(tiny_h5, known_length):
    kw = dict(h5_path=tiny_h5, image_size=64, clip_size=28)
    ds = datasets.StoryH5Dataset(DatasetConfig(**kw), "test")
    jds = jdatasets.StoryH5Dataset(JDatasetConfig(**kw), "test")
    assert len(ds) == len(jds) == 4
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for index in range(4):
        _assert_dicts_equal(ds.example(index, rng, known_length),
                            jds.example(index, jrng, known_length))


def test_h5_dataset_batches_equal_jax(tiny_h5):
    kw = dict(h5_path=tiny_h5, image_size=64, clip_size=28)
    got = datasets.StoryH5Dataset(DatasetConfig(**kw), "test").batches(
        2, seed=5)
    want = jdatasets.StoryH5Dataset(JDatasetConfig(**kw), "test").batches(
        2, seed=5)
    for _ in range(3):  # crosses into the second epoch
        _assert_dicts_equal(next(got), next(want))


def test_h5_dataset_opens_the_file_at_first_use(tmp_path):
    cfg = DatasetConfig(h5_path=str(tmp_path / "missing.h5"))
    ds = datasets.StoryH5Dataset(cfg, "test")
    assert ds.tokenizer(["fred"])["input_ids"].shape == (1, 91)
    with pytest.raises(OSError):
        len(ds)
