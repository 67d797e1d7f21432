"""Story datasets — the counterpart of `rcdms_tpu/data/datasets.py`: the
ARLDM h5 reader (FlintstonesSV / PororoSV) and a synthetic dataset for
tests and smoke runs. Host-side numpy only.

`StoryH5Dataset` opens the h5 file at first use, and imports h5py and
OpenCV only then (Pillow only for the super-resolution PNG directory), so
a dataset that is only asked for its tokenizer opens no file. With
`use_native_feeder` the pixel tensors of a batch are packed by the C++
feeder (`data/native_feeder.py`, built with g++ at first use), bit for
bit the numpy protocol's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import numpy as np

from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data.protocol import (
    StoryTokenizer,
    build_story_example,
    collate,
)


@dataclass
class StoryH5Dataset:
    """ARLDM-prepared h5: per split, keys `image0..image{f-1}` (encoded JPEG
    stacks of candidate video frames) and `text` ('|'-separated
    captions)."""

    cfg: DatasetConfig
    subset: str = "train"
    tokenizer_path: Optional[str] = None
    # the C++ feeder packs the pixel tensors in a thread pool; a feeder
    # that fails to build or load raises here
    use_native_feeder: bool = False
    feeder_threads: int = 4
    # ring depth of the feeder's outputs: a yielded batch stays valid for
    # feeder_buffer_depth - 1 further batches (data/prefetch.py sizes it)
    feeder_buffer_depth: int = 2
    _h5: object = field(default=None, repr=False)
    _feeder: object = field(default=None, repr=False)

    def __post_init__(self):
        self.tokenizer = StoryTokenizer(self.cfg, self.tokenizer_path)
        if self.use_native_feeder:
            from rcdms_tpu_torch.data.native_feeder import NativeFeeder

            self._feeder = NativeFeeder(self.feeder_threads,
                                        self.feeder_buffer_depth)

    def _ensure_open(self):
        if self._h5 is None:
            import h5py

            f = h5py.File(self.cfg.h5_path, "r")
            self._h5 = f[self.subset]
        return self._h5

    def __len__(self) -> int:
        return len(self._ensure_open()["text"])

    def _decode_frame(self, blob: np.ndarray, rng: np.random.RandomState
                      ) -> np.ndarray:
        """Decode the JPEG stack and pick one of its candidate video frames
        (square rows: Flintstones 128 px, PororoSV of any height)."""
        import cv2

        im = cv2.imdecode(blob, cv2.IMREAD_COLOR)
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        n_candidates = im.shape[0] // im.shape[1]
        row = im.shape[1]
        idx = rng.randint(0, n_candidates) if n_candidates > 1 else 0
        return im[idx * row:(idx + 1) * row]

    def example(self, index: int, rng: np.random.RandomState,
                known_length: Optional[int] = None,
                drop_text: bool = True) -> Dict[str, np.ndarray]:
        h5 = self._ensure_open()
        f = self.cfg.num_frames
        frames = self._load_frames(index, rng)
        captions = h5["text"][index].decode("utf-8").split("|")
        if known_length is None:
            known_length = rng.randint(0, f)  # U{0..f-1}
        drop = (rng.rand(f) < self.cfg.text_drop_rate) if drop_text else None
        return build_story_example(frames, captions, known_length,
                                   self.tokenizer, cfg=self.cfg,
                                   text_drop_mask=drop)

    def _load_frames(self, index: int, rng: np.random.RandomState):
        h5 = self._ensure_open()
        f = self.cfg.num_frames
        if self.cfg.sr_dir:  # super-resolution PNG directory variant
            from PIL import Image

            return [np.asarray(Image.open(
                f"{self.cfg.sr_dir}/{index}_{i}.png").convert("RGB"))
                for i in range(f)]
        return [self._decode_frame(h5[f"image{i}"][index], rng)
                for i in range(f)]

    def _native_batch(self, idxs, rng: np.random.RandomState,
                      drop_text: bool) -> Dict[str, np.ndarray]:
        """One batch packed by the C++ feeder. It draws from `rng` in the
        Python path's order (a story's frame picks, its known length, its
        caption drops), and the feeder's pixels are the protocol's bit for
        bit, so the flag changes no batch."""
        h5 = self._ensure_open()
        f = self.cfg.num_frames
        stories, kls, ids_rows, mask_rows = [], [], [], []
        for i in idxs:
            stories.append(np.stack(self._load_frames(int(i), rng)))
            kls.append(int(rng.randint(0, f)))
            drop = (rng.rand(f) < self.cfg.text_drop_rate
                    if drop_text else np.zeros(f, bool))
            caps = h5["text"][int(i)].decode("utf-8").split("|")
            toks = self.tokenizer(["" if d else c.lower()
                                   for c, d in zip(caps, drop)])
            ids_rows.append(toks["input_ids"])
            mask_rows.append(toks["attention_mask"])
        out = self._feeder.pack_batch(stories, kls, self.cfg.image_size,
                                      self.cfg.clip_size)
        out["input_ids"] = np.stack(ids_rows)
        out["text_mask"] = np.stack(mask_rows)
        return out

    def batches(self, batch_size: int, *, seed: int = 0, shard_id: int = 0,
                num_shards: int = 1, shuffle: bool = True,
                drop_text: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch iterator over this process's shard (the
        `DistributedSampler` equivalent)."""
        n = len(self)
        shard_n = len(range(shard_id, n, num_shards))
        if shard_n < batch_size:
            raise ValueError(
                f"shard {shard_id}/{num_shards} has {shard_n} items < "
                f"batch_size {batch_size} — the epoch loop would spin "
                f"forever without yielding")
        epoch = 0
        while True:
            rng = np.random.RandomState(seed + epoch)
            order = rng.permutation(n) if shuffle else np.arange(n)
            order = order[shard_id::num_shards]
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idxs = order[start:start + batch_size]
                if self._feeder is not None:
                    yield self._native_batch(idxs, rng, drop_text)
                else:
                    yield collate([self.example(int(i), rng,
                                                drop_text=drop_text)
                                   for i in idxs])
            epoch += 1


@dataclass
class SyntheticStoryDataset:
    """Deterministic random stories (no h5 or tokenizer files): used by the
    tests and the CLIs' `--synthetic` runs."""

    cfg: DatasetConfig = field(default_factory=lambda: DatasetConfig(
        image_size=64, clip_size=28))
    num_items: int = 64

    def __post_init__(self):
        self.tokenizer = StoryTokenizer(self.cfg, None)

    def __len__(self):
        return self.num_items

    def example(self, index: int, rng: np.random.RandomState,
                known_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        f = self.cfg.num_frames
        item_rng = np.random.RandomState(index)
        frames = [item_rng.randint(0, 255, (self.cfg.image_size,
                                            self.cfg.image_size, 3),
                                   dtype=np.uint8) for _ in range(f)]
        captions = [f"character {index} does thing {i}" for i in range(f)]
        if known_length is None:
            known_length = rng.randint(0, f)
        return build_story_example(frames, captions, known_length,
                                   self.tokenizer, cfg=self.cfg)

    def batches(self, batch_size: int, *, seed: int = 0, shard_id: int = 0,
                num_shards: int = 1, **_) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed)
        order = np.arange(self.num_items)[shard_id::num_shards]
        if len(order) < batch_size:
            raise ValueError(
                f"shard {shard_id}/{num_shards} has {len(order)} items < "
                f"batch_size {batch_size}")
        while True:
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield collate([self.example(int(i), rng)
                               for i in order[start:start + batch_size]])
