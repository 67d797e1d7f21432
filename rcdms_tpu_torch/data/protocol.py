"""Host-side story preprocessing protocol, numpy only — the counterpart of
`rcdms_tpu/data/protocol.py`, bit for bit:

  * CLIP image preprocessing: resize the shortest side to 224 (bicubic),
    center crop, CLIP mean/std (`CLIPImageProcessor()` defaults);
  * target images: square bilinear resize, scaled to [-1, 1];
  * known-prefix masking: `source` = the first L real frames + black,
    per-frame (size/8)^2 mask maps, white/black CLIP mask images;
  * captions lowercased, optionally dropped to "" for CFG, tokenized to
    max_length 91 / 85 with truncation disabled.

The resize is a numpy copy of Pillow's two-pass fixed-point resampling
(the same steps as `native/story_feeder.cpp`), so the protocol needs no
Pillow.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from rcdms_tpu_torch.configs import DatasetConfig

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's PRECISION_BITS


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's BICUBIC kernel (Keys, a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's BILINEAR kernel (triangle), support 1."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_bicubic_filter, 2.0),
            "bilinear": (_bilinear_filter, 1.0)}


def _coeffs(in_size: int, out_size: int, filt: str):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc`: for each
    output index, the first input index and the int32 weights of its taps
    (zero past the tap count). The support widens by the scale when
    downscaling; every double operation runs in Pillow's order."""
    kernel, support_base = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support_base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) cast truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = kernel(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
               * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):  # Pillow sums the taps in order
        ww = ww + w[:, i]
    nonzero = ww[:, None] != 0.0
    k = np.where(nonzero, w / np.where(nonzero, ww[:, None], 1.0), w)
    scaled = k * (1 << _PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, kk.astype(np.int64)


def _resample_axis(img: np.ndarray, axis: int, out_size: int,
                   filt: str) -> np.ndarray:
    """One pass over `axis` of an (h, w, 3) uint8 image: the int32 sum of
    taps from 1 << 21, then `clip8` (>> 22, clipped to [0, 255])."""
    n = img.shape[axis]
    xmin, kk = _coeffs(n, out_size, filt)
    src = img.astype(np.int64)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for i in range(kk.shape[1]):
        acc += (np.take(src, np.minimum(xmin + i, n - 1), axis=axis)
                * kk[:, i].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size_hw, filt: str = "bicubic") -> np.ndarray:
    """`PIL.Image.resize((w, h), BICUBIC or BILINEAR)` of a uint8 (h, w, 3)
    RGB image, bit for bit: the horizontal pass, then the vertical one,
    each rounded to 8 bits; a side of unchanged size is not resampled."""
    out = np.asarray(img, np.uint8)
    out_h, out_w = size_hw
    if out.shape[1] != out_w:
        out = _resample_axis(out, 1, out_w, filt)
    if out.shape[0] != out_h:
        out = _resample_axis(out, 0, out_h, filt)
    return out.copy() if out is img else out


def clip_preprocess(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 HWC RGB -> CLIP-normalized float32 (size, size, 3)."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = _resize(img, (nh, nw))
    top, left = (nh - size) // 2, (nw - size) // 2
    img = img[top:top + size, left:left + size]
    img = img.astype(np.float32) / 255.0
    return (img - CLIP_MEAN) / CLIP_STD


def pixel_preprocess(img: np.ndarray, size: int = 512) -> np.ndarray:
    """uint8 HWC RGB -> [-1, 1] float32 (size, size, 3): a square BILINEAR
    resize (not aspect-preserving), torchvision's `transforms.Resize`
    default, as the reference's datasets resize their targets. CLIP
    preprocessing keeps BICUBIC."""
    img = _resize(img, (size, size), "bilinear")
    return img.astype(np.float32) / 127.5 - 1.0


def black_image(size: int) -> np.ndarray:
    return np.zeros((size, size, 3), np.uint8)


def white_image(size: int) -> np.ndarray:
    return np.full((size, size, 3), 255, np.uint8)


_CONST_CACHE: Dict[tuple, np.ndarray] = {}


def _cached_const(kind: str, size: int, csize: int) -> np.ndarray:
    """The black/white protocol constants, computed once per (kind, size,
    csize): they never change between stories. Read-only; callers stack
    or copy them."""
    key = (kind, size, csize)
    out = _CONST_CACHE.get(key)
    if out is None:
        if kind == "black_px":
            out = pixel_preprocess(black_image(size), size)
        elif kind == "black_cl":
            out = clip_preprocess(black_image(size), csize)
        else:
            out = clip_preprocess(white_image(size), csize)
        out.flags.writeable = False
        _CONST_CACHE[key] = out
    return out


@dataclass
class StoryTokenizer:
    """CLIP tokenizer wrapper: adds the dataset's character tokens and pads
    to the dataset's max length with truncation disabled. Without
    tokenizer files it falls back to a deterministic crc32 word hash
    (tests, smoke runs). `transformers` is imported only for a
    `tokenizer_path`."""

    cfg: DatasetConfig
    tokenizer_path: Optional[str] = None

    def __post_init__(self):
        self._tok = None
        if self.tokenizer_path is not None:
            from transformers import CLIPTokenizer

            self._tok = CLIPTokenizer.from_pretrained(self.tokenizer_path)
            self._tok.add_tokens(list(self.cfg.new_tokens))

    @property
    def eos_token_id(self) -> int:
        return self._tok.eos_token_id if self._tok is not None else 49407

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        max_len = self.cfg.max_text_len
        if self._tok is not None:
            # no return_tensors: with truncation off an over-length caption
            # makes the batch ragged, so pad and clamp here
            enc = self._tok(list(texts), padding=False,
                            truncation=False)["input_ids"]
            pad_id = (self._tok.pad_token_id
                      if self._tok.pad_token_id is not None
                      else self.eos_token_id)
            ids = np.full((len(texts), max_len), pad_id, np.int32)
            mask = np.zeros((len(texts), max_len), bool)
            for i, seq in enumerate(enc):
                if len(seq) > max_len:
                    seq = list(seq[:max_len])
                    seq[-1] = self.eos_token_id
                ids[i, :len(seq)] = seq
                mask[i, :len(seq)] = True
            return {"input_ids": ids, "attention_mask": mask}
        # hash fallback: bos, per-word ids, eos, eos padding (CLIP pads with
        # eos). crc32, not hash(): the builtin is salted per process
        bos, eos = 49406, 49407
        ids = np.full((len(texts), max_len), eos, np.int32)
        mask = np.zeros((len(texts), max_len), bool)
        for i, t in enumerate(texts):
            words = t.lower().split()[: max_len - 2]
            row = [bos] + [zlib.crc32(w.encode()) % 49000
                           for w in words] + [eos]
            ids[i, : len(row)] = np.asarray(row, np.int32)
            mask[i, : len(row)] = True
        return {"input_ids": ids, "attention_mask": mask}


def build_story_example(
    frames: Sequence[np.ndarray],
    captions: Sequence[str],
    known_length: int,
    tokenizer: StoryTokenizer,
    tokenizer_uncond: Optional[StoryTokenizer] = None,
    cfg: Optional[DatasetConfig] = None,
    text_drop_mask: Optional[Sequence[bool]] = None,
) -> Dict[str, np.ndarray]:
    """One story -> the example dict, frames-first layouts. `frames`: f
    uint8 HWC images; `known_length` in [0, f].

    Keys (f = num frames, s = image size, c = clip size):
      target        (f, s, s, 3)  [-1, 1]
      source        (f, s, s, 3)  known frames + black
      reference_clip(f, c, c, 3)  CLIP-processed real frames (all)
      source_clip   (f, c, c, 3)  CLIP-processed known + black
      mask_clip     (f, c, c, 3)  CLIP-processed white(known)/black
      mask_label    (f, s/8, s/8, 1) {0,1}
      input_ids     (f, T) int32 / text_mask (f, T) bool
      frame_known   (f,) bool
    """
    cfg = cfg or DatasetConfig()
    f = len(frames)
    size, csize = cfg.image_size, cfg.clip_size
    m = size // 8

    black_px = _cached_const("black_px", size, csize)
    black_cl = _cached_const("black_cl", size, csize)
    white_cl = _cached_const("white_cl", size, csize)

    target = np.stack([pixel_preprocess(fr, size) for fr in frames])
    reference_clip = np.stack([clip_preprocess(fr, csize) for fr in frames])

    known = np.arange(f) < known_length
    source = np.stack([target[i] if known[i] else black_px for i in range(f)])
    source_clip = np.stack([reference_clip[i] if known[i] else black_cl
                            for i in range(f)])
    mask_clip = np.stack([white_cl if known[i] else black_cl
                          for i in range(f)])
    mask_label = known.astype(np.float32)[:, None, None, None]
    mask_label = np.broadcast_to(mask_label, (f, m, m, 1)).copy()

    caps: List[str] = [c.lower() for c in captions]
    if text_drop_mask is not None:
        caps = ["" if d else c for c, d in zip(caps, text_drop_mask)]
    toks = tokenizer(caps)

    out = {
        "target": target,
        "source": source,
        "reference_clip": reference_clip,
        "source_clip": source_clip,
        "mask_clip": mask_clip,
        "mask_label": mask_label,
        "input_ids": toks["input_ids"],
        "text_mask": toks["attention_mask"],
        "frame_known": known,
    }
    if tokenizer_uncond is not None:
        utoks = tokenizer_uncond([""] * f)
        out["input_ids_uncond"] = utoks["input_ids"]
        out["text_mask_uncond"] = utoks["attention_mask"]
    return out


def collate(examples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack example dicts to a batch: every key gains a leading batch dim
    (input_ids keep an explicit (b, f, T) shape)."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
