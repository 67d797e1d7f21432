"""Evaluation metrics and story images — the counterpart of
`rcdms_tpu/sample/eval.py`, numpy only:

  * stage 1: per-frame cosine similarity of predicted vs ground-truth CLIP
    image embeddings (`Stage1EvalAccumulator`);
  * stage 2: windowed SSIM (skimage's defaults) and PSNR against the ground
    truth (`story_metrics`), per-frame PNGs and a 2 x F comparison grid
    (`save_story_grid`).

The PNGs are written by a small encoder of its own (8-bit RGB, no filter,
`zlib`), so writing a story needs no Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def cosine_similarity(pred: np.ndarray, target: np.ndarray,
                      axis: int = -1) -> np.ndarray:
    p = pred / (np.linalg.norm(pred, axis=axis, keepdims=True) + 1e-8)
    t = target / (np.linalg.norm(target, axis=axis, keepdims=True) + 1e-8)
    return (p * t).sum(axis=axis)


def _uniform_filter(x: np.ndarray, win: int) -> np.ndarray:
    """Separable box filter with symmetric ('reflect') boundary — the
    local mean scipy.ndimage.uniform_filter takes inside skimage's
    structural_similarity."""
    out = x.astype(np.float64)
    for ax in range(out.ndim):
        pad_width = [(0, 0)] * out.ndim
        pad_width[ax] = (win // 2, win - 1 - win // 2)
        xp = np.pad(out, pad_width, mode="symmetric")
        out = np.lib.stride_tricks.sliding_window_view(
            xp, win, axis=ax).mean(axis=-1)
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    """Windowed SSIM with `skimage.metrics.structural_similarity`'s
    defaults: uniform 7 x 7 window, sample covariance, valid-region crop,
    averaged over the channels of an (h, w, c) input. `win_size` is
    clamped to the largest odd size that fits the image."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 3:  # channel_axis=-1: per-channel SSIM, averaged
        return float(np.mean([ssim(a[..., i], b[..., i], data_range,
                                   win_size) for i in range(a.shape[-1])]))
    win = min(win_size, min(a.shape))
    if win % 2 == 0:
        win -= 1
    if win < 3:
        raise ValueError(
            f"image sides {a.shape} too small for SSIM (clamped window "
            f"{win} < 3; skimage raises here too)")
    np_win = win ** a.ndim
    cov_norm = np_win / (np_win - 1)  # sample covariance
    ux = _uniform_filter(a, win)
    uy = _uniform_filter(b, win)
    uxx = _uniform_filter(a * a, win)
    uyy = _uniform_filter(b * b, win)
    uxy = _uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = (((2 * ux * uy + c1) * (2 * vxy + c2))
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win - 1) // 2
    crop = s[tuple(slice(pad, dim - pad) for dim in s.shape)]
    return float(crop.mean())


@dataclass
class Stage1EvalAccumulator:
    """Running per-frame cosine-similarity accumulator."""

    total: float = 0.0
    count: int = 0

    def update(self, pred_embeds: np.ndarray, gt_embeds: np.ndarray) -> float:
        sims = cosine_similarity(pred_embeds, gt_embeds)
        self.total += float(sims.sum())
        self.count += sims.size
        return float(sims.mean())

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgb: np.ndarray) -> bytes:
    """A uint8 (h, w, 3) image as an 8-bit RGB PNG: IHDR, one zlib IDAT of
    unfiltered rows, IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (h, w, 3) RGB, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(rgb))


def save_story_grid(path: str, generated: np.ndarray,
                    ground_truth: Optional[np.ndarray] = None) -> None:
    """generated/gt: (f, h, w, 3) in [0, 1]. Writes a 2 x F grid (1 x F
    without GT) to `path` and per-frame PNGs beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = generated.shape[0]

    def to8(x):
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    rows = [np.concatenate([to8(generated[i]) for i in range(f)], axis=1)]
    if ground_truth is not None:
        rows.append(np.concatenate([to8(ground_truth[i]) for i in range(f)],
                                   axis=1))
    _write_png(path, np.concatenate(rows, axis=0))

    stem, ext = os.path.splitext(path)
    for i in range(f):
        _write_png(f"{stem}_frame{i}{ext}", to8(generated[i]))


def story_metrics(generated: np.ndarray, ground_truth: np.ndarray
                  ) -> Dict[str, float]:
    """Per-story metrics: mean per-frame SSIM and PSNR vs ground truth."""
    f = generated.shape[0]
    ssims, psnrs = [], []
    for i in range(f):
        ssims.append(ssim(generated[i], ground_truth[i]))
        mse = float(np.mean((generated[i] - ground_truth[i]) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-10)))
    return {"ssim": float(np.mean(ssims)), "psnr": float(np.mean(psnrs))}


def split_indices(n: int, shard_id: int, num_shards: int) -> Sequence[int]:
    """Static index split over shards."""
    return list(range(n))[shard_id::num_shards]
