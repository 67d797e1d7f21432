"""Evaluation metrics and story images — the counterpart of
`rcdms_tpu/sample/eval.py`, numpy only:

  * stage 1: per-frame cosine similarity of predicted vs ground-truth CLIP
    image embeddings (`Stage1EvalAccumulator`);
  * stage 2: windowed SSIM (skimage's defaults) and PSNR against the ground
    truth (`story_metrics`), per-frame PNGs and a 2 x F comparison grid
    (`save_story_grid`).

The PNGs are written by a small encoder of its own (8-bit RGB, no filter,
`zlib`) and read by a small decoder (`decode_png`, every PNG the standard
allows), so writing a story or reading a PNG reference frame needs no
Pillow; a reference frame in another format is read by Pillow where it
is installed.
"""

from __future__ import annotations

import io
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


# the most pixels decode_png takes by default: the size above which Pillow
# refuses an image as a decompression bomb (2 * Image.MAX_IMAGE_PIXELS)
MAX_PNG_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

# channels of each PNG colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths the PNG standard allows for each colour type
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 interlacing: (first row, first column, row step, column step) of
# each of its seven passes
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _png_chunks(data: bytes):
    """(kind, payload) of each chunk up to IEND; raises ValueError on a bad
    signature, a truncated chunk or a CRC mismatch."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, units: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of h rows of `units` filter units of `bpp` bytes (a pixel, or one byte
    below bit depth 8); returns the (h, units * bpp) bytes. A unit depends
    on its left, upper and upper-left neighbours, so one anti-diagonal of
    units is reconstructed at a time, every row with its own filter."""
    rows = raw.reshape(h, 1 + units * bpp)
    kind = rows[:, 0].astype(np.int16)
    if kind.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(kind.max())} is not 0-4")
    filt = rows[:, 1:].reshape(h, units, bpp).astype(np.int16)
    # padded with a zero row above and a zero column on the left; int16
    # holds every sum and Paeth difference of two bytes
    out = np.zeros((h + 1, units + 1, bpp), np.int16)
    for d in range(h + units - 1):
        ys = np.arange(max(0, d - units + 1), min(d, h - 1) + 1)
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        t = kind[ys, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return out[1:, 1:].reshape(h, units * bpp).astype(np.uint8)


def _row_bytes(w: int, ch: int, depth: int) -> int:
    return -(-w * ch * depth // 8)


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, row bytes) as (h, w, ch) int32 sample values:
    big-endian pairs at depth 16, packed bits (high bits first) below 8."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, -1, 2).astype(np.int32)
        v = (v[..., 0] << 8) | v[..., 1]
    elif depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        v = bits.astype(np.int32) @ (1 << np.arange(depth - 1, -1, -1))
    else:
        v = rows.astype(np.int32)
    return v[:, :w * ch].reshape(h, w, ch)


def _png_to_rgb(v: np.ndarray, color: int, depth: int,
                palette: Optional[np.ndarray]) -> np.ndarray:
    """Sample values as uint8 RGB by Pillow's `convert("RGB")` rules:
    palette indices through the palette, zero-padded to 256 entries (an
    index past it is black); 16-bit grey clipped to 255 (Pillow's I;16),
    other 16-bit samples their high byte; grey below 8 bits scaled to
    0-255; alpha and tRNS dropped."""
    if color == 3:
        return palette[v[..., 0]]
    if depth == 16:
        v = np.minimum(v, 255) if color == 0 else v >> 8
    elif depth < 8:
        v = v * 255 // ((1 << depth) - 1)
    rgb = np.repeat(v[..., :1], 3, axis=-1) if color in (0, 4) else v[..., :3]
    return np.ascontiguousarray(rgb, np.uint8)


def _decode_with_pillow(data: bytes, max_pixels: int) -> np.ndarray:
    """An image that is not a PNG, through Pillow's `convert("RGB")` as
    the JAX CLIs read it, where Pillow is installed (imported here: the
    machine with the card has none). Raises ValueError where it is
    missing or cannot read the data, or the image is over the limit."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("not a PNG (bad signature), and Pillow, which "
                         "reads other formats, is not installed") from None
    try:
        img = Image.open(io.BytesIO(data))
        w, h = img.size
        if w * h > max_pixels:
            raise ValueError(f"image of {w} x {h} pixels is over the limit "
                             f"of {max_pixels}")
        return np.asarray(img.convert("RGB"), np.uint8)
    except (OSError, SyntaxError, Image.DecompressionBombError) as e:
        raise ValueError(f"not a PNG, nor an image Pillow reads: {e}") \
            from e


def decode_png(data: bytes, max_pixels: int = MAX_PNG_PIXELS) -> np.ndarray:
    """An image's pixels as uint8 (h, w, 3) RGB, as Pillow's
    `Image.open(...).convert("RGB")` gives them (the JAX CLIs' reader).

    A PNG is read here in numpy, with no Pillow: every colour type (grey,
    RGB, palette, grey + alpha, RGBA) at every bit depth the standard
    allows it (1-16), Adam7 interlacing, filters 0-4, any number of IDAT
    chunks; alpha and tRNS are dropped. Any other format goes to Pillow
    where it is installed. Raises ValueError on what neither reads: a
    depth or colour type outside the standard, a palette image without a
    PLTE, a bad CRC, corrupt data, or a header of more than `max_pixels`
    pixels. The image data is never inflated past the size its header
    declares."""
    data = bytes(data)
    if data[:8] != PNG_SIGNATURE:
        return _decode_with_pillow(data, max_pixels)
    header, palette, idat = None, None, []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            header = payload
        elif kind == b"PLTE":
            if len(payload) % 3 or not 3 <= len(payload) <= 768:
                raise ValueError(f"PNG palette of {len(payload)} bytes")
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(payload) // 3] = np.frombuffer(
                payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or len(header) != 13:
        raise ValueError("PNG without a valid IHDR chunk")
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                               header)
    if depth not in _PNG_DEPTHS.get(color, ()):
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is "
                         f"not in the standard")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if interlace > 1 or comp != 0 or filt != 0:
        raise ValueError("PNG of a non-standard interlace, compression or "
                         "filter method")
    if w == 0 or h == 0:
        raise ValueError("PNG of zero size")
    if w * h > max_pixels:
        raise ValueError(f"PNG of {w} x {h} pixels is over the limit of "
                         f"{max_pixels}")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)  # bytes of a filter unit
    # each pass's sub-image: rows r0::rs and columns c0::cs of the image,
    # ph x pw pixels; a pass of no pixels has no data
    passes = [(r0, c0, rs, cs, -(-(h - r0) // rs), -(-(w - c0) // cs))
              for r0, c0, rs, cs in (_ADAM7 if interlace else
                                     ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    sizes = [ph * (1 + _row_bytes(pw, ch, depth))
             for *_, ph, pw in passes]
    size = sum(sizes)
    try:
        # one byte past the declared size shows data that runs over it
        raw = zlib.decompressobj().decompress(b"".join(idat), size + 1)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if len(raw) > size:
        raise ValueError(f"PNG image data runs past the {size} bytes its "
                         f"header declares")
    if len(raw) < size:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{size}")
    raw = np.frombuffer(raw, np.uint8)
    v = np.zeros((h, w, ch), np.int32)
    at = 0
    for (r0, c0, rs, cs, ph, pw), n in zip(passes, sizes):
        rows = _unfilter(raw[at:at + n], ph,
                         _row_bytes(pw, ch, depth) // bpp, bpp)
        v[r0::rs, c0::cs] = _samples(rows, pw, ch, depth)
        at += n
    return _png_to_rgb(v, color, depth, palette)


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
