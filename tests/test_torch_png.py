"""The port's PNG decoder (`rcdms_tpu_torch/sample/eval.py::decode_png`),
which reads reference frames without Pillow: against Pillow's
`Image.open(...).convert("RGB")` on random images of every colour type it
takes, written by Pillow and by a small writer here that sets each row's
filter (0-4) and splits the data over several IDAT chunks; the round trip
with `encode_png`; and the images it refuses."""

import io
import struct
import zlib

import numpy as np
import pytest

from rcdms_tpu_torch.sample.eval import PNG_SIGNATURE, decode_png, encode_png

Image = pytest.importorskip("PIL.Image")

MODES = {"L": (0, 1), "RGB": (2, 3), "LA": (4, 2), "RGBA": (6, 4)}


def _image(seed, h, w, ch, smooth):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, ch))
    if smooth:  # gradients, where Pillow's adaptive filters pick 1-4
        a = np.cumsum(np.cumsum(a, 0), 1) // (h + w)
    return (a % 256).astype(np.uint8)


def _pillow_png(a, mode):
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if mode == "L" else a, mode).save(buf, "PNG")
    return buf.getvalue()


def _pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(a, color, filters, idat_parts=3, **header):
    """`a` (h, w, ch) written with row r filtered by filters[r % len]."""
    h, w, ch = a.shape
    x = a.astype(np.int64)
    rows = []
    for r in range(h):
        t = filters[r % len(filters)]
        out = bytearray([t])
        for i in range(w * ch):
            px, c = divmod(i, ch)
            cur = int(x[r, px, c])
            left = int(x[r, px - 1, c]) if px else 0
            up = int(x[r - 1, px, c]) if r else 0
            ul = int(x[r - 1, px - 1, c]) if r and px else 0
            pred = (0, left, up, (left + up) // 2,
                    _paeth(left, up, ul))[t]
            out.append((cur - pred) % 256)
        rows.append(bytes(out))
    data = zlib.compress(b"".join(rows))
    step = -(-len(data) // idat_parts)
    fields = dict(depth=8, color=color, interlace=0)
    fields.update(header)
    ihdr = struct.pack(">IIBBBBB", w, h, fields["depth"], fields["color"], 0,
                       0, fields["interlace"])
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"tEXt", b"Comment\x00ancillary")
            + b"".join(_chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "gradient"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_matches_pillow(mode, smooth):
    a = _image(len(mode), 37, 53, MODES[mode][1], smooth)
    data = _pillow_png(a, mode)
    out = decode_png(data)
    assert out.dtype == np.uint8 and out.shape == (37, 53, 3)
    np.testing.assert_array_equal(out, _pillow_rgb(data))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_decode_png_every_filter_over_several_idat_chunks(mode, filters):
    color, ch = MODES[mode]
    a = _image(7, 9, 11, ch, smooth=True)
    data = _filtered_png(a, color, filters)
    np.testing.assert_array_equal(decode_png(data), _pillow_rgb(data))


def test_decode_png_round_trips_encode_png():
    a = _image(3, 64, 48, 3, smooth=False)
    np.testing.assert_array_equal(decode_png(encode_png(a)), a)


def _tamper(data, pos, value):
    b = bytearray(data)
    b[pos] = value
    return bytes(b)


def _declared_png(w, h, data):
    """An RGB PNG whose IHDR declares w x h and whose one IDAT is `data`
    compressed."""
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("case", [
    "jpeg", "signature", "crc", "palette", "16-bit", "interlaced",
    "truncated", "filter 5", "corrupt data", "over the pixel limit",
    "data past the header's size"])
def test_decode_png_refuses(case):
    a = _image(5, 8, 8, 3, smooth=False)
    png = _filtered_png(a, 2, (0,))
    if case == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG")
        data = buf.getvalue()
    elif case == "signature":
        data = _tamper(png, 1, ord("Q"))
    elif case == "crc":
        data = _tamper(png, 16, png[16] ^ 1)  # IHDR payload, CRC kept
    elif case == "palette":
        buf = io.BytesIO()
        Image.fromarray(a).convert("P").save(buf, "PNG")
        data = buf.getvalue()
    elif case == "16-bit":
        data = _filtered_png(a, 2, (0,), depth=16)
    elif case == "interlaced":
        data = _filtered_png(a, 2, (0,), interlace=1)
    elif case == "truncated":
        data = png[:-20]
    elif case == "over the pixel limit":  # a few bytes declaring 900M px
        data = _declared_png(30000, 30000, b"")
    elif case == "data past the header's size":  # 8x8 inflating to 64 MB
        data = _declared_png(8, 8, bytes(64 << 20))
    else:
        idat = (zlib.compress(b"".join(b"\x05" + a[r].tobytes()
                                       for r in range(8)))
                if case == "filter 5" else b"not zlib data")
        data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        decode_png(data)


def test_decode_png_pixel_limit():
    a = _image(6, 8, 8, 3, smooth=False)
    np.testing.assert_array_equal(decode_png(encode_png(a), max_pixels=64),
                                  a)
    with pytest.raises(ValueError, match="over the limit"):
        decode_png(encode_png(a), max_pixels=63)
