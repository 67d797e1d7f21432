"""The port's image decoder (`rcdms_tpu_torch/sample/eval.py::decode_png`),
which reads PNG reference frames without Pillow: against Pillow's
`Image.open(...).convert("RGB")` (the JAX CLIs' reader) on random images
of every colour type, written by Pillow and by small writers here that
set each row's filter (0-4), split the data over several IDAT chunks,
pack bit depths 1-16, write palettes with tRNS and interlace by Adam7;
other formats through Pillow where it is installed; the round trip with
`encode_png`; and the images it refuses."""

import io
import struct
import sys
import warnings
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
def test_decode_png_refuses(case, monkeypatch):
    a = _image(5, 8, 8, 3, smooth=False)
    png = _filtered_png(a, 2, (0,))
    if case == "jpeg":  # another format, where Pillow is not installed
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG")
        data = buf.getvalue()
        monkeypatch.setitem(sys.modules, "PIL", None)
    elif case == "signature":  # neither a PNG nor anything Pillow reads
        data = _tamper(png, 1, ord("Q"))
    elif case == "crc":
        data = _tamper(png, 16, png[16] ^ 1)  # IHDR payload, CRC kept
    elif case == "palette":  # a palette image without its PLTE chunk
        data = _png(a[..., :1], 3, 8)
    elif case == "16-bit":  # a palette at 16 bits is outside the standard
        data = _filtered_png(a, 3, (0,), depth=16)
    elif case == "interlaced":  # interlace methods are 0 and 1 (Adam7)
        data = _filtered_png(a, 2, (0,), interlace=2)
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


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _pack_rows(v, depth):
    """(h, w, ch) samples as the (h, row bytes) uint8 rows of a PNG:
    big-endian pairs at 16 bits, high bits first below 8."""
    h = v.shape[0]
    flat = v.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
    groups = flat.reshape(h, -1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (groups << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows, filters, bpp):
    """Each byte row filtered with filters[r % len] over units of bpp."""
    x = rows.astype(np.int64)
    out = []
    for r in range(x.shape[0]):
        t = filters[r % len(filters)]
        line = bytearray([t])
        for i in range(x.shape[1]):
            left = int(x[r, i - bpp]) if i >= bpp else 0
            up = int(x[r - 1, i]) if r else 0
            ul = int(x[r - 1, i - bpp]) if r and i >= bpp else 0
            pred = (0, left, up, (left + up) // 2, _paeth(left, up, ul))[t]
            line.append((int(x[r, i]) - pred) % 256)
        out.append(bytes(line))
    return b"".join(out)


def _png(v, color, depth, interlace=0, filters=(0, 1, 2, 3, 4), plte=None,
         trns=None):
    """A PNG of the (h, w, ch) samples `v` at `depth`, each pass (Adam7
    where interlace is 1) filtered on its own, with optional PLTE and
    tRNS chunks."""
    h, w, ch = v.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b"".join(_filter_rows(_pack_rows(v[r0::rs, c0::cs], depth),
                                 filters, bpp)
                    for r0, c0, rs, cs in passes
                    if v[r0::rs, c0::cs].size)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    extra = b""
    if plte is not None:
        extra += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        extra += _chunk(b"tRNS", trns)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _pillow_reads(data):
    # Pillow warns about a palette's byte transparency; the pixels are
    # what is compared
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _pillow_rgb(data)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_decode_png_palette_matches_pillow(depth, interlace):
    """A palette of fewer entries than the indices reach (an index past it
    reads black, as in Pillow), with a tRNS chunk that is dropped."""
    rng = np.random.default_rng(depth)
    idx = rng.integers(0, 1 << depth, (13, 11, 1))
    entries = max(1, (1 << depth) * 3 // 4)
    plte = rng.integers(0, 256, (entries, 3))
    data = _png(idx, 3, depth, interlace, plte=plte, trns=bytes([0, 128]))
    out = decode_png(data)
    assert out.shape == (13, 11, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _pillow_reads(data))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_16_bit_matches_pillow(mode, interlace):
    """16-bit grey is clipped to 255 (Pillow's I;16), the other colour
    types take their high byte; values near 255 and near 65535 both."""
    color, ch = MODES[mode]
    rng = np.random.default_rng(color)
    v = rng.integers(0, 65536, (9, 14, ch))
    v[0, :8] = np.arange(250, 258)[:, None]
    data = _png(v, color, 16, interlace)
    np.testing.assert_array_equal(decode_png(data), _pillow_reads(data))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_decode_png_low_bit_grey_matches_pillow(depth):
    v = np.random.default_rng(depth).integers(0, 1 << depth, (7, 19, 1))
    for interlace in (0, 1):
        data = _png(v, 0, depth, interlace)
        np.testing.assert_array_equal(decode_png(data), _pillow_reads(data))


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (5, 3), (9, 7), (37, 29)])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_adam7_at_odd_sizes_matches_pillow(mode, size):
    """Adam7 at sizes where passes are short or empty, every filter."""
    color, ch = MODES[mode]
    v = _image(sum(size), *size, ch, smooth=True)
    data = _png(v, color, 8, interlace=1)
    out = decode_png(data)
    assert out.shape == size + (3,)
    np.testing.assert_array_equal(out, _pillow_reads(data))


def test_decode_png_reads_other_formats_through_pillow():
    a = _image(8, 24, 31, 3, smooth=True)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG")
    data = buf.getvalue()
    out = decode_png(data)
    assert out.shape == (24, 31, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _pillow_rgb(data))
    with pytest.raises(ValueError, match="over the limit"):
        decode_png(data, max_pixels=24 * 31 - 1)
    with pytest.raises(ValueError, match="Pillow"):
        decode_png(b"neither a PNG nor anything Pillow reads")


def test_decode_png_refuses_other_formats_without_pillow(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_image(9, 8, 8, 3, smooth=False)).save(buf, "BMP")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="not installed"):
        decode_png(buf.getvalue())
