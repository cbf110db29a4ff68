"""The port's PNG decoder (utils/png.py) against Pillow, which the JAX
package decodes with (data/pipeline.py:146-148): every file Pillow writes
here in modes RGB, RGBA, L, LA and P, and files written with each of the
five scanline filters, decode to exactly ``Image.open(...).convert("RGB")``.
Exact equality: both are integer arithmetic on the same bytes."""

import io
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu_torch.utils import png  # noqa: E402

MODES = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2, "P": 1}


def _pillow_png(mode, arr):
    if mode == "P":
        img = Image.fromarray(arr[..., 0]).quantize(200)
    else:
        img = Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr, mode=mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _pillow_rgb(data):
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _filters_used(data):
    w, h = png.png_size(data)
    raw = zlib.decompress(b"".join(b for tag, b in png._chunks(data) if tag == b"IDAT"))
    stride = len(raw) // h
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_decode_equals_pillow_on_files_pillow_writes(mode, kind):
    r = np.random.default_rng(0)
    ch = MODES[mode]
    if kind == "noise":
        arr = r.integers(0, 256, (13, 17, ch), dtype=np.uint8)
    else:  # gradients make Pillow's encoder choose Sub and Up rows
        yy, xx = np.mgrid[0:13, 0:17]
        arr = np.stack([(xx * 7 + yy * 3 + c * 40) % 256 for c in range(ch)], -1).astype(np.uint8)
    data = _pillow_png(mode, arr)
    with Image.open(io.BytesIO(data)) as img:
        assert img.mode == mode
    np.testing.assert_array_equal(png.decode_png(data), _pillow_rgb(data))
    assert png.png_size(data[:24]) == (17, 13)


def _filter_rows(rows, ftype, bpp):
    """Encode (h, stride) uint8 rows with one PNG filter type (spec §9)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            f = row
        elif ftype == 1:
            f = row - a
        elif ftype == 2:
            f = row - prev
        elif ftype == 3:
            f = row - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png_with_filter(arr, ctype, ftype, palette=None):
    h, w, ch = arr.shape

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    raw = _filter_rows(arr.reshape(h, w * ch), ftype, ch)
    # two IDAT chunks: a decoder must join them
    z = zlib.compress(raw)
    return png.SIGNATURE + body + chunk(b"IDAT", z[:7]) + chunk(b"IDAT", z[7:]) + chunk(b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_each_filter_and_colour_type_decodes_as_pillow_reads_it(ftype, ctype):
    """Pillow writes no Average rows, so files with one filter on every row
    are written here; Pillow reads them as the reference."""
    r = np.random.default_rng(ftype * 10 + ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    arr = r.integers(0, 256, (9, 11, ch), dtype=np.uint8)
    palette = None
    if ctype == 3:
        arr = r.integers(0, 40, (9, 11, 1), dtype=np.uint8)
        palette = r.integers(0, 256, (40, 3), dtype=np.uint8)
    data = _png_with_filter(arr, ctype, ftype, palette)
    assert _filters_used(data) == {ftype}
    np.testing.assert_array_equal(png.decode_png(data), _pillow_rgb(data))


def test_pillow_files_cover_filters_none_sub_up_paeth():
    seen = set()
    r = np.random.default_rng(1)
    for mode in ("RGB", "L", "LA"):
        seen |= _filters_used(_pillow_png(mode, r.integers(0, 256, (13, 17, MODES[mode]),
                                                           dtype=np.uint8)))
    assert {0, 1, 2, 4} <= seen


@pytest.mark.parametrize("depth, interlace, match", [
    (16, 0, "bit depth 16"), (4, 0, "bit depth 4"), (8, 1, "interlaced")])
def test_unsupported_pngs_raise_a_named_value_error(depth, interlace, match):
    header = struct.pack(">IIBBBBB", 4, 4, depth, 2, 0, 0, interlace)
    data = (png.SIGNATURE + struct.pack(">I", 13) + b"IHDR" + header
            + struct.pack(">I", zlib.crc32(b"IHDR" + header) & 0xFFFFFFFF))
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


def test_corrupt_files_raise_value_error():
    data = bytearray(_pillow_png("RGB", np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    data[40] ^= 0xFF  # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("shape", [(5, 7, 3), (5, 7, 1), (5, 7, 2), (5, 7, 4), (5, 7)])
def test_encode_png_is_read_by_pillow(shape):
    """The writer the TensorBoard writer uses: Pillow reads back the same
    pixels in grey, grey + alpha, RGB and RGBA."""
    arr = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    data = png.encode_png(arr)
    with Image.open(io.BytesIO(data)) as img:
        back = np.asarray(img)
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        np.testing.assert_array_equal(png.decode_png(data), arr)
