"""8-bit PNG files with the standard library only (zlib, struct): the
machines the port trains and serves on need not have Pillow.

  * ``decode_png`` reads every 8-bit non-interlaced PNG: the five scanline
    filters (None, Sub, Up, Average, Paeth) and colour types 0, 2, 3, 4 and
    6, converted to RGB as Pillow's ``convert("RGB")`` converts them (grey
    replicated, alpha dropped without compositing, palette looked up).
    Anything else — 16-bit or sub-byte samples, interlacing, a broken chunk
    — raises a ValueError that says what.
  * ``png_size`` reads the width and height from the header alone.
  * ``encode_png`` / ``write_png`` write grey, grey + alpha, RGB or RGBA
    with filter-0 scanlines.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def to_uint8(image) -> np.ndarray:
    """[-1, 1) float image → uint8, as the JAX CLI writes its samples."""
    return np.clip((np.asarray(image) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) or (H, W, C) uint8 array, C in 1–4."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"encode_png takes 1 to 4 channels, got shape {image.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, C) uint8 array (C in 1–4) as a PNG file."""
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def read_png(path) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB (``decode_png``)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read())


def _header(data: bytes):
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError("PNG file without its IHDR header")
    return struct.unpack(">IIBBBBB", data[16:29])


def png_size(data: bytes):
    """(width, height) of PNG bytes, from the header alone (the first 24
    bytes suffice)."""
    if not data.startswith(SIGNATURE) or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length] or b"\0\0\0\0")
        if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r} is truncated or fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters (PNG spec §9): ``raw`` holds h rows of one
    filter byte and ``stride`` bytes; returns (h, stride) uint8. None and Up
    are one numpy op a row and Sub a cumulative sum along it; Average and
    Paeth depend on the byte ``bpp`` to the left, so they run byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            b = prev.tobytes()
            if ftype == 3:
                for i in range(bpp):
                    cur[i] = (cur[i] + (b[i] >> 1)) & 0xFF
                for i in range(bpp, stride):
                    cur[i] = (cur[i] + ((cur[i - bpp] + b[i]) >> 1)) & 0xFF
            else:
                for i in range(bpp):
                    cur[i] = (cur[i] + b[i]) & 0xFF
                for i in range(bpp, stride):
                    a, up, c = cur[i - bpp], b[i], b[i - bpp]
                    p = a + up - c
                    pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (up if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG scanline filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB, as Pillow's ``convert("RGB")`` gives
    it, for 8-bit non-interlaced files of colour type 0, 2, 3, 4 or 6."""
    w, h, depth, ctype, compression, filt, interlace = _header(data)
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 3, 4, 6")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit PNGs are read")
    if interlace != 0:
        raise ValueError("interlaced PNG: only non-interlaced PNGs are read")
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG compression {compression} / filter method {filt} unknown")
    if w == 0 or h == 0:
        raise ValueError(f"PNG image of size {w}x{h}")
    idat, palette = [], None
    for tag, body in _chunks(data):
        if tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            palette = body
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    ch = _CHANNELS[ctype]
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    if palette is None or len(palette) % 3:
        raise ValueError("palette PNG without a valid PLTE chunk")
    table = np.zeros((256, 3), np.uint8)  # entries past the palette read as black
    entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
    table[: len(entries)] = entries
    return table[px[..., 0]]
