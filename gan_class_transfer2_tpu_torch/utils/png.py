"""8-bit RGB PNG files with the standard library only (zlib, struct): the
machines the port serves on need not have Pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def to_uint8(image) -> np.ndarray:
    """[-1, 1) float image → uint8, as the JAX CLI writes its samples."""
    return np.clip((np.asarray(image) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array, one filter-0 scanline per row."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3), got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                 + _chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read back a file that ``write_png`` wrote (8-bit RGB, filter 0 rows)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
    w, h = header[0], header[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter-0 scanlines are read")
    return rows[:, 1:].reshape(h, w, 3).copy()
