"""Minimal TensorBoard event-file writer — counterpart of
gan_class_transfer2_tpu/utils/tensorboard.py, with no TensorFlow and no Pillow.

Reproduces the reference's observability surface (reference train.py:499-503:
``tf.summary.create_file_writer(os.path.join("logs", day, time))``; scalar
``example loss`` train.py:357-361; image tags ``denoised``, ``step_1``,
``step_0.25``, ``step_0.5``, ``step_0.75``, ``fake`` train.py:356, 489-496),
writing the on-disk format TensorBoard reads:

  * TFRecord framing: u64-LE length, masked-CRC32C(length), payload,
    masked-CRC32C(payload)
  * hand-encoded protobuf wire format for Event / Summary / Image protos
    (field numbers from tensorboard's event.proto / summary.proto)

CRC32C comes from the native loader's C++ (``data/native_loader.py``), as
in the JAX module, with the Python table loop below as its plain version
where the library does not build. Where the JAX module reaches Pillow's PNG
encoder, this one encodes PNGs with ``utils/png.encode_png``, so the JAX
package's ``read_events`` and TensorBoard read its files.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from .png import encode_png

# ----------------------------------------------------------------- CRC32C ---

_CRC_TABLE = []


def _make_crc_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_crc_table()


def crc32c_plain(data: bytes) -> int:
    """CRC32C byte by byte in Python: the plain version of the native
    loader's ``dl_crc32c``, used where that library does not build."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_crc_impl = None  # resolved at the first call, so importing builds nothing


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) through the native loader's slicing-by-8 loop
    (``data/native_loader.crc32c``; the Python loop costs ~0.2 s per logged
    image grid), or ``crc32c_plain`` where the library does not build."""
    global _crc_impl
    if _crc_impl is None:
        from ..data import native_loader

        _crc_impl = native_loader.crc32c if native_loader.available() else crc32c_plain
    return _crc_impl(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding ---


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


# int32 uses the same varint wire encoding as int64 — one implementation
_pb_int32 = _pb_int64


def to_uint8(image: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, matching tf.summary.image's scaling."""
    return np.clip(np.asarray(image, np.float32) * 255.0, 0, 255).astype(np.uint8)


class SummaryWriter:
    """Append-only event-file writer, API-compatible with the subset of
    tf.summary the reference uses (scalar, image)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d.v2" % (
            int(time.time()),
            socket.gethostname(),
            os.getpid(),
        )
        self.path = os.path.join(log_dir, fname)
        self._file = open(self.path, "ab")
        # first record: Event{wall_time, file_version="brain.Event:2"}
        self._write_event(_pb_double(1, time.time()) + _pb_string(3, "brain.Event:2"))

    def _write_event(self, event_payload: bytes):
        data = event_payload
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", _masked_crc(data)))
        self._file.flush()

    def _summary_event(self, step: int, value_payload: bytes):
        summary = _pb_bytes(1, value_payload)  # Summary.value
        return (
            _pb_double(1, time.time())  # Event.wall_time
            + _pb_int64(2, step)  # Event.step
            + _pb_bytes(5, summary)  # Event.summary
        )

    def scalar(self, tag: str, value: float, step: int):
        v = _pb_string(1, tag) + _pb_float(2, float(value))  # Value{tag, simple_value}
        self._write_event(self._summary_event(step, v))

    def image(self, tag: str, images: np.ndarray, step: int, max_outputs: int = 3):
        """images: (B, H, W, C) float in [0, 1] (as the reference passes
        ``x*0.5+0.5``) or uint8. Multiple images get /0, /1 … tag suffixes,
        matching tf.summary.image naming."""
        images = np.asarray(images)
        if images.ndim == 2:  # one channel-less grayscale image
            images = images[None, ..., None]
        elif images.ndim == 3:
            if images.shape[-1] in (1, 3, 4):
                images = images[None]  # one HWC image
            else:
                # a (B, H, W) channel-less batch — treating it as HWC would
                # log transposed garbage with colorspace=W (review r4)
                images = images[..., None]
        if images.dtype != np.uint8:
            images = to_uint8(images)
        n = min(len(images), max_outputs)
        for i in range(n):
            img = images[i]
            image_pb = (
                _pb_int32(1, img.shape[0])  # height
                + _pb_int32(2, img.shape[1])  # width
                + _pb_int32(3, img.shape[2])  # colorspace
                + _pb_bytes(4, encode_png(img))
            )
            suffix = f"/image/{i}" if n > 1 else "/image"
            v = _pb_string(1, tag + suffix) + _pb_bytes(4, image_pb)
            self._write_event(self._summary_event(step, v))

    def close(self):
        self._file.close()


class NullWriter:
    """No-op SummaryWriter twin for non-coordinator processes on a pod —
    every process computes (collectives must stay aligned) but only the
    coordinator writes event files (parallel/multihost.is_coordinator)."""

    path = None

    def scalar(self, tag, value, step):
        pass

    def image(self, tag, images, step, max_outputs=3):
        pass

    def close(self):
        pass


def reference_log_dir(base: str = "logs") -> str:
    """The reference's ``logs/<YYYYMMDD>/<HHMMSS>`` layout (train.py:499-503)."""
    import datetime

    now = datetime.datetime.now()
    return os.path.join(base, now.strftime("%Y%m%d"), now.strftime("%H%M%S"))


# ------------------------------------------------------------------ reader ---
# A tiny decoder used by tests to round-trip what we wrote.


def read_events(path: str):
    """Yield (step, tag, kind, payload) tuples from an event file.

    kind is 'scalar' (payload float) or 'image' (payload PNG bytes) or
    'file_version'."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header), "corrupt length crc"
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload), "corrupt payload crc"
        pos += 12 + length + 4
        yield from _parse_event(payload)


def _read_varint(data, pos):
    result = shift = 0
    while True:
        b = data[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(data):
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 1:
            val = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            val = data[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"wire {wire}")
        yield field, wire, val


def _parse_event(payload):
    step = 0
    summary = None
    version = None
    for field, wire, val in _fields(payload):
        if field == 2 and wire == 0:
            step = val
        elif field == 3 and wire == 2:
            version = val.decode()
        elif field == 5 and wire == 2:
            summary = val
    if version is not None:
        yield (step, "", "file_version", version)
    if summary is None:
        return
    for field, wire, val in _fields(summary):
        if field != 1:
            continue
        tag, scalar, image = None, None, None
        for f2, w2, v2 in _fields(val):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2 and w2 == 5:
                (scalar,) = struct.unpack("<f", v2)
            elif f2 == 4 and w2 == 2:
                image = v2
        if scalar is not None:
            yield (step, tag, "scalar", scalar)
        elif image is not None:
            png = None
            for f3, w3, v3 in _fields(image):
                if f3 == 4:
                    png = v3
            yield (step, tag, "image", png)
