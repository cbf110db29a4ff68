"""ctypes binding of the native C++ data loader (data/native/dataloader.cc) —
counterpart of gan_class_transfer2_tpu/data/native_loader.py.

The shared library is built at first use with the host's ``g++``, linked
with zlib and, where ``jpeglib.h`` is found, libjpeg, into
``build/dataloader-<hash>.so`` (``ops/_build.load_host``); nothing is built
at import. ``available()`` says whether it builds and loads,
``build_error()`` why not, ``jpeg_available()`` whether it decodes JPEG.
Elements are ``pipeline.decode_image``'s: crop, flip, ``uint8/128 − 1``.
A JPEG where the build has no JPEG decoder raises
``pipeline.DecoderUnavailable``, as a non-PNG without Pillow does in the
Python pipeline: a missing decoder is not a bad file.

What differs from the JAX module, and why:

  * PNG is decoded by the port's own C++ over zlib, where JAX's links
    libpng: the card's machine has zlib's headers but not libpng's, and
    one code path on every machine keeps the CPU tests on what the card
    runs. libjpeg is linked only where ``jpeglib.h`` is found.
  * ``decode_one(augment=False)`` asks the library for the image's size
    (a first call with no buffer) instead of reading the header with
    Pillow, so it needs no Pillow.
  * The loader's stream does not depend on timing: batch k holds the same
    images, cropped and flipped alike, for any number of workers wherever
    every file decodes (see the C++ source).
  * ``close()`` may run while another thread is blocked in ``__iter__``:
    it stops the loader, which wakes that thread, waits until its call has
    returned and only then frees the handle.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "dataloader.cc"

_lock = threading.Lock()
_lib = None
_error = None


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; RuntimeError with the
    compiler's message when it does not build (tried once a process)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        from ..ops import _build

        try:
            lib = _build.load_host(SOURCE, _flags())
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(_error) from None
        c_int, c_void_p, c_u64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64
        lib.dl_create.restype = c_void_p
        lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int, c_int,
                                  c_int, c_u64]
        lib.dl_next.restype = c_int
        lib.dl_next.argtypes = [c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.dl_stop.restype = None
        lib.dl_stop.argtypes = [c_void_p]
        lib.dl_error.restype = ctypes.c_char_p
        lib.dl_error.argtypes = [c_void_p]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [c_void_p]
        lib.dl_cache_build.restype = c_int
        lib.dl_cache_build.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int,
                                       ctypes.c_char_p]
        lib.dl_decode_one.restype = c_int
        lib.dl_decode_one.argtypes = [ctypes.c_char_p, c_int, c_u64, c_int,
                                      ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                      ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
        lib.dl_crc32c.restype = ctypes.c_uint32
        lib.dl_crc32c.argtypes = [ctypes.c_char_p, c_u64]
        _lib = lib
        return lib


def _jpeg_headers() -> bool:
    """Whether the host's g++ finds libjpeg's header."""
    try:
        r = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    except OSError:
        return False
    return r.returncode == 0


@functools.lru_cache(maxsize=1)
def _flags() -> tuple:
    """The loader's link flags (and its JPEG define) on this host."""
    return ("-DGCT2_JPEG", "-lz", "-ljpeg") if _jpeg_headers() else ("-lz",)


def jpeg_available() -> bool:
    """Whether the built library decodes JPEG (jpeglib.h was found)."""
    _load()
    return "-DGCT2_JPEG" in _flags()


def _no_jpeg(path) -> "pipeline.DecoderUnavailable":
    from .pipeline import DecoderUnavailable

    return DecoderUnavailable(f"{path!r} is a JPEG, and this build of the native loader has "
                              "no JPEG decoder (jpeglib.h was not found when it was built)")


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def build_error():
    """Why the library did not build (the compiler's message), or None."""
    available()
    return _error


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data`` by the library's slicing-by-8 loop."""
    return int(_load().dl_crc32c(data, len(data)))


def _file_list(pattern_or_files) -> list:
    from .pipeline import list_files

    if isinstance(pattern_or_files, str):
        return list_files(pattern_or_files)
    files = list(pattern_or_files)
    if not files:
        raise FileNotFoundError("empty file list")
    return files


def _c_paths(files):
    keep = [str(f).encode() for f in files]
    return keep, (ctypes.c_char_p * len(keep))(*keep)


def build_cache(pattern_or_files, store: int, out_path: str) -> int:
    """Decode every file once, bilinear shortest-side resize to ``store``,
    centre crop, and pack them as uint8 records that ``data/cache.py``
    reads. Returns the records written."""
    lib = _load()
    files = _file_list(pattern_or_files)
    keep, arr = _c_paths(files)
    n = lib.dl_cache_build(arr, len(keep), store, str(out_path).encode())
    if n <= -2:
        raise _no_jpeg(files[-2 - n])
    if n < 0:
        raise RuntimeError(f"cache build failed for {out_path!r}")
    if n == 0:
        raise RuntimeError("cache build: no file decoded")
    return n


def decode_one(path: str, size: int, seed: int = 0, augment: bool = True) -> np.ndarray:
    """One file through the native decode: ``augment=True`` gives the
    (size, size, 3) crop/flip/normalised element drawn from ``seed``;
    ``False`` the whole image, normalised only."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    name = str(path).encode()
    if augment:
        out = np.empty((size, size, 3), np.float32)
    else:
        rc = lib.dl_decode_one(name, size, seed, 0, None, 0, ctypes.byref(h), ctypes.byref(w))
        if rc == -4:
            raise _no_jpeg(path)
        if rc != -3:
            raise ValueError(f"native decode failed ({rc}) for {path}")
        out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.dl_decode_one(name, size, seed, 1 if augment else 0,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
                           ctypes.byref(h), ctypes.byref(w))
    if rc == -4:
        raise _no_jpeg(path)
    if rc != 0:
        raise ValueError(f"native decode failed ({rc}) for {path}")
    return out


class NativeImageDataset:
    """``pipeline.ImageDataset``'s interface over the C++ loader: infinite
    (B, size, size, 3) float32 batches, each file once per epoch.
    ``state_dict``/``set_state`` carry the batches served and the resume
    round; a resumed stream is a fresh one seeded ``seed + 1_000_003 ·
    resume_round``, as in JAX."""

    def __init__(self, pattern_or_files, size: int, batch_size: int, seed: int = 0,
                 num_workers: int = 2, prefetch: int = 2, **_):
        self.files = _file_list(pattern_or_files)
        self._paths, self._arr = _c_paths(self.files)
        self.size = size
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._lib = _load()
        self._batches_served = 0
        self._resume_round = 0
        self._handle = None
        self._started = False
        self._calls = 0  # threads inside dl_next
        self._cond = threading.Condition()
        self._create()

    def _create(self):
        handle = self._lib.dl_create(self._arr, len(self._paths), self.size, self.batch_size,
                                     self.num_workers, self.prefetch,
                                     self.seed + 1_000_003 * self._resume_round)
        if not handle:
            raise RuntimeError("dl_create failed")
        self._release()
        self._handle = handle

    def state_dict(self) -> dict:
        return {"batches_served": self._batches_served, "resume_round": self._resume_round}

    def set_state(self, state: dict) -> None:
        if self._started:
            # swapping the handle under a live iterator would free it under dl_next
            raise RuntimeError("set_state must be called before iteration")
        self._batches_served = int(state["batches_served"])
        self._resume_round = int(state["resume_round"]) + 1
        self._create()  # workers restart on the resume seed

    def __iter__(self) -> Iterator[np.ndarray]:
        self._started = True
        while True:
            out = np.empty((self.batch_size, self.size, self.size, 3), np.float32)
            with self._cond:
                handle = self._handle
                if handle is None:
                    return  # closed
                self._calls += 1
            try:
                rc = self._lib.dl_next(handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                msg = (self._lib.dl_error(handle) or b"").decode() if rc in (-2, -3) else ""
            finally:
                with self._cond:
                    self._calls -= 1
                    self._cond.notify_all()
            if rc == -3:
                from .pipeline import DecoderUnavailable

                raise DecoderUnavailable(msg)
            if rc == -2:
                raise RuntimeError(msg or "native loader failed")
            if rc != 0:
                return
            self._batches_served += 1
            yield out

    def _release(self):
        """Stop the loader, wait for threads inside dl_next to return, free it."""
        with self._cond:
            handle, self._handle = self._handle, None
            if handle is None:
                return
            self._lib.dl_stop(handle)
            while self._calls:
                self._cond.wait()
        self._lib.dl_destroy(handle)

    def close(self):
        if getattr(self, "_cond", None) is not None:
            self._release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
