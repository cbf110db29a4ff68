"""Host side of the input pipeline — counterpart of
gan_class_transfer2_tpu/data/pipeline.py, with the JAX module's element
semantics (reference train.py:285-321): file glob → read → [optional bytes
cache] → shuffle(1000) → repeat → decode → random crop (size²) → grayscale
broadcast → random flip → ``uint8/128 − 1`` → batch → prefetch.

What differs from the JAX package, and why:

  * PNG files decode through ``utils/png.py``, so training from a folder of
    PNGs needs no Pillow (nor does the native loader). Other formats take
    a lazy Pillow import; when Pillow is missing that raises
    ``DecoderUnavailable``, which no pipeline counts as a bad file: a
    missing decoder stops the run at once with its name, instead of
    surfacing as "100 consecutive decode failures".
  * ``DeviceIterator`` copies each host batch into pinned memory and then
    to the card without blocking (PyTorch's pinned-memory allocator records
    the copy's stream, so a buffer is reused only after its copy ended),
    keeping one batch in flight.
  * ``make_datasets`` prefers the native C++ loader
    (``data/native_loader.py``) as the JAX package does; where it does not
    build, the Python pipeline runs and one printed line gives the
    compiler's reason. ``data_hbm`` builds ``HBMDataset``. One process only.
  * ``DeviceIterator`` carries ``LabeledDataset``'s dict batches: the
    images and the int32 labels each take the same pinned, non-blocking
    copy.

The numpy draws (file order, crop corners, flips, held-out splits) are the
JAX module's, call for call, so one seed gives the same batches in both
packages with one decode worker.
"""

from __future__ import annotations

import glob as globlib
import io
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.api import resolve_device
from ..utils import png


class DecoderUnavailable(RuntimeError):
    """An image format this machine cannot decode (a non-PNG file without
    Pillow). Not a bad file: the pipelines re-raise it."""


def list_files(pattern: str) -> list[str]:
    files = sorted(globlib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no files match {pattern!r}")
    return files


def _read_bytes(data_or_path) -> bytes:
    if isinstance(data_or_path, (bytes, bytearray)):
        return bytes(data_or_path)
    if hasattr(data_or_path, "read"):
        return data_or_path.read()
    with open(data_or_path, "rb") as fh:
        return fh.read()


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        raise DecoderUnavailable(
            "this file is not a PNG, and decoding other image formats needs Pillow, "
            "which is not installed (utils/png.py reads PNG without it)") from None
    return Image


def decode_rgb(data_or_path) -> np.ndarray:
    """An image file (path, bytes or file object) as (H, W, 3) uint8 RGB:
    PNG through ``utils/png``, other formats through Pillow's
    ``convert("RGB")``."""
    data = _read_bytes(data_or_path)
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data)
    with _pillow().open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def image_size(path) -> tuple:
    """(width, height) of an image file from its header, no pixel decode."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head.startswith(png.SIGNATURE):
        return png.png_size(head)
    with _pillow().open(path) as img:
        return img.size


def decode_eval_set(files, size: int, seed: int = 0) -> np.ndarray:
    """Deterministically decode a held-out eval set (fixed crop stream, no
    flip), skipping files the training pipeline also tolerates (too small,
    undecodable) — held_out_split reserves files blindly, so a bad file
    shrinks the set instead of crashing the runner. Returns
    (N', size, size, 3) float32 with N' <= len(files)."""
    rng = np.random.default_rng(seed)
    out = []
    for f in files:
        try:
            out.append(decode_image(f, size, rng, crop=True, flip=False))
        except DecoderUnavailable:
            raise
        except Exception as e:  # noqa: BLE001 — skip exactly like training
            print(f"eval set: skipped undecodable {f!r} ({type(e).__name__}: {e})")
    if not out:
        return np.zeros((0, size, size, 3), np.float32)
    return np.stack(out, 0)


def held_out_split(pattern_or_files, n_eval: int, seed: int = 0):
    """Deterministically split a class's files into (train, eval); the eval
    files never reach training. At least one training file is kept (n_eval
    is capped at len(files) - 1)."""
    files = (
        list_files(pattern_or_files)
        if isinstance(pattern_or_files, str)
        else sorted(pattern_or_files)
    )
    n_eval = max(0, min(n_eval, len(files) - 1))
    order = np.random.default_rng(seed).permutation(len(files))
    return [files[i] for i in order[n_eval:]], [files[i] for i in order[:n_eval]]


class EpochIndexStream:
    """Shuffle-WITHOUT-replacement epoch index stream (the reference's
    shuffle(1000).repeat() over a permuted file list, train.py:318 — every
    element seen once per epoch). Deterministic given (seed, position) and
    restorable: ``state_dict()``/``set_state()`` capture the exact stream
    position for checkpoint/resume. The same ``(n, batch_size, seed)`` gives
    the JAX class's indices."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        if n <= 0:
            # an empty source would make next_indices spin forever
            raise ValueError(f"dataset is empty (n={n})")
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        self._offset = 0
        self._position = 0  # batches produced over the stream lifetime
        self._order_epoch = -1
        self._order = None

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_epoch != epoch:
            self._order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            self._order_epoch = epoch
        return self._order

    def next_indices(self) -> np.ndarray:
        idx = np.empty((self.batch_size,), np.int64)
        got = 0
        while got < self.batch_size:
            order = self._epoch_order(self._epoch)
            take = order[self._offset: self._offset + self.batch_size - got]
            idx[got: got + len(take)] = take
            got += len(take)
            self._offset += len(take)
            if self._offset >= self.n:
                self._epoch += 1
                self._offset = 0
        self._position += 1
        return idx

    @property
    def position(self) -> int:
        return self._position

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset, "position": self._position}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._offset = int(state["offset"])
        self._position = int(state["position"])


def decode_image_uint8(data_or_path, size: int, rng: np.random.Generator,
                       crop: bool = True, flip: bool = True,
                       center: bool = False) -> np.ndarray:
    """Decode one image to (size, size, 3) uint8: RGB, a crop only when the
    image is larger than ``size`` (corner from ``rng``, or the center with
    ``center=True``), images smaller than ``size`` refused, then a
    horizontal flip drawn from ``rng`` unless ``flip=False``."""
    arr = decode_rgb(data_or_path)
    h, w = arr.shape[:2]
    if crop and (h > size or w > size):
        if h < size or w < size:
            raise ValueError(f"image {arr.shape} smaller than crop {size}")
        if center:
            i, j = (h - size) // 2, (w - size) // 2
        else:
            i = rng.integers(0, h - size + 1)
            j = rng.integers(0, w - size + 1)
        arr = arr[i: i + size, j: j + size]
    if arr.shape[0] != size or arr.shape[1] != size:
        raise ValueError(f"image {arr.shape} smaller than crop {size}")
    if flip and rng.integers(0, 2):
        arr = arr[:, ::-1]
    return arr


def decode_image(data_or_path, size: int, rng: np.random.Generator,
                 crop: bool = True, flip: bool = True,
                 center: bool = False) -> np.ndarray:
    """``decode_image_uint8`` normalised to float32 in [-1, 1): ``/128 − 1``."""
    arr = decode_image_uint8(data_or_path, size, rng, crop=crop, flip=flip, center=center)
    return arr.astype(np.float32) / 128.0 - 1.0


class ImageDataset:
    """Infinite shuffled augmented batch iterator over a file glob or list:
    ``num_workers`` decode threads feed a bounded prefetch queue of float32
    (B, size, size, 3) numpy batches. Each worker's file order and crop/flip
    draws come from numpy generators seeded by tuple, as in JAX
    (pipeline.py:252-258). ``state_dict``/``set_state`` carry the count of
    batches served; a resumed stream is a fresh deterministic one (its
    seeds fold in ``resume_round``): threaded decode order cannot be
    replayed."""

    def __init__(self, pattern_or_files, size: int, batch_size: int, seed: int = 0,
                 shuffle_buffer: int = 1000, num_workers: int = 2, prefetch: int = 2,
                 cache: bool = False):
        if isinstance(pattern_or_files, str):
            self.files = list_files(pattern_or_files)
        else:
            self.files = list(pattern_or_files)
            if not self.files:
                raise FileNotFoundError("empty file list")
        self.size = size
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._cache: Optional[dict] = {} if cache else None
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._error: Optional[Exception] = None
        self._batches_served = 0
        self._resume_round = 0

    def _file_stream(self, rng) -> Iterator[str]:
        """shuffle(buffer).repeat() over the file list."""
        buf: list[str] = []
        while True:
            for idx in rng.permutation(len(self.files)):
                buf.append(self.files[idx])
                if len(buf) >= self.shuffle_buffer:
                    k = rng.integers(0, len(buf))
                    buf[k], buf[-1] = buf[-1], buf[k]
                    yield buf.pop()
            while buf:
                k = rng.integers(0, len(buf))
                buf[k], buf[-1] = buf[-1], buf[k]
                yield buf.pop()

    def _read(self, path: str) -> bytes:
        if self._cache is None:
            return _read_bytes(path)
        if path not in self._cache:
            self._cache[path] = _read_bytes(path)
        return self._cache[path]

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _worker(self, worker_id: int):
        base = self.seed + 1_000_003 * self._resume_round
        rng = np.random.default_rng((base, worker_id, 1))
        stream = self._file_stream(np.random.default_rng((base, worker_id, 2)))
        batch = np.empty((self.batch_size, self.size, self.size, 3), np.float32)
        consecutive_failures = 0
        while not self._stop.is_set():
            b = 0
            while b < self.batch_size:
                path = next(stream)
                try:
                    batch[b] = decode_image(self._read(path), self.size, rng)
                    b += 1
                    consecutive_failures = 0
                except DecoderUnavailable as e:
                    self._error = DecoderUnavailable(f"{path!r}: {e}")
                    self._stop.set()
                    return
                except Exception as e:  # noqa: BLE001 — scattered bad files
                    # tolerate scattered bad files, but fail loudly when
                    # nothing decodes instead of hanging the training loop
                    consecutive_failures += 1
                    if consecutive_failures >= max(100, 2 * len(self.files)):
                        self._error = RuntimeError(
                            f"data pipeline: {consecutive_failures} consecutive decode "
                            f"failures (last: {path!r}: {type(e).__name__}: {e})")
                        self._stop.set()
                        return
            self._put(batch.copy())

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.num_workers < 1:
            raise ValueError(f"ImageDataset needs num_workers >= 1, got {self.num_workers}")
        if self._queue is None:
            self._queue = queue.Queue(maxsize=self.prefetch)
            for i in range(self.num_workers):
                t = threading.Thread(target=self._worker, args=(i,), daemon=True)
                t.start()
                self._threads.append(t)
        while True:
            try:
                item = self._queue.get(timeout=5.0)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if self._stop.is_set() or not any(t.is_alive() for t in self._threads):
                    return
                continue
            self._batches_served += 1
            yield item

    def state_dict(self) -> dict:
        return {"batches_served": self._batches_served, "resume_round": self._resume_round}

    def set_state(self, state: dict) -> None:
        if self._queue is not None:
            raise RuntimeError("set_state must be called before iteration")
        self._batches_served = int(state["batches_served"])
        self._resume_round = int(state["resume_round"]) + 1

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)


class ArrayDataset:
    """In-memory dataset: ``images`` (N, H, W, C) uint8 or float32 in
    [-1, 1). Epochs shuffle without replacement (``EpochIndexStream``); the
    flips are keyed by stream position, so ``set_state`` replays exactly."""

    def __init__(self, images: np.ndarray, batch_size: int, seed: int = 0, flip: bool = True):
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 128.0 - 1.0
        self.images = images
        self.batch_size = batch_size
        self.seed = seed
        self.flip = flip
        self._stream = EpochIndexStream(len(images), batch_size, seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            pos = self._stream.position
            batch = self.images[self._stream.next_indices()]
            if self.flip:
                mask = (np.random.default_rng((self.seed, 104729, pos))
                        .integers(0, 2, self.batch_size).astype(bool))
                batch[mask] = batch[mask, :, ::-1]
            yield batch

    def state_dict(self) -> dict:
        return self._stream.state_dict()

    def set_state(self, state: dict) -> None:
        self._stream.set_state(state)


class LabeledDataset:
    """Round-robin over per-class datasets, yielding ``{"image": (B, H, W,
    3), "label": (B,) int32}`` batches for class-conditional training
    (BASELINE config 5; pipeline.py:384-420). ``state_dict`` holds the
    round-robin position ``k`` and each class dataset's own state."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._k = 0  # next class to draw from

    def __iter__(self):
        iters = [iter(d) for d in self.datasets]
        while True:
            k = self._k
            batch = next(iters[k])
            self._k = (k + 1) % len(iters)
            yield {"image": batch, "label": np.full((len(batch),), k, np.int32)}

    def state_dict(self) -> dict:
        return {"k": self._k,
                "datasets": [d.state_dict() if hasattr(d, "state_dict") else None
                             for d in self.datasets]}

    def set_state(self, state: dict) -> None:
        self._k = int(state["k"])
        for d, s in zip(self.datasets, state["datasets"]):
            if s is not None and hasattr(d, "set_state"):
                d.set_state(s)

    def close(self):
        for d in self.datasets:
            if hasattr(d, "close"):
                d.close()


class DeviceIterator:
    """Host batches onto ``device``, one batch in flight: batch N + 1 is
    pinned and its copy to the card queued (non-blocking) before batch N is
    returned, so the copy overlaps the step on batch N. Tensors already on
    the device (``HBMDataset``) pass through; a dict batch
    (``LabeledDataset``) moves entry by entry.

    Because of that prefetch, the dataset's own ``state_dict()`` runs one
    batch ahead of training; ``consumed_state()`` is the snapshot taken
    right after the current batch was pulled, before the next prefetch —
    the position a resumed run continues from (the checkpoint sidecar uses
    it)."""

    def __init__(self, dataset, device="cuda"):
        self._dataset = dataset
        self.device = resolve_device(device)
        self._it = None
        self._pending = None  # (device batch, dataset state right after its pull)
        self._consumed = None

    def _snap(self):
        sd = getattr(self._dataset, "state_dict", None)
        return sd() if sd is not None else None

    def _put(self, x):
        if isinstance(x, dict):
            return {k: self._put(v) for k, v in x.items()}
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._dataset)
            self._pending = (self._put(next(self._it)), self._snap())
        if self._pending is None:
            raise StopIteration
        batch, state = self._pending
        try:
            self._pending = (self._put(next(self._it)), self._snap())
        except StopIteration:
            # the source ended: the batch already on the device is still yielded
            self._pending = None
        self._consumed = state
        return batch

    def consumed_state(self):
        """Dataset state as of the last yielded batch (None before the
        first); excludes the in-flight prefetched batch."""
        return self._consumed


def load_hbm_pool(files, stored: int, size: int = 0, workers: int = 1) -> np.ndarray:
    """Decode files once to deterministic center crops, uint8 — the pool
    that ``HBMDataset`` puts on the card (``Config.data_hbm``).

    Every image with both sides >= ``size`` (the training crop) is taken,
    as the streaming pipeline takes it. A header-only pre-scan finds the
    smallest accepted image; when it is smaller than ``stored`` the pool's
    side is clamped to it (a smaller side only shrinks the crop jitter,
    where dropping those files would bias the corpus). Undecodable and
    too-small files are skipped with a printed line. Decodes run across
    ``workers`` threads straight into the preallocated pool."""
    size = size or stored
    rng = np.random.default_rng(0)  # unused draws (center crop, no flip)
    side = stored
    for f in files:
        try:
            w, h = image_size(f)
        except DecoderUnavailable:
            raise
        except Exception:  # noqa: BLE001 — the decode below reports it
            continue
        if min(h, w) >= size:
            side = min(side, min(h, w))
    if side < stored:
        print(f"hbm pool: side clamped {stored} -> {side} (smallest accepted image in the "
              f"corpus); on-device crop jitter shrinks accordingly")

    out = np.empty((len(files), side, side, 3), np.uint8)
    ok = np.zeros((len(files),), bool)

    def _decode_one(i, f):
        try:
            out[i] = decode_image_uint8(f, side, rng, crop=True, flip=False, center=True)
            ok[i] = True
        except DecoderUnavailable:
            raise
        except Exception as e:  # noqa: BLE001 — same tolerance as training
            print(f"hbm pool: skipped {f!r} ({type(e).__name__}: {e})")

    if workers > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda t: _decode_one(*t), enumerate(files)))
    else:
        for i, f in enumerate(files):
            _decode_one(i, f)
    if not ok.any():
        raise FileNotFoundError(
            f"hbm pool: none of the {len(files)} files decoded at data_hbm={stored}")
    return out if ok.all() else out[ok]


def make_datasets(cfg, files_per_class=None, device="cuda", **kw) -> list:
    """One dataset per class pattern (reference train.py:299-321), or per
    entry of ``files_per_class`` (explicit file lists, e.g. after a
    held-out split).

    ``cfg.data_hbm > 0``: each class is decoded once into a uint8 pool on
    ``device`` (``HBMDataset``, which crops, flips and normalises on the
    device from (seed, position)); otherwise ``cfg.native_loader`` streams
    the files through the C++ loader (``NativeImageDataset``), or an
    ``ImageDataset`` through Python decode threads: with ``cfg.cache``
    (the native loader keeps no file bytes), or where the loader does not
    build, with a printed line that says why.

    Multi-process runs (``parallel/multihost``): each rank reads its round
    robin share of every class's files (``shard_files_for_host``) and loads
    ``host_local_batch_size(cfg.batch_size)`` images a batch, its rows of
    the global batch; an HBM pool holds the rank's share."""
    from ..parallel import multihost

    kw.setdefault("num_workers", cfg.data_workers)
    sources = files_per_class if files_per_class is not None else cfg.class_patterns()
    batch_size = cfg.batch_size
    if multihost.process_count() > 1:
        batch_size = multihost.host_local_batch_size(cfg.batch_size)
        sources = [multihost.shard_files_for_host(
            list_files(src) if isinstance(src, str) else sorted(src)) for src in sources]
    if cfg.data_hbm:
        from .device_augment import HBMDataset

        return [
            HBMDataset(
                load_hbm_pool(list_files(src) if isinstance(src, str) else sorted(src),
                              cfg.data_hbm, size=cfg.size, workers=cfg.data_workers),
                cfg.size, batch_size, seed=cfg.seed + i, device=device)
            for i, src in enumerate(sources)
        ]
    if cfg.native_loader:
        from . import native_loader

        if cfg.cache:
            print("cache=True: using the Python pipeline "
                  "(the native loader does not cache file bytes)")
        elif native_loader.available():
            # shuffle_buffer does not apply: the native loader draws exact
            # per-epoch permutations
            return [
                native_loader.NativeImageDataset(src, cfg.size, batch_size,
                                                 seed=cfg.seed + i, **kw)
                for i, src in enumerate(sources)
            ]
        else:
            lines = (native_loader.build_error() or "unknown error").strip().splitlines()
            reason = next((ln for ln in lines if "error" in ln), lines[0]).strip()
            print(f"native_loader=True: the native C++ loader did not build ({reason}); "
                  "using the Python pipeline (data/pipeline.py)")
    return [
        ImageDataset(src, cfg.size, batch_size, seed=cfg.seed + i,
                     shuffle_buffer=cfg.shuffle_buffer, cache=cfg.cache, **kw)
        for i, src in enumerate(sources)
    ]
