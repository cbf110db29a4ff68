"""Inference serving: an HTTP API over a checkpoint — counterpart of
gan_class_transfer2_tpu/serve/server.py, with its endpoints, wire formats,
error strings, status codes and ``gct2_*`` metrics.

Endpoints (JSON unless noted):
  GET  /healthz              → {"status": "ok", "step": N}
  GET  /metrics              → ops counters, Prometheus text format
  POST /reload               → hot-swap to the latest checkpoint; → {"step": N}
  POST /sample {"num": k}    → k reverse-diffusion samples; "format": "png"
                               (first image), "base64" (JSON list of PNGs) or
                               "npy" (one .npy of the uint8 (k, H, W, 3) batch);
                               "stream": true sends a multipart stream of
                               intermediate states (num = 1)
  POST /transfer  body=image → class-transferred image: cycle-GAN, query
                               direction=ab|ba; conditional GAN, query to=K
  POST /sample {"class": k}  → samples of class k (conditional checkpoints;
                               class 0 when absent)
  POST /denoise   body=image → single-step denoise preview of the input
  POST /edit      body=image → invert → edit noise → decode; query
                               edits=pixelate,shift,quantise; JSON {edit name:
                               base64 PNG} with the reconstruction

The image-in endpoints take a PNG or JPEG body (resampled to size²) or a raw
``.npy`` uint8 (H, W, 3) / (1, H, W, 3) tensor at exactly size². Their
``format`` query selects ``png`` (default) or ``npy`` (for /edit an ``.npz``
keyed by edit name).

What differs from the JAX package, and why:

  * One process. ``ModelService`` holds the modules that serve (the
    denoiser or its EMA, the generators or their EMAs) as ``nn.Module``s on
    ``device`` (the card unless the caller asks for the CPU), and of the
    states it is given nothing else: no optimizer moments, no
    discriminators. ``mesh=`` (a ``parallel/mesh.LocalMesh`` or a list of
    devices of the service's type) serves over in-process replicas, as JAX
    serves over its local mesh: each serving module is copied to every
    device, a power-of-two bucket of at least the replica count is padded
    to a multiple of it, and /sample, streams, /denoise and the transfers
    split their batch over the replicas, one block after another
    (``make_data_parallel_apply``); /edit runs on the first, and
    so does a batch of fewer rows than replicas, unpadded (JAX pads it to
    the mesh; here each replica would add a sampler pass of launches to a
    request the host paces). ``build_service`` builds that mesh when the
    host has more than one card. A bundle is served without a mesh, as in
    JAX. A model with batch norms keeps only the mesh's data extent: every
    device batch, the smallest too, is zero-padded to a multiple of it as
    JAX pads it, and runs whole on ``device`` (``make_padded_apply``), so
    the padding rows enter the statistics as in JAX's program.
  * A compiled bundle (``bundle=``, utils/bundle.py; ``build_bundle_service``)
    serves /sample, /denoise and /transfer from its programs behind the same
    batchers, with the same uint8 quantisation on the device; /edit,
    streams and /reload are refused as in JAX (its weights are sealed).
  * Request noise comes from a ``torch.Generator`` on the device, seeded
    ``cfg.seed + 99``, drawn at the padded batch's shape.
  * ``reload`` restores only the serving modules' tensors from the
    checkpoint, into fresh copies of those modules, and swaps the module
    references under the device lock. The port's checkpoint restore writes
    into the tensors it is given, so restoring into the live modules would
    change the denoiser under a stream that pinned it; the fresh copies
    keep the pinned module as it was, and the card holds two copies of the
    served weights (not of the train state) while a reload runs.
  * PNGs are encoded and decoded by ``utils/png.py``; Pillow is imported
    only for a non-PNG upload or to resample an upload that is not size²
    (with Pillow's own ``resize``, so the pixels are JAX's), and its absence
    raises ``DecoderUnavailable`` by name.
  * The VQ dictionary of /edit's ``quantise`` is drawn as the port's
    ``sampler.edit_image`` draws it (a CPU generator seeded ``cfg.seed``),
    which cannot reproduce ``jax.random``; ``ModelService.edit_dictionary``
    carries one in.

Device calls run under one lock, on the batchers' collector threads, on
the HTTP handler threads (streams, /edit) and on the asyncio pool; each
sampler function enters ``torch.inference_mode`` itself (it is per thread).
"""

from __future__ import annotations

import base64
import copy
import functools
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from ..data.pipeline import DecoderUnavailable, decode_rgb
from ..models.api import resolve_device
from ..parallel import mesh as mesh_lib
from ..sample import sampler
from ..train import conditional_gan as cgan_lib
from ..train import gan as gan_lib
from ..train import trainer as trainer_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import png


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (≥ 1): every endpoint pads its device batch
    to such a bucket, so a batch's noise shape, and the shapes the kernels
    see, take one of a few values whatever the mix of request sizes."""
    p = 1
    while p < n:
        p *= 2
    return p


class ServerBusy(RuntimeError):
    """A batcher's queue is at ``Config.serve_max_queue`` (or the streams at
    ``serve_max_streams``): the frontends answer 503 + Retry-After instead
    of queueing without bound."""


class _BatchRequest:
    __slots__ = ("num", "payload", "event", "result", "error")

    def __init__(self, num: int, payload=None):
        self.num = num
        self.payload = payload  # the input batch (image endpoints)
        self.event = threading.Event()
        self.result = None
        self.error = None


class _StreamHandle:
    """Iterator over a sample stream holding ONE serve_max_streams slot;
    releases it exactly once — on close(), exhaustion or error (a wrapper
    generator's finally would never run if the stream were closed before
    its first segment, leaking the slot)."""

    def __init__(self, service, inner):
        self._service = service
        self._inner = inner
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            self._release()
            raise

    def close(self):
        try:
            self._inner.close()
        finally:
            self._release()

    def __del__(self):  # abandoned without close(): still release
        self._release()

    def _release(self):
        if self._released:
            return
        self._released = True
        self._service._release_trajectory_slot()


class SampleBatcher:
    """Coalesces concurrent sample requests into one device batch.

    A collector thread gathers requests for up to ``max_wait_s`` (or until
    ``max_batch`` images are pending), runs ONE device call for their sum,
    and slices the results back out to the callers. ``max_batch`` = 128 is
    the JAX server's default, kept; ``chip_smoke.py`` ``[serve]`` prints the
    card's sample img/s and peak memory at device batches 1 to 128."""

    def __init__(self, run_fn: Optional[Callable[[int], np.ndarray]],
                 max_batch: int = 128, max_wait_s: float = 0.01, max_queue: int = 0):
        self._run = run_fn  # total images -> (total, H, W, 3)
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._max_queue = max_queue  # queued-image cap; 0 = unbounded
        self._pending: list[_BatchRequest] = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def depth(self) -> int:
        """Images currently queued (not yet handed to a device batch)."""
        with self._cv:
            return sum(r.num for r in self._pending)

    def submit(self, num: int, payload=None) -> np.ndarray:
        req = _BatchRequest(num, payload)
        with self._cv:
            if self._stop:
                # the collector has exited: an enqueued request would wait
                # on its event forever (handler threads race close())
                raise RuntimeError("server shutting down")
            if self._max_queue > 0 and sum(r.num for r in self._pending) + num > self._max_queue:
                raise ServerBusy(f"request queue full ({self._max_queue} images); retry later")
            self._pending.append(req)
            self._cv.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _execute(self, batch):
        total = sum(r.num for r in batch)
        if any(r.payload is not None for r in batch):
            # conditional sampling: the requests' classes concatenate into
            # one mixed-class device batch. A None payload means no class
            # was requested, not class 0: ModelService.sample resolves the
            # default before submitting, so None here is a caller bug.
            if any(r.payload is None for r in batch):
                raise ValueError("mixed class-conditional and unconditional requests in "
                                 "one batch: resolve a class index before submit()")
            classes = np.concatenate([np.full((r.num,), r.payload, np.int32) for r in batch])
            return self._run(total, classes)
        return self._run(total)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _take_batch(self) -> list[_BatchRequest]:
        """FIFO-greedy up to max_batch images; leftover stays queued."""
        batch, total = [], 0
        while self._pending and total + self._pending[0].num <= self._max_batch:
            r = self._pending.pop(0)
            batch.append(r)
            total += r.num
        if not batch and self._pending:  # single oversize request
            batch.append(self._pending.pop(0))
        return batch

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop:
                    batch = self._pending
                    self._pending = []
                    for r in batch:
                        r.error = RuntimeError("server shutting down")
                        r.event.set()
                    return
                # bounded collection window: let concurrent requests pile in
                deadline = time.monotonic() + self._max_wait
                while sum(r.num for r in self._pending) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._take_batch()
            try:
                images = self._execute(batch)
                off = 0
                for r in batch:
                    r.result = images[off: off + r.num]
                    off += r.num
                    r.event.set()
            except Exception as e:  # noqa: BLE001 — every caller of the batch gets it
                for r in batch:
                    r.error = e
                    r.event.set()


# Request-body cap shared by both frontends (far above any valid request)
MAX_BODY = 64 * 1024 * 1024


class SampleSpec:
    """Validated /sample request — one definition of the bounds and error
    strings for both frontends."""

    __slots__ = ("num", "class_idx", "stream", "segments", "b64", "npy")

    def __init__(self, req):
        if not isinstance(req, dict):
            raise ValueError("request body must be a JSON object")
        try:
            self.num = int(req.get("num", 1))
            self.segments = int(req.get("segments", 4))
            cls = req.get("class")
            self.class_idx = None if cls is None else int(cls)
        except (TypeError, ValueError):
            raise ValueError("num/segments/class must be integers")
        if not 1 <= self.num <= 64:
            raise ValueError("num must be in [1, 64]")
        self.stream = bool(req.get("stream"))
        fmt = req.get("format", "png")
        if fmt not in ("png", "base64", "npy"):
            raise ValueError("format must be png | base64 | npy")
        self.b64 = fmt == "base64"
        self.npy = fmt == "npy"
        if self.stream:
            # segments sizes np.array_split's output; the stream wire format
            # carries one image per frame
            if not 1 <= self.segments <= 64:
                raise ValueError("segments must be in [1, 64]")
            if self.num != 1:
                raise ValueError("streaming supports num=1 (use format=base64 for batches)")


def _to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1) floats → uint8, passing through batches the device program
    already quantised (/sample casts on the device; the other endpoints
    return floats)."""
    if images.dtype == np.uint8:
        return images
    return np.clip((images * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


def _png_bytes(img: np.ndarray) -> bytes:
    return png.encode_png(_to_uint8(img))


def _npy_bytes(images: np.ndarray) -> bytes:
    """(N, H, W, 3) batch → ``.npy`` bytes of the uint8 batch: the raw
    response format for service-to-service clients."""
    buf = io.BytesIO()
    np.save(buf, _to_uint8(images))
    return buf.getvalue()


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Pillow's ``resize((size, size))`` with its default filter, as the JAX
    server resamples an off-size upload."""
    try:
        from PIL import Image
    except ImportError:
        raise DecoderUnavailable(
            f"the uploaded image is {img.shape[1]}x{img.shape[0]}, not {size}x{size}: "
            "resampling it needs Pillow, which is not installed (send a "
            f"{size}x{size} PNG or .npy)") from None
    return np.asarray(Image.fromarray(img).resize((size, size)))


def _decode_png(data: bytes, size: int) -> np.ndarray:
    try:
        img = decode_rgb(data)
    except DecoderUnavailable:
        raise
    except Exception as e:  # noqa: BLE001 — a bad upload is a 400, not a 500
        raise ValueError(f"request body is not a decodable image: {e}")
    if img.shape[:2] != (size, size):
        img = _resize(img, size)
    return np.asarray(img, np.float32)[None] / 128.0 - 1.0


_NPY_MAGIC = b"\x93NUMPY"


def _decode_image(data: bytes, size: int) -> np.ndarray:
    """Request-body image of the image-in endpoints: a PNG/JPEG (resampled to
    size²) or a raw ``.npy`` uint8 tensor (H, W, 3) / (1, H, W, 3), which
    must already be size² (a silent resample of a service-produced tensor
    would hide a pipeline bug). Normalised by /128 − 1, as training is."""
    if not data.startswith(_NPY_MAGIC):
        return _decode_png(data, size)
    try:
        arr = np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:  # noqa: BLE001 — truncated/malformed header
        raise ValueError(f"request body is not a valid .npy: {e}")
    if arr.dtype != np.uint8:
        raise ValueError(f".npy image must be uint8, got {arr.dtype}")
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[0] != 1 or arr.shape[-1] != 3:
        raise ValueError(f".npy image must be (H,W,3) or (1,H,W,3), got {arr.shape}")
    if arr.shape[1] != size or arr.shape[2] != size:
        raise ValueError(
            f".npy image must be {size}x{size} (got "
            f"{arr.shape[1]}x{arr.shape[2]}); raw tensors are not resampled"
        )
    return arr.astype(np.float32) / 128.0 - 1.0


def _image_format(q) -> str:
    """``format`` query of the image-in endpoints: png (default) | npy."""
    fmt = q.get("format", ["png"])[0]
    if fmt not in ("png", "npy"):
        raise ValueError("format must be png | npy")
    return fmt


def _npz_bytes(named: dict) -> bytes:
    """Keyed batches (the /edit response) → ``.npz`` of uint8 arrays."""
    buf = io.BytesIO()
    np.savez(buf, **{k: _to_uint8(v) for k, v in named.items()})
    return buf.getvalue()


class ImageBatcher(SampleBatcher):
    """Image-in/image-out coalescing (denoise, transfer): stacks the
    collection window's input images, runs ONE device call, slices results."""

    def __init__(self, stack_run_fn, max_batch: int = 16, max_wait_s: float = 0.01,
                 max_queue: int = 0):
        super().__init__(None, max_batch, max_wait_s, max_queue)
        self._stack_run = stack_run_fn  # (N, H, W, C) -> (N, H, W, C)

    def submit_image(self, img: np.ndarray) -> np.ndarray:
        return self.submit(img.shape[0], payload=img)

    def _execute(self, batch):
        return self._stack_run(np.concatenate([r.payload for r in batch], axis=0))


class TargetedImageBatcher(SampleBatcher):
    """Image + target-class coalescing (conditional transfer): requests for
    different target classes share one device batch, whose program takes a
    per-sample (B,) target vector."""

    def __init__(self, run_fn, max_batch: int = 16, max_wait_s: float = 0.01,
                 max_queue: int = 0):
        super().__init__(None, max_batch, max_wait_s, max_queue)
        self._targeted_run = run_fn  # (N, H, W, C), (N,) int32 -> (N, H, W, C)

    def submit_targeted(self, img: np.ndarray, target: int) -> np.ndarray:
        return self.submit(img.shape[0], payload=(img, target))

    def _execute(self, batch):
        imgs = np.concatenate([r.payload[0] for r in batch], axis=0)
        targets = np.concatenate([np.full((r.payload[0].shape[0],), r.payload[1], np.int32)
                                  for r in batch])
        return self._targeted_run(imgs, targets)


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


def _serving_part(state):
    """The part of a train state that serves: its step and its evaluation
    weights, one module each (the EMA when kept), in a state of the same
    type with every other field None (no optimizer moments, no
    discriminators)."""
    if isinstance(state, trainer_lib.TrainState):
        return trainer_lib.TrainState(state.step, trainer_lib.eval_model(state), None, None, None)
    if isinstance(state, gan_lib.GANState):
        return gan_lib.GANState(state.step, gan_lib.select_generator(state, "ab"),
                                gan_lib.select_generator(state, "ba"), None, None, None, None,
                                None, None)
    return cgan_lib.ConditionalGANState(state.step, cgan_lib.select_generator(state), None, None,
                                        None, None)


def _reload_target(served, ema: bool):
    """What ``reload`` restores into: a fresh copy of each serving module,
    placed where the checkpoint keeps its values (the EMA entries when
    training kept an EMA), the rest of the state None. Returns (the state
    to restore into, a function of the restored state giving the new
    serving part)."""
    def fresh(module):
        return copy.deepcopy(module).requires_grad_(False)

    if isinstance(served, trainer_lib.TrainState):
        m = fresh(served.model)
        like = trainer_lib.TrainState(0, None if ema else m, None,
                                      list(m.parameters()) if ema else None, None)
        return like, lambda st: trainer_lib.TrainState(st.step, m, None, None, None)
    if isinstance(served, gan_lib.GANState):
        ab, ba = fresh(served.g_ab), fresh(served.g_ba)
        like = gan_lib.GANState(0, None if ema else ab, None if ema else ba, None, None, None,
                                None, ab if ema else None, ba if ema else None)
        return like, lambda st: gan_lib.GANState(st.step, ab, ba, *(None,) * 6)
    g = fresh(served.generator)
    like = cgan_lib.ConditionalGANState(0, None if ema else g, None, None, None,
                                        g if ema else None)
    return like, lambda st: cgan_lib.ConditionalGANState(st.step, g, *(None,) * 4)


class ModelService:
    """Owns the serving modules and the request noise; thread-safe.

    ``state``: a ``trainer.TrainState`` (diffusion, conditional or not; its
    EMA weights when it keeps them), ``gan_state``: a ``gan.GANState``
    (cycle-GAN transfer, the generator EMAs when kept), ``cgan_state``: a
    ``conditional_gan.ConditionalGANState`` (``/transfer?to=K``, the EMA
    generator when kept). With none, a diffusion state is initialised from
    ``cfg.seed``. Each must live on ``device``; the service keeps only its
    serving part (``_serving_part``), as ``self.state``, ``self.gan_state``
    and ``self.cgan_state``.

    ``mesh``: a ``parallel/mesh.LocalMesh`` (or its list of devices, all of
    ``device``'s type) to serve over in-process replicas; one device (or
    None) is the plain path. A bundle is served without one. A model with
    batch norms (``g_norm="batch"``) keeps only the mesh's data extent:
    each device batch is zero-padded to a multiple of it, as JAX pads it,
    and runs whole on the service's device, so the padding rows enter the
    statistics as they do in JAX's program over its data devices."""

    EDIT_NAMES = ("pixelate", "shift", "quantise")

    def __init__(self, cfg, state=None, gan_state=None, cgan_state=None, mesh=None,
                 bundle=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle = bundle
        if bundle is not None:
            mesh = None  # a bundle's programs are sealed: served replicated, as in JAX
        self.mesh = self._local_mesh(mesh)
        # > 1 under batch norm: the data extent every device batch is
        # zero-padded to before it runs whole on the service's device
        self._pad_extent = 1
        if cfg.g_norm == "batch" and self.mesh is not None:
            # batch norm's statistics span the device batch, which JAX's
            # program zero-pads to the mesh's data extent and normalises
            # whole over its data devices
            self._pad_extent, self.mesh = mesh_lib.data_axis_size(self.mesh), None
        if bundle is not None and bundle.device.type != self.device.type:
            raise ValueError(f"the bundle runs on {bundle.device}, the service on {self.device}")
        self._lock = threading.Lock()  # the device: one program at a time
        if state is None and gan_state is None and cgan_state is None and bundle is None:
            state = trainer_lib.init_state(cfg, device=self.device)
        for st, module in ((state, "model"), (gan_state, "g_ab"), (cgan_state, "generator")):
            if st is not None and _device_of(getattr(st, module)).type != self.device.type:
                raise ValueError(f"the state lives on {_device_of(getattr(st, module))}, "
                                 f"the service on {self.device}")
        self.state, self.gan_state, self.cgan_state = (
            None if st is None else _serving_part(st) for st in (state, gan_state, cgan_state))
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 99)
        # the VQ codebook of /edit's quantise; None draws it from cfg.seed
        self.edit_dictionary: Optional[torch.Tensor] = None
        # ops counters, bumped under their own lock (dict += is not atomic
        # across handler, batcher and pool threads)
        self._counters_lock = threading.Lock()
        self._active_streams = 0  # guarded by _counters_lock (stream shed)
        self.counters = {
            "requests_sample": 0,
            "requests_denoise": 0,
            "requests_transfer": 0,
            "requests_edit": 0,
            "requests_stream": 0,
            "device_batches": 0,
            "reloads": 0,
            "rejected_busy": 0,
        }
        self._max_queue = cfg.serve_max_queue
        self._max_wait = cfg.serve_batch_wait_ms / 1000.0
        # the serving modules as the programs take them: a module, or on a
        # mesh the list of its replicas (mesh.replicate)
        self._sample_fn = mesh_lib.make_data_parallel_apply(
            self.mesh, lambda m, init, c: sampler.sample(cfg, m, init, c, snapshots=False).images)
        # the one-forward programs under batch norm: JAX's padded rows, whole
        padded = functools.partial(mesh_lib.make_padded_apply, self._pad_extent)
        self._preview_fn = padded(mesh_lib.make_data_parallel_apply(
            self.mesh, lambda m, x, noise: sampler.preview(cfg, m, x, noise)[0]))
        if self.state is not None:
            self._model = self.state.model
            self._replicas = mesh_lib.replicate(self._model, self.mesh)
            self._batcher = SampleBatcher(self._run_sample, max_wait_s=self._max_wait,
                                          max_queue=self._max_queue)
            self._denoise_batcher = ImageBatcher(self._run_denoise, max_wait_s=self._max_wait,
                                                 max_queue=self._max_queue)
        if self.gan_state is not None:
            self._generators = {"ab": mesh_lib.replicate(self.gan_state.g_ab, self.mesh),
                                "ba": mesh_lib.replicate(self.gan_state.g_ba, self.mesh)}
            self._gan_transfer = padded(gan_lib.make_transfer_fn(cfg, self.mesh))
            self._transfer_batchers = {
                d: ImageBatcher(lambda imgs, d=d: self._run_transfer(imgs, d),
                                max_wait_s=self._max_wait, max_queue=self._max_queue)
                for d in ("ab", "ba")
            }
        if self.cgan_state is not None:
            self._cgan_generator = mesh_lib.replicate(self.cgan_state.generator, self.mesh)
            self._cgan_transfer = padded(cgan_lib.make_transfer_fn(cfg, self.mesh))
            self._cgan_batcher = TargetedImageBatcher(
                self._run_cgan_transfer, max_wait_s=self._max_wait, max_queue=self._max_queue)
        if bundle is not None:
            # the artifact's programs behind the same batchers; a surface
            # whose program the bundle lacks stays unserved
            progs = set(bundle.programs)
            self._model = self._replicas = None
            if "sample" in progs:
                self._batcher = SampleBatcher(self._run_sample, max_wait_s=self._max_wait,
                                              max_queue=self._max_queue)
            if "preview" in progs:
                self._denoise_batcher = ImageBatcher(self._run_denoise,
                                                     max_wait_s=self._max_wait,
                                                     max_queue=self._max_queue)
            gan_dirs = [d for d in ("ab", "ba") if f"transfer_{d}" in progs]
            if gan_dirs:
                self._transfer_batchers = {
                    d: ImageBatcher(lambda imgs, d=d: self._run_transfer(imgs, d),
                                    max_wait_s=self._max_wait, max_queue=self._max_queue)
                    for d in gan_dirs
                }
            if "transfer" in progs:
                self._cgan_batcher = TargetedImageBatcher(
                    self._run_cgan_transfer, max_wait_s=self._max_wait,
                    max_queue=self._max_queue)

    def _local_mesh(self, mesh):
        """``mesh`` as a ``LocalMesh`` of more than one device, or None;
        its devices must be of the service's type (a state on another
        device is refused likewise)."""
        if mesh is None:
            return None
        if not isinstance(mesh, mesh_lib.LocalMesh):
            mesh = mesh_lib.LocalMesh(mesh)
        wrong = [str(d) for d in mesh.devices if d.type != self.device.type]
        if wrong:
            raise ValueError(f"the mesh's devices {wrong} are not of the service's device "
                             f"{self.device}")
        return mesh if mesh.size > 1 else None

    # ----------------------------------------------------- device programs

    def _noise(self, shape) -> torch.Tensor:
        """Request noise from the service's generator (caller holds the lock)."""
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _classes(self, classes, num: int, padded: int):
        """The (padded,) class vector of a device batch on a conditional
        checkpoint (padding rows take class 0), or None on an unconditional
        one."""
        if classes is None and self.cfg.num_classes <= 0:
            return None
        c = np.zeros((padded,), np.int32)
        if classes is not None:
            c[:num] = classes
        return torch.from_numpy(c).to(self.device)

    def _sample_prog(self, models, init, class_idx=None) -> torch.Tensor:
        """Reverse diffusion from ``init`` (split over the mesh's replicas
        when serving over one), quantised to uint8 on the device (clip, then
        truncate, as JAX's program casts): the fetch to the host is then a
        quarter of float32's bytes."""
        if self.bundle is not None:
            images = self.bundle.call("sample", init, *(() if class_idx is None else (class_idx,)))
        else:
            images = self._sample_fn(models, init, class_idx)
        with torch.inference_mode():
            return torch.clamp((images * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)

    def _pad_bucket(self, num: int) -> int:
        """The power-of-two bucket, rounded up to a multiple of the mesh's
        data extent when serving over one (server.py:602-609). Without batch
        norms a bucket smaller than the extent stays as it is: it runs
        whole on the first replica (``make_data_parallel_apply``), where JAX
        pads it to the mesh, since a small batch is paced by its launches
        and each more replica adds a sampler pass of them; no row's answer
        depends on the others'. Under batch norm every bucket is rounded up,
        the smallest too (1 image on 2 devices is 2 rows), because the
        padding rows enter the statistics as in JAX."""
        padded = _pow2(num)
        if self._pad_extent > 1:
            return padded + (-padded) % self._pad_extent
        extent = 1 if self.mesh is None else mesh_lib.data_axis_size(self.mesh)
        if padded >= extent:
            padded += (-padded) % extent
        return padded

    def _run_sample(self, num: int, classes=None) -> np.ndarray:
        """One coalesced device call for ``num`` images, padded to a bucket;
        ``classes``: the per-sample class vector (conditional checkpoints)."""
        padded = self._pad_bucket(num)
        c = self._classes(classes, num, padded)
        self._bump("device_batches")
        with self._lock:
            init = self._noise((padded, self.cfg.size, self.cfg.size, 3))
            return self._sample_prog(self._replicas, init, c)[:num].cpu().numpy()

    def _pad_pow2(self, imgs: np.ndarray):
        """Pad an image batch to its power-of-two bucket (the programs pad it
        to the mesh's extent themselves: ``make_data_parallel_apply``, or
        ``make_padded_apply`` under batch norm)."""
        padded = _pow2(imgs.shape[0])
        if padded == imgs.shape[0]:
            return imgs, imgs.shape[0]
        pad = np.zeros((padded - imgs.shape[0],) + imgs.shape[1:], imgs.dtype)
        return np.concatenate([imgs, pad], 0), imgs.shape[0]

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _run_denoise(self, imgs: np.ndarray) -> np.ndarray:
        """One preview forward; on a conditional checkpoint, class 0 (the
        request carries no class)."""
        x, n = self._pad_pow2(imgs)
        self._bump("device_batches")
        with self._lock:
            noise = self._noise(x.shape)
            if self.bundle is not None:
                c = self._classes(None, n, x.shape[0])
                out = self.bundle.call("preview", self._to_device(x), noise,
                                       *(() if c is None else (c,)))
            else:
                out = self._preview_fn(self._replicas, self._to_device(x), noise)
            return out[:n].cpu().numpy()

    def _run_transfer(self, imgs: np.ndarray, direction: str) -> np.ndarray:
        x, n = self._pad_pow2(imgs)
        self._bump("device_batches")
        with self._lock:
            if self.bundle is not None:
                out = self.bundle.call(f"transfer_{direction}", self._to_device(x))
            else:
                out = self._gan_transfer(self._generators[direction], self._to_device(x))
            return out[:n].cpu().numpy()

    def _run_cgan_transfer(self, imgs: np.ndarray, targets: np.ndarray) -> np.ndarray:
        """One conditional-GAN forward for a mixed-target batch; padding rows
        take target 0."""
        x, n = self._pad_pow2(imgs)
        t = np.zeros((x.shape[0],), np.int32)
        t[:n] = targets
        self._bump("device_batches")
        with self._lock:
            target = torch.from_numpy(t).to(self.device)
            if self.bundle is not None:
                out = self.bundle.call("transfer", self._to_device(x), target)
            else:
                out = self._cgan_transfer(self._cgan_generator, self._to_device(x), target)
            return out[:n].cpu().numpy()

    # ----------------------------------------------------------- state

    @property
    def step(self) -> int:
        if self.bundle is not None:
            return int(self.bundle.manifest["step"])
        for st in (self.state, self.gan_state, self.cgan_state):
            if st is not None:
                return int(st.step)
        raise ValueError("no model state loaded")

    def reload(self) -> int:
        """Hot-swap to the LATEST checkpoint without restarting (serve while
        a training job keeps writing checkpoints). Only the serving modules'
        tensors are read, into fresh copies of those modules, and the module
        references are swapped under the device lock: a stream keeps the
        module it pinned, and no optimizer moments or discriminators are
        ever held. Returns the restored step. A bundle's weights are sealed:
        refused."""
        if self.bundle is not None:
            raise ValueError(
                "bundle serving is immutable (weights are sealed into the "
                "artifact) — re-export and restart to update"
            )
        ckpt_dir = self.cfg.checkpoint_dir
        if not ckpt_dir:
            raise ValueError("no checkpoint_dir configured")
        if ckpt_lib.latest_step(ckpt_dir) is None:
            raise ValueError(f"no checkpoint found in {ckpt_dir!r}")
        ema = self.cfg.ema_decay > 0
        # a concurrent training save with checkpoint_keep may PRUNE the step
        # resolved here mid-restore: retry only when the step vanished,
        # otherwise raise the real error at once
        for _ in range(3):
            step = ckpt_lib.latest_step(ckpt_dir)
            if step is None:
                raise ValueError(f"no checkpoint found in {ckpt_dir!r}")
            try:
                new = []
                for served in (self.state, self.gan_state, self.cgan_state):
                    if served is None:
                        new.append(None)
                        continue
                    like, serving = _reload_target(served, ema)
                    new.append(serving(ckpt_lib.restore(ckpt_dir, ckpt_lib.Subset(like),
                                                        step=step)))
            except Exception:  # noqa: BLE001 — pruned mid-restore?
                if step in ckpt_lib.all_steps(ckpt_dir):
                    raise  # step still there: a genuine restore error
                time.sleep(0.1)  # raced the pruner; re-resolve and retry
                continue
            state, gan_state, cgan_state = new
            # every replica is copied before the lock and swapped under it
            def place(module):
                return mesh_lib.replicate(module, self.mesh)

            replicas = place(state.model) if state is not None else None
            generators = (None if gan_state is None else
                          {"ab": place(gan_state.g_ab), "ba": place(gan_state.g_ba)})
            cgan_generator = place(cgan_state.generator) if cgan_state is not None else None
            with self._lock:
                if state is not None:
                    self.state, self._model, self._replicas = state, state.model, replicas
                if gan_state is not None:
                    self.gan_state, self._generators = gan_state, generators
                if cgan_state is not None:
                    self.cgan_state, self._cgan_generator = cgan_state, cgan_generator
                self._bump("reloads")
            return self.step
        raise RuntimeError("reload kept racing checkpoint pruning; raise checkpoint_keep")

    def metrics_text(self) -> str:
        """Prometheus text exposition of the ops counters + current step."""
        lines = []
        for name, val in sorted(self.counters.items()):
            lines.append(f"# TYPE gct2_{name} counter")
            lines.append(f"gct2_{name} {val}")
        lines.append("# TYPE gct2_checkpoint_step gauge")
        lines.append(f"gct2_checkpoint_step {self.step}")
        lines.append("# TYPE gct2_streams_active gauge")
        with self._counters_lock:
            lines.append(f"gct2_streams_active {self._active_streams}")
        depths = {}
        if getattr(self, "_batcher", None) is not None:
            depths["sample"] = self._batcher.depth()
        if getattr(self, "_denoise_batcher", None) is not None:
            depths["denoise"] = self._denoise_batcher.depth()
        for d, b in getattr(self, "_transfer_batchers", {}).items():
            depths[f"transfer_{d}"] = b.depth()
        if getattr(self, "_cgan_batcher", None) is not None:
            depths["transfer_to"] = self._cgan_batcher.depth()
        if depths:
            lines.append("# TYPE gct2_queue_depth gauge")
            for name, v in sorted(depths.items()):
                lines.append(f'gct2_queue_depth{{batcher="{name}"}} {v}')
        return "\n".join(lines) + "\n"

    def _shed(self, submit_call):
        """Run a batcher submit, counting load-shed rejections."""
        try:
            return submit_call()
        except ServerBusy:
            self._bump("rejected_busy")
            raise

    def _bump(self, name: str):
        with self._counters_lock:
            self.counters[name] += 1

    def _validate_class(self, class_idx: Optional[int]):
        """The class of /sample, streams and /edit: in range on a
        conditional checkpoint, refused on an unconditional one."""
        if class_idx is None:
            return
        if self.cfg.num_classes <= 0:
            raise ValueError("this checkpoint is unconditional (no classes)")
        if not 0 <= class_idx < self.cfg.num_classes:
            raise ValueError(f"class must be in [0, {self.cfg.num_classes})")

    # ------------------------------------------------------- endpoints

    def sample(self, num: int, class_idx: Optional[int] = None) -> np.ndarray:
        if getattr(self, "_batcher", None) is None:
            raise ValueError("sampling not served (no diffusion checkpoint or bundle 'sample' "
                             "program loaded)")
        self._validate_class(class_idx)
        self._bump("requests_sample")
        if class_idx is None and self.cfg.num_classes > 0:
            # a conditional checkpoint with no class requested: class 0,
            # resolved here so that the batcher never guesses what a None
            # payload means in a mixed-class batch
            class_idx = 0
        return self._shed(lambda: self._batcher.submit(num, payload=class_idx))

    def check_streamable(self, class_idx: Optional[int] = None):
        """Raise the errors sample_stream would — BEFORE the HTTP layer has
        committed a 200 multipart header."""
        if self.state is None:
            raise ValueError("streaming requires a checkpoint-backed diffusion server"
                             + (" (not available from a bundle)" if self.bundle else ""))
        self._validate_class(class_idx)

    def sample_stream(self, num: int, segments: int = 4, class_idx: Optional[int] = None):
        """Intermediate reverse-diffusion states: an iterator of ``segments``
        (num, H, W, 3) float arrays, the last being the final batch. Holds
        one ``serve_max_streams`` slot, taken EAGERLY (ServerBusy before the
        frontend commits a 200 header)."""
        self.check_streamable(class_idx)
        self._acquire_trajectory_slot()
        return _StreamHandle(self, self._sample_stream_impl(num, segments, class_idx))

    def _acquire_trajectory_slot(self):
        """Shed for the un-coalesced trajectory endpoints (streams and /edit):
        at most ``serve_max_streams`` at once, ServerBusy (→ 503) beyond."""
        limit = self.cfg.serve_max_streams
        with self._counters_lock:
            if limit > 0 and self._active_streams >= limit:
                self.counters["rejected_busy"] += 1
                raise ServerBusy(
                    f"{self._active_streams} trajectories active "
                    f"(serve_max_streams={limit}); retry later"
                )
            self._active_streams += 1

    def _release_trajectory_slot(self):
        with self._counters_lock:
            self._active_streams -= 1

    def _sample_stream_impl(self, num: int, segments: int, class_idx: Optional[int] = None):
        self._bump("requests_stream")
        padded = self._pad_bucket(num)
        segment = sampler.make_segment_fn(
            self.cfg, None if class_idx is None else self._classes(
                np.full((num,), class_idx, np.int32), num, padded), mesh=self.mesh)
        ts_all = sampler.sample_timesteps(self.cfg)
        # more segments than timesteps is meaningless
        segments = min(max(int(segments), 1), len(ts_all))
        with self._lock:
            x = e = self._noise((padded, self.cfg.size, self.cfg.size, 3))
            # pin the CURRENT denoiser for the whole stream: a /reload
            # between segments must not advance this trajectory with
            # another checkpoint's weights (reload swaps in new modules)
            model = self._replicas
        for ts in np.array_split(ts_all, segments):
            if len(ts) == 0:
                continue
            # lock per segment: a slow client between segments must not
            # stall the other endpoints
            self._bump("device_batches")
            with self._lock:
                x, e = segment(model, x, e, ts)
            yield x[:num].cpu().numpy()

    def close(self):
        for b in ("_batcher", "_denoise_batcher", "_cgan_batcher"):
            if getattr(self, b, None) is not None:
                getattr(self, b).close()
        for b in getattr(self, "_transfer_batchers", {}).values():
            b.close()

    def edit(self, image: np.ndarray, edits=EDIT_NAMES, class_idx: Optional[int] = None) -> dict:
        """invert → edit noise → decode (reference train.py:364-496): 2·T
        denoiser steps, single-flight under the device lock, conditioned on
        ``class_idx`` when given. Returns {edit name: (1, H, W, 3)} with
        'reconstruction'."""
        if self.state is None:
            raise ValueError("edit requires a checkpoint-backed diffusion server"
                             + (" (not available from a bundle)" if self.bundle else ""))
        bad = [e for e in edits if e not in self.EDIT_NAMES]
        if bad:
            raise ValueError(f"unknown edits {bad}; valid: {', '.join(self.EDIT_NAMES)}")
        self._validate_class(class_idx)
        c = None
        if class_idx is not None:
            c = torch.full((1,), class_idx, dtype=torch.int32, device=self.device)
        self._bump("requests_edit")
        # a whole trajectory holding the device: the stream shed counts it
        self._acquire_trajectory_slot()
        try:
            key = tuple(sorted(set(edits)))
            x = self._to_device(image)
            dictionary = self.edit_dictionary
            if dictionary is not None:
                dictionary = dictionary.to(self.device)
            with self._lock:
                out = sampler.edit_image(self.cfg, self._model, x, key, dictionary=dictionary,
                                         class_idx=c)
                self._bump("device_batches")
                # keys sorted, as JAX's jitted program returns its dict
                return {k: out[k].cpu().numpy() for k in sorted(out)}
        finally:
            self._release_trajectory_slot()

    def denoise(self, image: np.ndarray) -> np.ndarray:
        if getattr(self, "_denoise_batcher", None) is None:
            raise ValueError("denoise not served (no diffusion checkpoint or bundle 'preview' "
                             "program loaded)")
        self._bump("requests_denoise")
        return self._shed(lambda: self._denoise_batcher.submit_image(image))

    def transfer(self, image: np.ndarray, direction: str = "ab") -> np.ndarray:
        if direction not in getattr(self, "_transfer_batchers", {}):
            raise ValueError(f"transfer direction {direction!r} not served (no GAN checkpoint "
                             "or bundle transfer program loaded)")
        self._bump("requests_transfer")
        return self._shed(lambda: self._transfer_batchers[direction].submit_image(image))

    def transfer_to(self, image: np.ndarray, target: int) -> np.ndarray:
        """Multi-class conditional transfer (BASELINE config 5): requests
        for different target classes coalesce into one device batch."""
        if getattr(self, "_cgan_batcher", None) is None:
            raise ValueError("conditional transfer not served (no conditional-GAN checkpoint "
                             "or bundle 'transfer' program loaded)")
        if not 0 <= target < self.cfg.num_classes:
            raise ValueError(f"target must be in [0, {self.cfg.num_classes})")
        self._bump("requests_transfer")
        return self._shed(lambda: self._cgan_batcher.submit_targeted(image, target))


def make_handler(service: ModelService):
    class Handler(BaseHTTPRequestHandler):
        # socket timeout: a client that stalls mid-body must not pin a
        # handler thread forever
        timeout = 120

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _png(self, img: np.ndarray):
            return self._raw("image/png", _png_bytes(img))

        def _raw(self, ctype: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok", "step": service.step})
            if self.path == "/metrics":
                body = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            return self._json(404, {"error": f"unknown path {self.path}"})

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            # a negative length would make read(-1) wait for EOF, an absurd
            # one would buffer into RAM
            if length < 0 or length > MAX_BODY:
                raise ValueError(f"body length {length} outside [0, {MAX_BODY}]")
            return self.rfile.read(length)

        def _stream_sample(self, num: int, segments: int, class_idx=None):
            """Chunked multipart stream of intermediate diffusion states
            (image 0 per segment; the final part is the finished image).
            After the 200 multipart header no error can be reported."""
            # the stream slot is taken BEFORE the 200 header: ServerBusy
            # becomes a clean 503 in do_POST
            stream = service.sample_stream(num, segments=segments, class_idx=class_idx)
            boundary = "gct2frame"
            self.send_response(200)
            self.send_header("Content-Type", f"multipart/x-mixed-replace; boundary={boundary}")
            self.end_headers()
            try:
                for snapshot in stream:
                    body = _png_bytes(snapshot[0])
                    self.wfile.write(
                        f"--{boundary}\r\nContent-Type: image/png\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n".encode()
                    )
                    self.wfile.write(body)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()
            except Exception as e:  # noqa: BLE001 — header already committed
                # abort WITHOUT the terminator, so the client sees the truncation
                print(f"stream aborted: {type(e).__name__}: {e}", file=sys.stderr)
                return
            finally:
                stream.close()  # release the stream slot promptly
            self.wfile.write(f"--{boundary}--\r\n".encode())

        def do_POST(self):
            from urllib.parse import parse_qs

            try:
                path, _, query = self.path.partition("?")
                if path == "/sample":
                    spec = SampleSpec(json.loads(self._body() or b"{}"))
                    if spec.stream:
                        service.check_streamable(spec.class_idx)  # errors pre-header
                        return self._stream_sample(spec.num, spec.segments, spec.class_idx)
                    images = service.sample(spec.num, class_idx=spec.class_idx)
                    if spec.npy:
                        return self._raw("application/octet-stream", _npy_bytes(images))
                    if spec.b64:
                        return self._json(200, {"images": [
                            base64.b64encode(_png_bytes(im)).decode() for im in images]})
                    return self._png(images[0])
                if path == "/reload":
                    return self._json(200, {"step": service.reload()})
                if path == "/denoise":
                    fmt = _image_format(parse_qs(query))
                    out = service.denoise(_decode_image(self._body(), service.cfg.size))
                    if fmt == "npy":
                        return self._raw("application/octet-stream", _npy_bytes(out))
                    return self._png(out[0])
                if path == "/edit":
                    q = parse_qs(query)
                    fmt = _image_format(q)
                    raw = q.get("edits", ["pixelate,shift,quantise"])
                    edits = tuple(e for e in raw[0].split(",") if e)
                    cls = q.get("class", [None])[0]
                    img = _decode_image(self._body(), service.cfg.size)
                    out = service.edit(img, edits, class_idx=None if cls is None else int(cls))
                    if fmt == "npy":  # keyed outputs → one .npz
                        return self._raw("application/octet-stream", _npz_bytes(out))
                    return self._json(200, {k: base64.b64encode(_png_bytes(v[0])).decode()
                                            for k, v in out.items()})
                if path == "/transfer":
                    q = parse_qs(query)
                    fmt = _image_format(q)
                    if "to" in q:  # multi-class conditional transfer
                        img = _decode_image(self._body(), service.cfg.size)
                        out = service.transfer_to(img, int(q["to"][0]))
                    else:
                        direction = q.get("direction", ["ab"])[0]
                        if direction not in ("ab", "ba"):
                            return self._json(400, {"error": "direction must be ab|ba"})
                        img = _decode_image(self._body(), service.cfg.size)
                        out = service.transfer(img, direction)
                    if fmt == "npy":
                        return self._raw("application/octet-stream", _npy_bytes(out))
                    return self._png(out[0])
                return self._json(404, {"error": f"unknown path {path}"})
            except ServerBusy as e:
                self.send_response(503)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
                return
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — fault barrier per request
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5, which a burst of more
    # connections can overflow; on an H100 at concurrency 8, one request in
    # 24 then took ~0.8 s, and none did with 128 (PERF.md). The asyncio
    # frontend listens with 100
    request_queue_size = 128


class Server:
    def __init__(self, service: ModelService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.httpd = _HTTPServer((host, port), make_handler(service))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()


def build_service(cfg, model: str = "diffusion", device="cuda") -> ModelService:
    """The ModelService the serve command runs: the latest checkpoint in
    ``cfg.checkpoint_dir`` restored (a warning and random weights from
    ``cfg.seed`` when there is none), on ``device``, served over a
    ``LocalMesh`` of every local card when the host has more than one
    (server.py:1223-1271). The checkpoint's train-time mesh settings are
    ignored: serving replicates over whatever devices this host has."""
    if model not in ("diffusion", "gan", "cgan"):
        raise ValueError(f"model must be diffusion | gan | cgan, got {model!r}")
    device = resolve_device(device)
    local = mesh_lib.local_devices(device)
    mesh = mesh_lib.make_mesh(devices=local) if len(local) > 1 else None
    has_ckpt = bool(cfg.checkpoint_dir) and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None
    if not has_ckpt:
        print(f"warning: no checkpoint found in {cfg.checkpoint_dir!r}; "
              "serving randomly initialised weights", file=sys.stderr)
    if model == "gan":
        gan_state = gan_lib.init_gan_state(cfg, device=device)
        if has_ckpt:
            gan_state = ckpt_lib.restore(cfg.checkpoint_dir, gan_state)
        return ModelService(cfg, gan_state=gan_state, mesh=mesh, device=device)
    if model == "cgan":
        cgan_state = cgan_lib.init_conditional_gan_state(cfg, device=device)
        if has_ckpt:
            cgan_state = ckpt_lib.restore(cfg.checkpoint_dir, cgan_state)
        return ModelService(cfg, cgan_state=cgan_state, mesh=mesh, device=device)
    state = trainer_lib.init_state(cfg, device=device)
    if has_ckpt:
        state = ckpt_lib.restore(cfg.checkpoint_dir, state)
    return ModelService(cfg, state=state, mesh=mesh, device=device)


def build_bundle_service(bundle_path: str, overrides=None, device="cuda") -> ModelService:
    """A ModelService over a compiled model bundle (utils/bundle.py), on
    ``device``: the config and the weights come from the artifact, no
    checkpoint is read and no model is built. It serves the programs the
    bundle carries (/sample, /denoise, /transfer); /edit, streams and
    /reload stay checkpoint-only. ``overrides``: Config fields set
    explicitly (the serving knobs of the CLI's flags) over the manifest's
    config; the model's shape is sealed in the programs."""
    from ..config import Config
    from ..utils import bundle as bundle_lib

    bundle = bundle_lib.load_bundle(bundle_path, device)
    cfg = Config.from_json(json.dumps(bundle.manifest["config"]))
    if overrides:
        cfg = cfg.replace(**overrides).validate()
    return ModelService(cfg, bundle=bundle, device=device)


def serve_from_bundle(bundle_path: str, host: str = "127.0.0.1", port: int = 8080,
                      frontend: str = "threaded", overrides=None, device="cuda"):
    """Serve a compiled model bundle forever (the serve command's --bundle)."""
    service = build_bundle_service(bundle_path, overrides=overrides, device=device)
    if frontend == "aio":
        from .aio import AsyncServer

        AsyncServer(service, host, port).run_forever()
        return
    server = Server(service, host, port)
    print(f"serving bundle {bundle_path} on {host}:{server.port} "
          f"(step {service.step}, programs {service.bundle.programs})", flush=True)
    try:
        server.httpd.serve_forever()
    finally:
        server.httpd.server_close()
        service.close()


def serve_from_checkpoint(cfg, host: str = "127.0.0.1", port: int = 8080,
                          model: str = "diffusion", frontend: str = "threaded",
                          device="cuda"):
    """Load the latest checkpoint and serve forever (the serve command).

    model='diffusion' serves /sample, /denoise and /edit; model='gan'
    serves /transfer?direction= from a cycle-GAN checkpoint, model='cgan'
    /transfer?to= from a conditional-GAN one. frontend='aio' swaps the
    thread-per-connection http.server for the asyncio loop (serve/aio.py),
    with the same endpoints and batching."""
    service = build_service(cfg, model, device)
    if frontend == "aio":
        from .aio import AsyncServer

        # AsyncServer announces the BOUND port itself once the socket is up
        AsyncServer(service, host, port).run_forever()
        return
    server = Server(service, host, port)
    print(f"serving on {host}:{server.port} (step {service.step})", flush=True)
    try:
        server.httpd.serve_forever()
    finally:
        server.httpd.server_close()
        service.close()
