"""Disk dataset cache: decode once (native C++), stream forever (memmap) —
counterpart of gan_class_transfer2_tpu/data/cache.py.

  1. ``native_loader.build_cache(files, store, path)`` (``cli build-cache``):
     decode → bilinear shortest-side resize to ``store`` → centre crop →
     packed uint8 records behind a 16-byte header (magic ``0x47435432``,
     version 1, count, store), the JAX package's format byte for byte.
  2. ``CachedDataset`` — a zero-copy ``np.memmap`` reader with
     shuffle-without-replacement epochs (``pipeline.EpochIndexStream``) and
     a restorable position, yielding raw uint8 batches.
  3. ``AugmentedCachedDataset`` — the raw batch goes to the device (4×
     smaller than float32) and ``device_augment.augment_batch`` crops,
     flips and normalises it there, its generator seeded from
     ``(seed + 101, position)`` as ``HBMDataset`` seeds its own, so
     ``set_state`` replays the draws exactly.

Caching stores one ``store``-sized centre view per image, so the training
crop window is limited to that view (the live loaders crop the whole
image); pick ``store`` > ``size`` to keep a crop range.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.api import resolve_device

_MAGIC = 0x47435432
_HEADER_BYTES = 16  # 4 x uint32: magic, version, count, store


def read_cache(path: str):
    """(memmap view (N, store, store, 3) uint8, store). Zero-copy."""
    header = np.fromfile(path, dtype=np.uint32, count=4)
    if len(header) != 4 or header[0] != _MAGIC:
        raise ValueError(f"{path!r} is not a GCT2 dataset cache")
    if header[1] != 1:
        raise ValueError(f"unsupported cache version {header[1]}")
    n, store = int(header[2]), int(header[3])
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=_HEADER_BYTES,
                     shape=(n, store, store, 3))
    return data, store


class CachedDataset:
    """Raw uint8 batches (B, store, store, 3) out of a cache file, epoch-
    exact shuffle, restorable position (state_dict/set_state)."""

    def __init__(self, path: str, batch_size: int, seed: int = 0):
        from .pipeline import EpochIndexStream

        self.images, self.store = read_cache(path)
        self.batch_size = batch_size
        self._stream = EpochIndexStream(len(self.images), batch_size, seed)

    def __len__(self):
        return len(self.images)

    def __iter__(self):
        while True:
            idx = self._stream.next_indices()
            yield np.asarray(self.images[idx])  # copy out of the memmap

    def state_dict(self) -> dict:
        return self._stream.state_dict()

    def set_state(self, state: dict) -> None:
        self._stream.set_state(state)

    def close(self):
        pass


class AugmentedCachedDataset(CachedDataset):
    """``CachedDataset`` + random crop/flip/normalise to ``size`` on
    ``device`` (the card unless the caller asks for the CPU): yields
    float32 (B, size, size, 3) tensors there. ``sharding``
    (``parallel/mesh.batch_sharding``): ``batch_size`` is the global batch;
    each rank reads only its rows' records, onto the sharding's device, and
    augments them with the global batch's draws, so the ranks' rows
    together are the one-process batch."""

    def __init__(self, path: str, size: int, batch_size: int, seed: int = 0,
                 sharding=None, device="cuda"):
        self._mesh = None
        if sharding is not None:
            self._mesh = sharding.mesh
            device = sharding.device
            from ..parallel import mesh as mesh_lib

            extent = mesh_lib.data_axis_size(sharding.mesh)
            if batch_size % extent:
                raise ValueError(f"global batch {batch_size} not divisible by "
                                 f"{extent} ranks")
        super().__init__(path, batch_size, seed)
        if self.store < size:
            raise ValueError(f"cache store={self.store} smaller than crop size={size}")
        self.size = size
        self.device = resolve_device(device)
        self._seed = seed
        self._generator = torch.Generator(device=self.device)

    def __iter__(self):
        from . import device_augment

        from ..parallel import mesh as mesh_lib

        while True:
            idx = mesh_lib.local_rows(self._stream.next_indices(), self._mesh)
            pos = self._stream.position  # the post-draw position keys the augment
            batch = torch.from_numpy(np.asarray(self.images[idx]))  # copy out of the memmap
            if self.device.type == "cuda":
                batch = batch.pin_memory().to(self.device, non_blocking=True)
            self._generator.manual_seed(device_augment._key(self._seed + 101, pos))
            yield device_augment.augment_batch(batch, self._generator, self.size, self._mesh)
