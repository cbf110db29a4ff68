"""On-device augmentation and the HBM-resident pool — counterpart of
gan_class_transfer2_tpu/data/device_augment.py.

  * ``augment_batch`` — the random-crop / random-flip / ``uint8/128 − 1``
    chain of the reference (train.py:288-292) on the batch's device: the
    pool holds raw uint8 pixels (4× smaller than float32) and the card does
    the arithmetic. Split, like ``ops/diffaug.py``, into ``draw_augment``
    (the per-sample offsets and flips, from a ``torch.Generator``) and
    ``apply_augment`` (one batched gather, then the normalisation), so that a
    test can hand JAX's own draws to the port's apply: ``jax.random`` and
    ``torch.Generator`` give different numbers from one seed.
  * ``HBMDataset`` — a pool that fits in device memory, put on the card once;
    each batch is a gather of its indices (from ``data/pipeline.py``'s
    ``EpochIndexStream``, as in JAX), augmented on the card unless ``raw``,
    when the train step augments it itself (``train/trainer.py``'s
    ``fold_and_augment``). Only the indices cross from the host each step.

The JAX augment is XLA, not a TPU kernel; here it is plain torch. No Python
loop runs over the samples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.api import resolve_device
from ..parallel import mesh as mesh_lib
from .pipeline import EpochIndexStream


def draw_augment(b: int, h: int, w: int, size: int, generator: torch.Generator):
    """Per-sample crop offsets (b, 2) int64, row then column, uniform in
    [0, h − size] × [0, w − size], and horizontal flips (b,) bool with
    probability ½, drawn on ``generator.device`` (device_augment.py:38-46)."""
    dev = generator.device
    rows = torch.randint(0, h - size + 1, (b,), generator=generator, device=dev)
    cols = torch.randint(0, w - size + 1, (b,), generator=generator, device=dev)
    flips = torch.randint(0, 2, (b,), generator=generator, device=dev) == 1
    return torch.stack([rows, cols], 1), flips


def apply_augment(raw, offsets, flips, size: int):
    """raw (B, H, W, 3) uint8, offsets (B, 2) and flips (B,) on raw's device
    → (B, size, size, 3) float32 in [−1, 1): the crop at each offset, flipped
    along W where ``flips``, then ``·(1/128) − 1`` (exact: every uint8/128
    is a float32). One gather for the whole batch."""
    b, dev = raw.shape[0], raw.device
    ar = torch.arange(size, device=dev)
    offsets = offsets.long()
    rows = offsets[:, :1] + ar  # (B, size)
    cols = offsets[:, 1:] + torch.where(flips[:, None], size - 1 - ar, ar)  # (B, size)
    crop = raw[torch.arange(b, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    return crop.to(torch.float32).mul_(1.0 / 128.0).sub_(1.0)


def augment_batch(raw, generator: torch.Generator, size: int, mesh=None):
    """raw: (B, H, W, 3) uint8 with H, W ≥ size → (B, size, size, 3) float32
    in [−1, 1): per-sample random crop and horizontal flip, then /128 − 1.
    Draws on the generator's device, applies on raw's. On a mesh
    (``parallel/mesh.py``) ``raw`` is this rank's rows of the global batch:
    the draws are the global batch's and the rank takes its rows."""
    b, h, w, _ = raw.shape
    offsets, flips = draw_augment(mesh_lib.global_rows(b, mesh), h, w, size, generator)
    offsets, flips = mesh_lib.local_rows(offsets, mesh), mesh_lib.local_rows(flips, mesh)
    return apply_augment(raw, offsets.to(raw.device), flips.to(raw.device), size)


def _key(seed: int, position: int) -> int:
    """The augment generator's seed at one stream position (the JAX pool's
    ``fold_in(PRNGKey(seed), position)``)."""
    return int(np.random.default_rng((seed, position)).integers(0, 2**63))


class HBMDataset:
    """All images resident in device memory; batches drawn on the device.

    ``images``: (N, H, W, 3) uint8 (H, W ≥ size), a numpy array or a tensor —
    yields float32 augmented batches, or raw uint8 batches with ``raw=True``,
    which the train steps augment themselves. A float32 pool already
    normalised to [−1, 1) must be ``size`` × ``size``; its batches are plain
    gathers (crop and flip are for uint8 pools).

    Epochs shuffle without replacement (``EpochIndexStream``, the JAX pool's
    stream for the same ``(N, batch_size, seed)``), and the augment's
    generator is seeded from ``(seed, position)``, so ``set_state`` restores
    the exact draws. ``device`` defaults to the card; without one it raises
    unless ``device="cpu"`` is asked for.

    ``sharding`` (``parallel/mesh.batch_sharding``): the pool lives whole on
    the sharding's device on every rank (a gather takes any index, as the
    JAX pool is replicated over its mesh), ``batch_size`` is the global
    batch, and each rank yields its rows of it, augmented with the global
    batch's draws: the ranks' rows together are the one-process batch."""

    def __init__(self, images, size: int, batch_size: int, seed: int = 0, sharding=None,
                 raw: bool = False, device=None):
        self._mesh = None
        if sharding is not None:
            self._mesh = sharding.mesh
            device = sharding.device
            extent = mesh_lib.data_axis_size(sharding.mesh)
            if batch_size % extent:
                raise ValueError(f"global batch {batch_size} not divisible by "
                                 f"{extent} ranks")
        pool = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
        if pool.dtype == torch.uint8:
            if pool.shape[1] < size or pool.shape[2] < size:
                raise ValueError(f"uint8 pool images {pool.shape[1]}x{pool.shape[2]} are "
                                 f"smaller than size={size}")
            self._augment = not raw
        elif pool.dtype == torch.float32:
            if pool.shape[1] != size or pool.shape[2] != size:
                raise ValueError(
                    "float32 HBM pools must be pre-cropped to the target size (got "
                    f"{pool.shape[1]}x{pool.shape[2]}, size={size}); crop/flip augmentation "
                    "is uint8-only")
            self._augment = False
        else:
            raise TypeError(f"HBMDataset expects uint8 or float32 images, got {pool.dtype}")
        self.device = resolve_device("cuda" if device is None else device)
        self.size = size
        self.batch_size = batch_size
        self.seed = seed
        self._images = pool.to(self.device)
        self._generator = torch.Generator(device=self.device)
        self._stream = EpochIndexStream(pool.shape[0], batch_size, seed)

    def draw(self, idx, position: int):
        """The batch of pool indices ``idx`` at stream ``position``."""
        idx = mesh_lib.local_rows(torch.as_tensor(idx, dtype=torch.int64), self._mesh)
        batch = self._images[idx.to(self.device)]
        if self._augment:
            self._generator.manual_seed(_key(self.seed, position))
            batch = augment_batch(batch, self._generator, self.size, self._mesh)
        return batch

    def __iter__(self):
        while True:
            pos = self._stream.position
            yield self.draw(self._stream.next_indices(), pos)

    def state_dict(self) -> dict:
        return self._stream.state_dict()

    def set_state(self, state: dict) -> None:
        self._stream.set_state(state)

    def close(self):
        pass
