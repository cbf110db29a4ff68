"""Synthetic datasets — counterpart of gan_class_transfer2_tpu/data/synthetic.py,
copied: the module is pure numpy, and the port imports nothing of the JAX
package. Network-free stand-ins for the MNIST/CIFAR-style class pairs named
in BASELINE.json's configs; the same seed gives the JAX module's arrays.

Two-class geometric data with a clean transferable attribute:
  * class A: filled circles; class B: crosses — same color statistics, so a
    class-transfer model must change *shape*, not just color
  * `colored_pair`: class A red-tinted / class B blue-tinted noise — the
    easiest transfer signal (channel statistics), used by fast tests

``save_as_pngs`` writes through ``utils/png.py`` (no Pillow needed).
"""

from __future__ import annotations

import numpy as np


def _canvas(rng, size):
    return rng.uniform(-1.0, -0.6, (size, size, 3)).astype(np.float32)


def circles(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
        r = rng.uniform(size * 0.15, size * 0.3)
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r**2
        color = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        img[mask] = color
        out[i] = img
    return out


def crosses(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 7919)
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = _canvas(rng, size)
        cx, cy = rng.integers(size * 0.3, size * 0.7, 2)
        arm = int(rng.integers(size * 0.15, size * 0.3))
        w = max(1, size // 16)
        color = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        img[max(0, cy - w) : cy + w, max(0, cx - arm) : cx + arm] = color
        img[max(0, cy - arm) : cy + arm, max(0, cx - w) : cx + w] = color
        out[i] = img
    return out


def triangles(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 104729)
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
        h = rng.uniform(size * 0.15, size * 0.3)
        # upright isoceles: |x-cx| <= (y - (cy-h)) / 2 within the height band
        mask = (np.abs(xx - cx) <= (yy - (cy - h)) * 0.5) & (yy <= cy + h) & (
            yy >= cy - h
        )
        img[mask] = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        out[i] = img
    return out


def rings(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 15485863)
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
        r = rng.uniform(size * 0.18, size * 0.3)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        mask = (d2 <= r**2) & (d2 >= (r * 0.55) ** 2)
        img[mask] = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        out[i] = img
    return out


def stripes(n: int, size: int = 32, seed: int = 0, vertical: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed + (32452843 if vertical else 49979687))
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        period = rng.integers(max(size // 8, 2), max(size // 3, 3))
        phase = rng.integers(0, period)
        axis = xx if vertical else yy
        mask = ((axis + phase) // max(period // 2, 1)) % 2 == 0
        img[mask] = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        out[i] = img
    return out


def checkers(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 86028121)
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        cell = rng.integers(max(size // 8, 2), max(size // 3, 3))
        px, py = rng.integers(0, cell, 2)
        mask = (((xx + px) // cell) + ((yy + py) // cell)) % 2 == 0
        img[mask] = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        out[i] = img
    return out


def dots(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 67867967)
    out = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = _canvas(rng, size)
        color = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        for _ in range(int(rng.integers(4, 9))):
            cx, cy = rng.uniform(size * 0.1, size * 0.9, 2)
            r = rng.uniform(size * 0.04, size * 0.08)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r**2] = color
        out[i] = img
    return out


# The 8-class shape corpus used to train the pinned FID feature extractor
# (utils/fid_extractor.py): deterministic, network-free, and diverse enough
# that a classifier's penultimate features must encode shape, texture
# frequency, and layout — not just color statistics.
SHAPE_CLASSES = (
    ("circles", circles),
    ("crosses", crosses),
    ("triangles", triangles),
    ("rings", rings),
    ("hstripes", lambda n, size=32, seed=0: stripes(n, size, seed, vertical=False)),
    ("vstripes", lambda n, size=32, seed=0: stripes(n, size, seed, vertical=True)),
    ("checkers", checkers),
    ("dots", dots),
)


def colored_pair(n: int, size: int = 16, seed: int = 0):
    """(class_a, class_b): red-dominant vs blue-dominant noise images."""
    rng = np.random.default_rng(seed)
    base_a = rng.uniform(-0.2, 0.2, (n, size, size, 3)).astype(np.float32)
    base_b = rng.uniform(-0.2, 0.2, (n, size, size, 3)).astype(np.float32)
    base_a[..., 0] += 0.6
    base_a[..., 2] -= 0.6
    base_b[..., 0] -= 0.6
    base_b[..., 2] += 0.6
    return np.clip(base_a, -1, 0.99), np.clip(base_b, -1, 0.99)


def save_as_pngs(images: np.ndarray, directory: str, prefix: str = "img"):
    """Materialise a synthetic set as PNG files (for exercising the file
    pipeline / CLI end-to-end)."""
    import os

    from ..utils import png

    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(images):
        arr = np.clip((img * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        png.write_png(os.path.join(directory, f"{prefix}_{i:04d}.png"), arr)
