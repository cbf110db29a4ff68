"""Host-side sample-grid rendering — counterpart of
gan_class_transfer2_tpu/utils/grid.py, writing through ``utils/png.py``
instead of Pillow."""

from __future__ import annotations

import os

import numpy as np

from . import png


def grid_png(images, path: str, cols: int = 4):
    """Tile (N, H, W, 3) images in [-1, 1) into one PNG at ``path``."""
    images = np.asarray(images)[: cols * cols]
    n, h, w, _ = images.shape
    rows = (n + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), np.float32) - 1.0
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h: (r + 1) * h, c * w: (c + 1) * w] = img
    arr = np.clip((canvas * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    png.write_png(path, arr)
    return path
