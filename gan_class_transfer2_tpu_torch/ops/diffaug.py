"""Differentiable augmentation of discriminator inputs (DiffAugment) —
counterpart of gan_class_transfer2_tpu/ops/diffaug.py.

Policies (``Config.diffaug``, comma list), each split into a draw and an
apply that takes the draws, so a test can hand JAX's own draws to the
port's apply (``jax.random`` and ``torch.Generator`` give different numbers
from one seed):

  * ``color``       — per-sample brightness U(−0.5, 0.5), saturation U(0, 2)
                      and contrast U(0.5, 1.5) (diffaug.py:27-39);
  * ``translation`` — per-sample integer shift in [−⌈h/8⌉, ⌈h/8⌉] and
                      [−⌈w/8⌉, ⌈w/8⌉], zero pad (diffaug.py:42-57);
  * ``cutout``      — per-sample zeroed square of side size/2 whose corner
                      may hang off the edges (diffaug.py:60-73).

``augment`` draws from the generator on every call, so consecutive calls
and steps see fresh draws. An empty policy is a no-op that draws nothing.
Inputs are NHWC in [-1, 1). On a mesh (``parallel/mesh.py``) the input is
this rank's rows of the global batch: each policy draws for the global
batch and the rank takes its rows, so the ranks together see the draws of
one process.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as mesh_lib


def _uniform(generator, n, lo, hi, like):
    u = torch.rand((n, 1, 1, 1), generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).to(device=like.device, dtype=like.dtype)


def _randint(generator, n, lo, hi, like):
    """Integers in [lo, hi] inclusive."""
    return torch.randint(lo, hi + 1, (n,), generator=generator,
                         device=generator.device).to(like.device)


def draw_color(generator, x, n=None):
    n = x.shape[0] if n is None else n
    return (_uniform(generator, n, -0.5, 0.5, x), _uniform(generator, n, 0.0, 2.0, x),
            _uniform(generator, n, 0.5, 1.5, x))


def color(x, brightness, saturation, contrast):
    """brightness/saturation/contrast: (n, 1, 1, 1)."""
    x = x + brightness
    mean_c = x.mean(dim=-1, keepdim=True)
    x = (x - mean_c) * saturation + mean_c
    mean_s = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean_s) * contrast + mean_s


def _shift_bounds(h, w):
    return max(-(-h // 8), 1), max(-(-w // 8), 1)


def draw_translation(generator, x, n=None):
    n = x.shape[0] if n is None else n
    _, h, w, _ = x.shape
    sy, sx = _shift_bounds(h, w)
    return _randint(generator, n, -sy, sy, x), _randint(generator, n, -sx, sx, x)


def translation(x, ty, tx):
    """ty/tx: (n,) integer shifts; out[i, y, x] = x[i, y + ty[i], x + tx[i]]
    where that lies inside the image, 0 elsewhere."""
    n, h, w, _ = x.shape
    sy, sx = _shift_bounds(h, w)
    pad = torch.nn.functional.pad(x, (0, 0, sx, sx, sy, sy))
    rows = torch.arange(h, device=x.device)[None, :] + sy + ty.long()[:, None]  # (n, h)
    cols = torch.arange(w, device=x.device)[None, :] + sx + tx.long()[:, None]  # (n, w)
    idx = torch.arange(n, device=x.device)[:, None, None]
    return pad[idx, rows[:, :, None], cols[:, None, :]]


def _cut_sides(h, w):
    return max(h // 2, 1), max(w // 2, 1)


def draw_cutout(generator, x, n=None):
    n = x.shape[0] if n is None else n
    _, h, w, _ = x.shape
    ch, cw = _cut_sides(h, w)
    return (_randint(generator, n, -(ch // 2), h - ch // 2, x),
            _randint(generator, n, -(cw // 2), w - cw // 2, x))


def cutout(x, oy, ox):
    """oy/ox: (n,) top-left corners of the zeroed square."""
    n, h, w, _ = x.shape
    ch, cw = _cut_sides(h, w)
    oy, ox = oy.reshape(n, 1, 1), ox.reshape(n, 1, 1)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    inside = (ys >= oy) & (ys < oy + ch) & (xs >= ox) & (xs < ox + cw)  # (n, h, w)
    return x * (1.0 - inside[..., None].to(x.dtype))


POLICIES = {
    "color": (draw_color, color),
    "translation": (draw_translation, translation),
    "cutout": (draw_cutout, cutout),
}


def augment(cfg, generator, x, mesh=None):
    """Apply ``cfg.diffaug``'s policies in order, each with a fresh draw from
    ``generator`` (for the global batch on a mesh, of which ``x`` is this
    rank's rows). No-op (``x`` itself, no draw) for an empty policy."""
    n = mesh_lib.global_rows(x.shape[0], mesh)
    for name in filter(None, cfg.diffaug.split(",")):
        draw, apply = POLICIES[name]
        x = apply(x, *(mesh_lib.local_rows(d, mesh) for d in draw(generator, x, n)))
    return x
