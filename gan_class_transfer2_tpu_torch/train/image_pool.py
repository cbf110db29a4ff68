"""The history of generated images that the published CycleGAN shows its
discriminators (the authors' ``util/image_pool.ImagePool``, after
Shrivastava et al. 2017), kept on the card, one a class.

A query hands D a batch in place of G's fresh fakes, image by image in
batch order: while the pool fills, the fresh image is stored and returned;
once the pool holds ``n`` images, with probability 0.5 a stored image is
returned and the fresh one takes its slot, else the fresh image is returned.
Within a batch a later image may draw the slot that an earlier one has just
taken, and then gets that earlier image back, as in the authors' loop.

The port makes the query without a host sync and with the same outcome:

  * how many images of a batch fill the pool is known on the host
    (``ImagePool.filled``, an int), so the fill is a slice copy;
  * the ``d`` images past the fill draw from the step's ``torch.Generator``,
    in this order: ``torch.rand(d)`` (an image is swapped where its draw
    exceeds 0.5), then ``torch.randint(0, n, (d,))`` (its slot), every
    image drawing both; the authors draw the slot only for a swap, with
    Python's ``random``. On a mesh the draws are the global batch's
    (``d`` times the data extent) and the rank takes its rows, as the
    augment does; each rank keeps a pool of its own rows;
  * what an image gets back is the newest earlier swap of the batch into
    its slot, or the slot's stored image, or itself; what a slot keeps is
    the newest swap into it: both read from a (d, d) comparison of the
    slots, and one ``index_copy_`` writes them (every image whose slot is
    written twice writes the same value).

``query`` runs inside the span ``gan.image_pool`` and counts
``image_pool.queries`` and ``image_pool.images`` (``utils/profiler``). The
pools are part of the GAN's state (``train/gan.GANState.pools``), so a
checkpoint keeps them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import mesh as mesh_lib
from ..utils import profiler


class ImagePool(NamedTuple):
    """``stored``: (n, H, W, C) images on the card; ``filled``: how many of
    its slots hold one (a host int)."""

    stored: torch.Tensor
    filled: int


def init_pools(cfg, dtype, device) -> tuple:
    """Two empty pools of ``cfg.image_pool`` images, of class A's fakes then
    class B's, in ``dtype`` on ``device``."""
    shape = (cfg.image_pool, cfg.size, cfg.size, 3)
    return tuple(ImagePool(torch.zeros(shape, dtype=dtype, device=device), 0) for _ in "ab")


def query(pool: ImagePool, fakes, generator: torch.Generator, mesh=None):
    """``(pool after the query, the images D sees)`` for ``fakes`` (B, H, W,
    C), which are detached and cast to the pool's dtype; the pool's images
    change in place."""
    with profiler.annotate("gan.image_pool"):
        profiler.count("image_pool.queries")
        profiler.count("image_pool.images", fakes.shape[0])
        stored = pool.stored
        fakes = fakes.detach().to(stored.dtype)
        n, b = stored.shape[0], fakes.shape[0]
        fill = min(b, n - pool.filled)
        if fill:
            stored[pool.filled:pool.filled + fill] = fakes[:fill]
        d = b - fill
        if d == 0:
            return pool._replace(filled=pool.filled + fill), fakes
        rows = mesh_lib.global_rows(d, mesh)
        u = torch.rand((rows,), generator=generator, device=generator.device)
        slot = torch.randint(0, n, (rows,), generator=generator, device=generator.device)
        dev = stored.device
        swap = (mesh_lib.local_rows(u, mesh) > 0.5).to(dev)
        slot = mesh_lib.local_rows(slot, mesh).to(dev)
        fresh = fakes[fill:]
        order = torch.arange(d, device=dev)
        # into[j, i]: image i swaps into image j's slot
        into = (slot[:, None] == slot[None, :]) & swap[None, :]
        newest_before = torch.where(into & (order[None, :] < order[:, None]), order[None, :],
                                    -1).amax(dim=1)
        newest = torch.where(into, order[None, :], -1).amax(dim=1)
        old = stored.index_select(0, slot)

        def take(src):  # the image of the batch at src, or the slot's stored one at -1
            got = fresh.index_select(0, src.clamp(min=0))
            return torch.where((src >= 0)[:, None, None, None], got, old)

        out = torch.where(swap[:, None, None, None], take(newest_before), fresh)
        stored.index_copy_(0, slot, take(newest))
        out = torch.cat([fakes[:fill], out]) if fill else out
        return pool._replace(filled=n), out
