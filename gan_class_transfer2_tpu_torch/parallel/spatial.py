"""Spatial sharding: the height of activations split over ranks — counterpart
of gan_class_transfer2_tpu/parallel/spatial.py.

A rank holds rows ``s·h … (s+1)·h − 1`` of every (B, H, W, C) activation,
``s`` its index on the ``spatial`` axis (a ``multihost.Axis``: the ranks'
process group, its size and this rank's index). Before each conv it
appends the neighbours' boundary rows (``halo_exchange``); the global
edge gets zeros, which is exactly TF-'SAME' padding (1, 1) in height for
the k4/s2 and k3/s1 convs of the model.

``gather_height`` puts a block's images back together where a function
spans the height (the ``dct`` and ``mse_multiscale`` losses of the spatial
step).

JAX moves the halo with ``ppermute``. Here one ``all_gather`` over the
axis moves every rank's ``hi`` first and ``lo`` last rows, and each rank
keeps its neighbours': one collective a halo, of ``(lo + hi)`` rows a
rank, which nccl and gloo both take on CUDA tensors; gloo's
point-to-point calls do not (tools/gloo_cuda_probe.py on an H100: a
``send`` of a CUDA tensor kills the rank). ``halo_exchange`` is an autograd
Function: its adjoint sends each halo row's gradient back to the rank the
row came from, which adds it to its boundary row, by the same kind of
gather. A zero-row halo skips the collective (spatial.py:40-44).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import multihost


def _resolve(ax):
    return multihost.axis(ax) if isinstance(ax, str) else ax


def _exchange(send: torch.Tensor, ax, kind: str = "halo") -> list:
    """Every rank's ``send`` on the axis, in index order (counted as
    ``kind`` by ``multihost.comm``)."""
    if ax.size == 1:
        return [send]
    send = send.contiguous()
    parts = [torch.empty_like(send) for _ in range(ax.size)]
    with multihost.comm.record(kind, send):
        dist.all_gather(parts, send, group=ax.group)
    return parts


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, lo: int, hi: int):
        ctx.ax, ctx.lo, ctx.hi, ctx.h = ax, lo, hi, x.shape[1]
        n, i = ax.size, ax.index
        h = x.shape[1]
        parts = _exchange(torch.cat([x.narrow(1, 0, hi), x.narrow(1, h - lo, lo)], 1), ax)
        b, _, w, c = x.shape
        top = parts[i - 1].narrow(1, hi, lo) if i > 0 else x.new_zeros((b, lo, w, c))
        bottom = parts[i + 1].narrow(1, 0, hi) if i < n - 1 else x.new_zeros((b, hi, w, c))
        return torch.cat([top, x, bottom], 1)

    @staticmethod
    def backward(ctx, g):
        ax, lo, hi, h = ctx.ax, ctx.lo, ctx.hi, ctx.h
        n, i = ax.size, ax.index
        parts = _exchange(torch.cat([g.narrow(1, 0, lo), g.narrow(1, lo + h, hi)], 1), ax)
        dx = g.narrow(1, lo, h).clone()
        if i < n - 1 and lo:  # the next rank's top halo was my last lo rows
            dx[:, h - lo:] += parts[i + 1].narrow(1, 0, lo)
        if i > 0 and hi:  # the previous rank's bottom halo was my first hi rows
            dx[:, :hi] += parts[i - 1].narrow(1, lo, hi)
        return dx, None, None, None


def halo_exchange(x, ax="spatial", lo: int = 1, hi: int = 1):
    """Pad the height axis of this rank's (B, h, W, C) block with ``lo`` rows
    from the previous shard and ``hi`` from the next (zeros at the global
    edge), as JAX's ``halo_exchange`` (spatial.py:60). ``ax``: the axis's
    name (registered with ``multihost``) or a ``multihost.Axis``.
    Differentiable; zero rows on both sides are ``x`` itself, no
    collective."""
    if lo == 0 and hi == 0:
        return x
    return _Halo.apply(x, _resolve(ax), lo, hi)


class _GatherHeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.h = ax, x.shape[1]
        return torch.cat(_exchange(x, ax, "gather"), 1)

    @staticmethod
    def backward(ctx, g):
        ax, h = ctx.ax, ctx.h
        return g.narrow(1, ax.index * h, h).contiguous(), None


def gather_height(x, ax="spatial"):
    """The whole height of this rank's (B, h, W, C) block: every rank's
    block of the axis ``ax`` in index order, by one ``all_gather``. The
    adjoint keeps this rank's rows of the cotangent: every rank computes
    the same function of the whole (a loss whose transform spans the
    height), so the rows' gradient is its own."""
    return _GatherHeight.apply(x, _resolve(ax))


def local_conv(x, kernel, bias, stride: int, relu: bool):
    """A conv VALID in height and padded (1, 1) in width (TF-'SAME' for the
    model's k4/s2 and k3/s1 convs on even widths), + bias, ReLU: the local
    conv of a haloed shard. NHWC × HWIO, cuDNN's ``F.conv2d``."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=(0, 1)).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return torch.relu(y) if relu else y


def sharded_down_conv(x, kernel, bias, ax="spatial"):
    """The k4/s2 'SAME' conv + bias + ReLU (the DownShuffle op) on a height
    shard: a one-row halo each side, then a conv VALID in height
    (spatial.py:72). The shard must hold an even number of rows."""
    if x.shape[1] % 2:
        # an odd per-shard height breaks the stride-2 phase on shards > 0
        raise ValueError(
            f"spatial down-conv needs an even per-shard height, got "
            f"{x.shape[1]} — use fewer spatial shards or a divisible size"
        )
    return local_conv(halo_exchange(x, ax, 1, 1), kernel, bias, 2, relu=True)


def make_spatial_down_conv(mesh, axis: str = "spatial"):
    """``fn(x, kernel, bias) -> y`` on this rank's height shard of a
    (B, H, W, C) input, y its shard of the (B, H/2, W/2, O) output
    (spatial.py:108); ``mesh`` a spatial mesh (``parallel/spatial_train``)."""
    ax = mesh.axis(axis)

    def fn(x, kernel, bias):
        return sharded_down_conv(x, kernel, bias, ax)

    return fn


def spatial_sharding(mesh, axis: str = "spatial"):
    """Batch whole, height over ``axis``: (B, H/n, W, C) a rank."""
    from .mesh import Sharding

    return Sharding(mesh, (None, axis))
