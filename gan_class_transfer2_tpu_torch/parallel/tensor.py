"""Tensor parallelism: the collectives of a conv whose output channels are
split over the mesh's ``model`` axis.

The JAX package has no counterpart module: there ``mesh._leaf_spec`` puts
the last (output-channel) axis of every 4-D kernel on ``model`` and XLA
inserts the collectives from that annotation. Here they are written out,
as four ``torch.autograd.Function``s in two conjugate pairs:

  * ``copy_in``: identity forward; backward, the sum of the input gradient
    over the model group (each rank's kernel slice gives only its share of
    the gradient of the whole, replicated input);
  * ``reduce_sum``: the sum over the model group forward; backward,
    ``copy_in``;
  * ``gather_out``: all-gather of each rank's output channels (NHWC, the
    last dim) forward; backward, this rank's slice of the gradient (the
    layers after the gather run alike on every rank, so that gradient is
    the same on each);
  * ``slice_out``: this rank's slice of the last dim forward (the bias,
    whole on every rank, cut to the rank's channels); backward,
    ``gather_out``, so the bias's gradient is the whole one on every rank.

Each backward is itself one of these Functions, so a double backward (R1's
penalty, ``train/gan.py``) differentiates through them again. Every rank
of a model group runs the same layers in the same order, so the
collectives of the forward, the backward and the double backward line up.

``layer_apply`` is the TP conv: ``fn(*inputs, kernel, bias)`` on the
layer's kernel slice and bias slice, the inputs through ``copy_in`` and the
output through ``gather_out``. A layer is split when its ``tp`` attribute
names the axis (``parallel/mesh.shard_state`` sets it); otherwise
``layer_apply`` is ``fn`` on the whole kernel and bias. Norms run after the
gather, on whole activations; ReLU commutes with the gather, so a conv's
fused ReLU runs before it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import multihost


def _group(axis_name):
    a = multihost.axis(axis_name)
    return a.group, a.size, a.index


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceSum.apply(g, ctx.axis_name), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        group, n, _ = _group(axis_name)
        out = x.contiguous().clone()
        if n > 1:
            with multihost.comm.record("reduce", out):
                dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _CopyIn.apply(g, ctx.axis_name), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        group, n, _ = _group(axis_name)
        if n == 1:
            return x.clone()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        with multihost.comm.record("gather", x):
            dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return _SliceOut.apply(g, ctx.axis_name), None


class _SliceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        _, n, i = _group(axis_name)
        k = x.shape[-1] // n
        return x.narrow(-1, i * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherOut.apply(g, ctx.axis_name), None


def copy_in(x, axis_name: str = "model"):
    return _CopyIn.apply(x, axis_name)


def reduce_sum(x, axis_name: str = "model"):
    return _ReduceSum.apply(x, axis_name)


def gather_out(x, axis_name: str = "model"):
    return _GatherOut.apply(x, axis_name)


def slice_out(x, axis_name: str = "model"):
    return _SliceOut.apply(x, axis_name)


def layer_apply(layer, dtype, fn, *inputs):
    """``fn(*inputs, kernel, bias)`` with the layer's kernel and bias cast to
    ``dtype``: whole on an unsplit layer; on a split one, the rank's kernel
    slice and bias slice on the inputs through ``copy_in``, the output
    channels gathered (``gather_out``)."""
    kernel, bias = layer.kernel.to(dtype), layer.bias.to(dtype)
    ax = getattr(layer, "tp", None)
    if ax is None:
        return fn(*inputs, kernel, bias)
    ins = [copy_in(x, ax) for x in inputs]
    return gather_out(fn(*ins, kernel, slice_out(bias, ax)), ax)
