"""The U-Net forward on height-sharded activations — counterpart of
gan_class_transfer2_tpu/parallel/spatial_unet.py.

Each rank runs the whole Denoiser (models/unet.py) on its rows of every
activation: every k4/s2 down conv, k3/s1 block conv and k4/s2 transposed
conv exchanges a one-row halo with its neighbours (``spatial.halo_exchange``)
and computes locally; the concat skips, the middle block and the dense head
are local. Parameters are whole on every rank.

Halo math (exact against the unsharded TF-'SAME' ops):
  * k4/s2 and k3/s1 convs: SAME pads (1, 1), so one halo row each side and
    a conv VALID in height, padded (1, 1) in width (``spatial.local_conv``);
  * k4/s2 transposed conv: the plain SAME transposed conv on the (1, 1)-
    haloed shard, keeping output rows ``[2, 2h + 2)``: interior rows depend
    only on inputs the halo provides.

The convs are cuDNN's (``F.conv2d``, ``F.conv_transpose2d``), as JAX's are
``lax.conv_general_dilated`` outside any Pallas kernel. Concat skips stay
an unmaterialised (branch, skip) pair, each consumer splitting its kernel
along input channels; the halo of a pair is the pair of halos.

Every intermediate shard height must stay ≥ 1 and even wherever a further
down conv consumes it: ``size / 2**octaves`` divisible by the shard count.

``make_spatial_unet_apply`` is JAX's function and keeps JAX's refusals of
``g_norm`` and ``per_step_output``. The spatial train step builds its body
through ``make_local_apply``, which takes both, as JAX's GSPMD step does:
  * ``g_norm`` in ``models/unet.py``'s order (conv without its ReLU, the
    norm, the ReLU) after each down and up conv; instance norm is B3 over
    height blocks (``ops/norm.instance_norm_blocks``: the statistics of
    every image span the spatial group's blocks), batch norm sums over the
    data and spatial ranks (``ops/norm.batch_norm`` under the body's
    ``stats_over("data", "spatial")``);
  * ``per_step_output``: the head's gather on t − 1, per sample and pixel,
    so local (each rank holds all of its samples' steps);
  * ``remat``: each inner octave under ``torch.utils.checkpoint``, as in
    ``models/unet.py``; its recompute re-runs the octave's halos and norm
    collectives in the backward.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models import unet
from ..ops import conv as conv_ops
from ..ops import norm as norm_ops
from .spatial import halo_exchange, local_conv


def _normed(cfg) -> bool:
    return getattr(cfg, "g_norm", "none") not in ("none", None)


def _norm_relu(cfg, h, params, ax):
    """The ReLU of ``cfg.g_norm`` of a height block (unet.py's order)."""
    if cfg.g_norm == "instance":
        h = norm_ops.instance_norm_blocks(h, params.gamma, params.beta, ax)
    elif cfg.g_norm == "batch":
        h = norm_ops.batch_norm(h, params.gamma, params.beta)
    else:
        raise ValueError(f"unknown norm {cfg.g_norm!r}")
    return torch.relu(h)


def _down(cfg, x, level, dtype, ax):
    normed = _normed(cfg)
    layer = level.down
    h = local_conv(halo_exchange(x, ax, 1, 1), layer.kernel.to(dtype), layer.bias.to(dtype), 2,
                   relu=not normed)
    return _norm_relu(cfg, h, level.down_norm, ax) if normed else h


def _block_conv(x, layer, dtype, ax):
    return local_conv(halo_exchange(x, ax, 1, 1), layer.kernel.to(dtype), layer.bias.to(dtype),
                      1, relu=True)


def _apply_block(layers, x, dtype, ax):
    for layer in layers:
        x = _block_conv(x, layer, dtype, ax)
    return x


def _pair_block_conv(h, layer, dtype, ax):
    if not isinstance(h, tuple):
        return _block_conv(h, layer, dtype, ax)
    a, b = h
    ca = a.shape[-1]
    kernel = layer.kernel.to(dtype)
    ya = local_conv(halo_exchange(a, ax, 1, 1), kernel[:, :, :ca], None, 1, relu=False)
    yb = local_conv(halo_exchange(b, ax, 1, 1), kernel[:, :, ca:], layer.bias.to(dtype), 1,
                    relu=False)
    return torch.relu(ya + yb)


def _pair_up(cfg, h, level, dtype, ax):
    """k4/s2 SAME transposed conv on a height shard (exact interior rows);
    a (branch, skip) pair splits the kernel along input channels, and the
    ReLU commutes with the row slice. Under ``g_norm`` the norm comes
    between the sliced conv and the ReLU."""
    layer = level.up
    kernel, bias = layer.kernel.to(dtype), layer.bias.to(dtype)
    if not isinstance(h, tuple):
        rows = h.shape[1]
        y = conv_ops.conv2d_transpose(halo_exchange(h, ax, 1, 1), kernel, bias, stride=2)
    else:
        a, b = h
        ca, rows = a.shape[-1], a.shape[1]
        y = (conv_ops.conv2d_transpose(halo_exchange(a, ax, 1, 1), kernel[:, :, :ca], None,
                                       stride=2)
             + conv_ops.conv2d_transpose(halo_exchange(b, ax, 1, 1), kernel[:, :, ca:], bias,
                                         stride=2))
    y = y[:, 2:2 * rows + 2]
    return _norm_relu(cfg, y, level.up_norm, ax) if _normed(cfg) else torch.relu(y)


def _post_blocks(layers, h, dtype, ax):
    for n, layer in enumerate(layers):
        h = _pair_block_conv(h, layer, dtype, ax) if n == 0 else _block_conv(h, layer, dtype, ax)
    return h


def _local_unet(cfg, model, x, ax, t=None):
    """The shard-local body (spatial_unet.py:138); ``t`` (B,) the samples'
    steps under ``per_step_output``. ``cfg.remat`` checkpoints each inner
    octave as ``unet.unet_apply`` does: its recompute runs on whatever
    thread autograd calls it (on the card, its device thread), so it
    reopens the forward's ``ieee_fp32`` region and statistics axes, and
    re-runs the octave's halo exchanges and norm collectives. Every rank
    recomputes the same checkpoints in the same order, whatever its data,
    so the collectives of the recompute line up as the forward's do."""
    dtype = unet.DTYPES[cfg.compute_dtype]
    stats = norm_ops.stats_names()
    x = x.to(dtype)
    h = _apply_block(model.pre_block, x, dtype, ax)

    def rec(i, h):
        level = model.octaves[i]
        inp = h
        h = _down(cfg, h, level, dtype, ax)
        h = _apply_block(level.block_in, h, dtype, ax)
        if i + 1 < cfg.octaves:
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(inner, i + 1, h, use_reentrant=False)
            else:
                h = rec(i + 1, h)
        else:
            h = _apply_block(model.middle, h, dtype, ax)
        h = _post_blocks(level.block_out, h, dtype, ax)
        h = _pair_up(cfg, h, level, dtype, ax)
        if cfg.skip_mode == "concat":
            h = h.to(inp.dtype)
            if cfg.concat_elision:
                return (h, inp)
            return torch.cat([h, inp], dim=-1)
        if cfg.skip_mode == "residual":
            return inp + conv_ops.dense(h, level.skip_dense.to(dtype)).to(inp.dtype)
        return h

    def inner(i, h):
        with unet.ieee_fp32(dtype, h.device), norm_ops.stats_over(*stats):
            return rec(i, h)

    h = rec(0, h) if cfg.octaves > 0 else _apply_block(model.middle, h, dtype, ax)
    h = _post_blocks(model.post_block, h, dtype, ax)
    return unet.per_step_gather(cfg, unet._pair_dense(h, model.head, dtype), t)


def _check_shards(cfg, n: int) -> None:
    if (cfg.size // 2**cfg.octaves) % n != 0:
        raise ValueError(
            f"bottleneck height {cfg.size // 2**cfg.octaves} not shardable "
            f"{n}-way (must divide evenly at every scale)"
        )


def _check_config(cfg, n: int) -> None:
    """JAX's three refusals (spatial_unet.py:186-205), by message."""
    _check_shards(cfg, n)
    if cfg.per_step_output:
        raise NotImplementedError(
            "per_step_output is not supported by the spatial path (the "
            "t-gather is not implemented here); use models.unet.unet_apply"
        )
    if getattr(cfg, "g_norm", "none") != "none":
        raise NotImplementedError(
            "g_norm is not supported by the spatial path — instance/batch "
            "statistics span the height axis, which is sharded here, so a "
            "correct implementation needs cross-shard psum reductions; "
            "silently skipping the norm layers would diverge from "
            "models.unet.unet_apply"
        )


def make_local_apply(cfg, mesh, axis: str = "spatial"):
    """``fn(model, x, t=None) -> prediction`` as ``make_spatial_unet_apply``'s,
    with ``g_norm`` and ``per_step_output`` taken (``t``: the (B,) steps of
    the rank's samples): the spatial train step's body. Only the shard
    count is refused. Its batch norms take their statistics over the
    ``data`` and ``axis`` ranks (the axes ``parallel/spatial_train``
    registers). ``cfg.remat`` rematerialises each inner octave in the
    backward, as ``unet.unet_apply`` does (JAX's spatial step runs the
    unchanged ``unet_apply``, whose octaves sit in ``jax.checkpoint``)."""
    ax = mesh.axis(axis)
    _check_shards(cfg, ax.size)

    def fn(model, x, t=None):
        with unet.ieee_fp32(unet.DTYPES[cfg.compute_dtype], x.device), (
                norm_ops.stats_over("data", axis)):
            return _local_unet(cfg, model, x, ax, t)

    return fn


def make_spatial_unet_apply(cfg, mesh, axis: str = "spatial"):
    """``fn(model, x) -> prediction`` with ``x`` this rank's height shard of
    the input and the prediction its shard of the output; ``model`` a
    whole ``unet.Denoiser``; ``mesh`` a spatial mesh
    (``parallel/spatial_train``). Differentiable: the halos' adjoints carry
    the gradient across shards. float32 convs run in IEEE float32, as
    ``unet_apply``'s."""
    _check_config(cfg, mesh.axis(axis).size)
    return make_local_apply(cfg, mesh, axis)

