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
"""

from __future__ import annotations

import torch

from ..models import unet
from ..ops import conv as conv_ops
from .spatial import halo_exchange, local_conv


def _down(x, layer, dtype, ax):
    return local_conv(halo_exchange(x, ax, 1, 1), layer.kernel.to(dtype), layer.bias.to(dtype),
                      2, relu=True)


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


def _pair_up(h, layer, dtype, ax):
    """k4/s2 SAME transposed conv on a height shard (exact interior rows);
    a (branch, skip) pair splits the kernel along input channels, and the
    ReLU commutes with the row slice."""
    kernel, bias = layer.kernel.to(dtype), layer.bias.to(dtype)
    if not isinstance(h, tuple):
        rows = h.shape[1]
        y = conv_ops.conv2d_transpose(halo_exchange(h, ax, 1, 1), kernel, bias, stride=2,
                                      relu=True)
        return y[:, 2:2 * rows + 2]
    a, b = h
    ca, rows = a.shape[-1], a.shape[1]
    ya = conv_ops.conv2d_transpose(halo_exchange(a, ax, 1, 1), kernel[:, :, :ca], None, stride=2)
    yb = conv_ops.conv2d_transpose(halo_exchange(b, ax, 1, 1), kernel[:, :, ca:], bias, stride=2)
    return torch.relu(ya + yb)[:, 2:2 * rows + 2]


def _post_blocks(layers, h, dtype, ax):
    for n, layer in enumerate(layers):
        h = _pair_block_conv(h, layer, dtype, ax) if n == 0 else _block_conv(h, layer, dtype, ax)
    return h


def _local_unet(cfg, model, x, ax):
    """The shard-local body (spatial_unet.py:138)."""
    dtype = unet.DTYPES[cfg.compute_dtype]
    x = x.to(dtype)
    h = _apply_block(model.pre_block, x, dtype, ax)

    def rec(i, h):
        level = model.octaves[i]
        inp = h
        h = _down(h, level.down, dtype, ax)
        h = _apply_block(level.block_in, h, dtype, ax)
        if i + 1 < cfg.octaves:
            h = rec(i + 1, h)
        else:
            h = _apply_block(model.middle, h, dtype, ax)
        h = _post_blocks(level.block_out, h, dtype, ax)
        h = _pair_up(h, level.up, dtype, ax)
        if cfg.skip_mode == "concat":
            h = h.to(inp.dtype)
            if cfg.concat_elision:
                return (h, inp)
            return torch.cat([h, inp], dim=-1)
        if cfg.skip_mode == "residual":
            return inp + conv_ops.dense(h, level.skip_dense.to(dtype)).to(inp.dtype)
        return h

    h = rec(0, h) if cfg.octaves > 0 else _apply_block(model.middle, h, dtype, ax)
    h = _post_blocks(model.post_block, h, dtype, ax)
    return unet._pair_dense(h, model.head, dtype)


def _check_config(cfg, n: int) -> None:
    """JAX's three refusals (spatial_unet.py:186-205), by message."""
    if (cfg.size // 2**cfg.octaves) % n != 0:
        raise ValueError(
            f"bottleneck height {cfg.size // 2**cfg.octaves} not shardable "
            f"{n}-way (must divide evenly at every scale)"
        )
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


def make_spatial_unet_apply(cfg, mesh, axis: str = "spatial"):
    """``fn(model, x) -> prediction`` with ``x`` this rank's height shard of
    the input and the prediction its shard of the output; ``model`` a
    whole ``unet.Denoiser``; ``mesh`` a spatial mesh
    (``parallel/spatial_train``). Differentiable: the halos' adjoints carry
    the gradient across shards. float32 convs run in IEEE float32, as
    ``unet_apply``'s."""
    ax = mesh.axis(axis)
    _check_config(cfg, ax.size)

    def fn(model, x):
        with unet.ieee_fp32(unet.DTYPES[cfg.compute_dtype], x.device):
            return _local_unet(cfg, model, x, ax)

    return fn

