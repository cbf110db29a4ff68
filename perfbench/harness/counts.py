"""Operations and bytes, counted from shapes: the yardstick of the
utilisation and roofline readers.

  * ``count_flops(fn, *args)``: the model FLOPs of a call of the plain
    reference, run once on shape-only tensors under ``FlopCounterMode`` (2 per
    multiply-add of the convolutions and matrix products, forward and
    whatever backward ``fn`` takes; elementwise work is not counted), so
    the count is the same whatever implements the work, and no
    recomputation is in it;
  * ``model_flops_per_image(cfg)``: the analytic forward count of the
    denoiser, the check on the counter (42.908909568 GFLOP at ``Config()``);
  * ``down_conv``, ``instance_norm``, ``adam``: one call's
    ``(operations, bytes)``, each input byte read once and each output byte
    written once.
"""

from __future__ import annotations

import math

import torch


def count_flops(fn, *args) -> int:
    """``fn(*args)`` once on tensors of the arguments' shapes on the meta
    device (no data, no card: shapes only) under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = [torch.empty_like(a, device="meta").requires_grad_(a.requires_grad)
            if isinstance(a, torch.Tensor) else a for a in args]
    with FlopCounterMode(display=False) as counter:
        fn(*meta)
    return int(counter.get_total_flops())


def model_flops_per_image(cfg, in_channels: int = 3) -> int:
    """Analytic forward FLOPs an image of the denoiser: 2 a multiply-add; a
    k×k conv at output S² costs S²·k²·cin·cout, a stride-2 transposed conv
    in-spatial²·k²·cin·cout; concat skips, the dense head."""

    def block(spatial, cin, filters, depth):
        m, c = 0, cin
        for _ in range(depth):
            m += spatial * spatial * 9 * c * filters
            c = filters
        return m, c

    def filt(i):
        return min(cfg.pixel_size * 2**i, cfg.max_size)

    macs, c = 0, in_channels
    m, c = block(cfg.size, c, cfg.pixel_size, cfg.block_depth)
    macs += m
    skip = []
    for i in range(cfg.octaves):
        f = filt(i)
        skip.append(c)
        s_half = cfg.size >> (i + 1)
        macs += s_half * s_half * 16 * c * f
        m, c = block(s_half, f, f, cfg.block_depth)
        macs += m
    m, c = block(cfg.size >> cfg.octaves, c, min(cfg.pixel_size * 2**cfg.octaves, cfg.max_size),
                 cfg.block_depth)
    macs += m
    for i in reversed(range(cfg.octaves)):
        s_half = cfg.size >> (i + 1)
        m, c = block(s_half, c, filt(i), cfg.block_depth)
        macs += m
        u = min(cfg.pixel_size * 2**i // 2, cfg.max_size)
        macs += s_half * s_half * 16 * c * u
        c = u + skip[i]
    m, c = block(cfg.size, c, cfg.pixel_size, cfg.block_depth)
    macs += m
    macs += cfg.size * cfg.size * c * 3
    return 2 * macs


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def down_conv(x_shape, k_shape, dtype: str):
    """A 4×4/s2 conv + bias (+ ReLU): x (B, C, H, W) NCHW as the reference
    records it, kernel (4, 4, C, O). Operations 2·B·(H/2)·(W/2)·16·C·O;
    bytes: x, the kernel and the bias read in the compute dtype, y written."""
    b, c, h, w = x_shape
    o = k_shape[3]
    e = DTYPE_BYTES[dtype]
    ops = 2 * b * (h // 2) * (w // 2) * 16 * c * o
    nbytes = e * (b * c * h * w + 16 * c * o + o + b * o * (h // 2) * (w // 2))
    return ops, nbytes


def instance_norm(x_shape, dtype: str):
    """x (B, C, H, W): x read and y written in the compute dtype, γ and β in
    float32; about 8 operations an element (two sums, the centring, the
    scale and shift)."""
    n = math.prod(x_shape)
    c = x_shape[1]
    return 8 * n, DTYPE_BYTES[dtype] * 2 * n + 4 * 2 * c


def adam(numel: int, param_bytes: int = 4, moment_bytes: int = 4):
    """One Adam update of ``numel`` float32 parameters: parameter, gradient
    and both moments read, parameter and moments written; about 12
    operations an element."""
    per = 2 * param_bytes + 4 + 4 * moment_bytes
    return 12 * numel, per * numel


def least_seconds(ops, nbytes, flops_peak, bytes_peak):
    """The least time the card could take: the larger of ops/peak and
    bytes/bandwidth."""
    return max(ops / flops_peak, nbytes / bytes_peak)
