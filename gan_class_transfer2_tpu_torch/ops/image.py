"""Image ops of the noise-space edits — counterpart of
gan_class_transfer2_tpu/ops/image.py (reference train.py:415-430), and the
weighted DCT of the ``dct`` training loss. NHWC."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def avg_pool(x, window: int, stride: int | None = None):
    """tf.nn.avg_pool2d(..., 'SAME'): every cell divided by the number of
    real (unpadded) pixels in its window."""
    stride = stride or window
    out_h = -(-x.shape[1] // stride)
    out_w = -(-x.shape[2] // stride)
    pad_h = max((out_h - 1) * stride + window - x.shape[1], 0)
    pad_w = max((out_w - 1) * stride + window - x.shape[2], 0)
    pads = (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)

    def window_sum(t):
        t = F.pad(t.permute(0, 3, 1, 2), pads)
        return F.avg_pool2d(t, window, stride) * (window * window)

    counts = window_sum(torch.ones_like(x[..., :1]))
    return (window_sum(x) / counts).permute(0, 2, 3, 1)


def upsample_nearest(x, factor: int):
    """Keras UpSampling2D(interpolation='nearest') (reference train.py:418)."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def roll2d(x, shift_h: int = 1, shift_w: int = 1):
    """tf.roll twice (reference train.py:422)."""
    return torch.roll(x, shifts=(shift_h, shift_w), dims=(1, 2))


def vq_quantise(x, dictionary):
    """Per-pixel nearest codeword under squared L2 (reference train.py:424-430).
    x: (B, H, W, C); dictionary: (H, W, K, C); ties go to the first codeword."""
    err = ((x[..., None, :] - dictionary[None]) ** 2).sum(-1)  # (B, H, W, K)
    idx = err.argmin(-1)
    book = dictionary[None].expand(x.shape[0], *dictionary.shape)
    return torch.gather(book, 3, idx[..., None, None].expand(*idx.shape, 1, x.shape[-1]))[
        ..., 0, :
    ]


def _dct_matrix(n: int, dtype, device):
    """The orthonormal DCT-II as an (n, n) matrix D, X = D·x (scipy's
    ``dct(norm="ortho")``), built in float64 and rounded once."""
    k = torch.arange(n, dtype=torch.float64)[:, None]
    i = torch.arange(n, dtype=torch.float64)[None, :]
    d = torch.cos(math.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    d[0] /= math.sqrt(2.0)
    return d.to(dtype=dtype, device=device)


def dct2d_weighted(x):
    """Frequency-weighted 2-D DCT-II (ortho) over the spatial dims
    (reference train.py:254-260), as a product with the DCT matrix. The
    reference quirk is kept: the result comes back (B, W, H, C), spatial axes
    transposed (see the JAX copy)."""
    size_h, size_w = x.shape[1], x.shape[2]
    wh = 1.0 / torch.arange(1, size_h + 1, dtype=x.dtype, device=x.device)
    ww = 1.0 / torch.arange(1, size_w + 1, dtype=x.dtype, device=x.device)
    x = x.permute(0, 3, 1, 2)  # B C H W
    x = torch.matmul(x, _dct_matrix(size_w, x.dtype, x.device).T) * ww
    x = x.transpose(2, 3)  # B C W H
    x = torch.matmul(x, _dct_matrix(size_h, x.dtype, x.device).T) * wh
    return x.permute(0, 2, 3, 1)  # B W H C
