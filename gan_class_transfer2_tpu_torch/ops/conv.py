"""Convolution primitives — counterpart of gan_class_transfer2_tpu/ops/conv.py.

NHWC activations and HWIO kernels at every public function, as in the JAX
package; inside, each op views its operands as NCHW / OIHW for
``torch.nn.functional``. Transposed-conv kernels are stored HWIO in dataflow
orientation (I = the op's input channels), as in the JAX package.

One route to the hand-written kernels, chosen by the tensor alone: every
TF-SAME conv's bias, concat-pair sum and ReLU is the conv epilogue
(ops/conv_epilogue.py), and every k4/s2 down conv with a bias whose shape
``fused_down_conv.supported`` admits is B4 (ops/fused_down_conv.py), the
JAX package's shape gate; other shapes take the plain conv. Each kernel's
wrapper picks the plain version for a CPU tensor, the torch ops under
``torch.export`` and for fake or meta tensors, and the kernel for a CUDA
tensor: float32, bfloat16 or float16, the model's compute dtypes (another
dtype raises TypeError, as the wrappers do).

The published CycleGAN's layers (models/resnet.py, the 70×70 PatchGAN of
models/discriminator.py) pad explicitly and symmetrically, with zeros or
mirrored rows: ``conv2d_padded``, ``reflect_pad`` and
``conv2d_transpose_padded``. TF-SAME would pad their k3/s2 convs (0, 1) and
cannot express a k4/s1 conv of pad 1 or a transposed conv's output pad.

Float32 compute is IEEE float32, as the JAX package's ``Precision.HIGHEST``;
models/unet.py turns cuDNN's TF32 off around a float32 forward.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import fused_down_conv
from .conv_epilogue import conv_epilogue, epilogue_plain


def same_pads(in_size: int, k: int, s: int):
    """TF 'SAME' padding (lo, hi) for a strided conv."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    lo = total // 2
    return lo, total - lo


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _conv_strided_raw(x, kernel, stride: int):
    """Plain TF-SAME strided conv (no bias/act), NHWC/HWIO. Odd inputs get
    asymmetric pads such as (1, 2), which ``F.conv2d``'s symmetric
    ``padding=`` cannot express, so those go through an explicit ``F.pad``."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    xn = _nchw(x)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _nhwc(F.conv2d(xn, w, stride=stride, padding=(ph[0], pw[0])))
    xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
    return _nhwc(F.conv2d(xn, w, stride=stride))


def _kernels_take(t) -> bool:
    """Whether B4 and the conv epilogue take ``t``: every tensor but a meta
    one (shapes only), which takes the torch ops."""
    return not t.is_meta


def _tail(y, bias, relu: bool, other):
    """A TF-SAME conv's tail ``act(other + (y + bias))``."""
    if _kernels_take(y):
        return conv_epilogue(y, bias, relu, other)
    return epilogue_plain(y, bias, relu, other)


def conv2d(x, kernel, bias=None, stride: int = 1, relu: bool = False, other=None):
    """TF-SAME conv. kernel HWIO. ``other``, a tensor of the output's shape
    (the other half of a concat's pair, models/unet.py), is added before the
    ReLU in the same epilogue."""
    return _tail(_conv_strided_raw(x, kernel, stride), bias, relu, other)


def _convt_raw(x, kernel, stride: int):
    """TF Conv2DTranspose 'SAME' (the exact adjoint of the SAME strided conv
    with the io-swapped kernel). ``F.conv_transpose2d`` takes (in, out, kh, kw)
    weights and flips them itself, so the HWIO dataflow kernel maps straight
    onto it; asymmetric SAME pads are cut from the full output."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    out_h, out_w = x.shape[1] * stride, x.shape[2] * stride
    ph = same_pads(out_h, kh, stride)
    pw = same_pads(out_w, kw, stride)
    if kh < stride or kw < stride:
        raise ValueError(f"transposed conv needs kernel >= stride, got {kh}x{kw}/{stride}")
    w = kernel.to(x.dtype).permute(2, 3, 0, 1)
    xn = _nchw(x)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv_transpose2d(xn, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv_transpose2d(xn, w, stride=stride)
        y = y[:, :, ph[0] : ph[0] + out_h, pw[0] : pw[0] + out_w]
    return _nhwc(y)


def conv2d_transpose(x, kernel, bias=None, stride: int = 2, relu: bool = False, other=None):
    """TF Conv2DTranspose 'SAME'; kernel HWIO with I = this op's input
    channels. Output spatial = input · stride; ``other`` as ``conv2d``'s."""
    return _tail(_convt_raw(x, kernel, stride), bias, relu, other)


# --------------------------------------------------------------------------
# Explicit symmetric padding (the published CycleGAN's layers)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reflect_index(h: int, w: int, p: int, device: torch.device):
    """Flat indices of ``nn.ReflectionPad2d(p)`` over an (h, w) image: for each
    padded pixel the pixel it copies (int64, (h+2p)·(w+2p)), and the padded
    pixels of the border ring with the pixels they copy (the backward's
    extra sources and their destinations)."""
    rows = torch.arange(-p, h + p).abs()
    rows = torch.where(rows > h - 1, 2 * (h - 1) - rows, rows)
    cols = torch.arange(-p, w + p).abs()
    cols = torch.where(cols > w - 1, 2 * (w - 1) - cols, cols)
    src = (rows[:, None] * w + cols[None, :]).flatten()
    ring = torch.ones(h + 2 * p, w + 2 * p, dtype=torch.bool)
    ring[p:p + h, p:p + w] = False
    ring = ring.flatten().nonzero().flatten()
    return src.to(device), ring.to(device), src[ring].to(device)


class _ReflectPad(torch.autograd.Function):
    """``nn.ReflectionPad2d(p)`` on an NHWC tensor, in place of ``F.pad(...,
    "reflect")`` on its NCHW view: that runs PyTorch's NCHW pad kernel,
    whose output and gradient each take a layout copy on the card. Here the
    forward is one gather of the padded pixels; the backward one copy of
    the interior's gradient and one ``index_add_`` of the border ring's
    onto the pixels it mirrors (atomic on the card, as
    ``reflection_pad2d_backward``'s adds are)."""

    @staticmethod
    def forward(ctx, x, p):
        b, h, w, c = x.shape
        if p >= h or p >= w:
            raise ValueError(f"reflect pad {p} needs more than {p} rows and columns, got {h}x{w}")
        ctx.p = p
        src, _, _ = _reflect_index(h, w, p, x.device)
        return x.reshape(b, h * w, c).index_select(1, src).view(b, h + 2 * p, w + 2 * p, c)

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        b, hp, wp, c = g.shape
        h, w = hp - 2 * p, wp - 2 * p
        _, ring, dst = _reflect_index(h, w, p, g.device)
        gx = g[:, p:p + h, p:p + w].contiguous()
        gx.view(b, h * w, c).index_add_(1, dst, g.reshape(b, hp * wp, c).index_select(1, ring))
        return gx, None


def reflect_pad(x, pad: int):
    """``x`` (B, H, W, C) with ``pad`` rows and columns mirrored onto each
    side, the edge not repeated (``nn.ReflectionPad2d``), NHWC-contiguous.
    ``F.pad(x, ..., "reflect")`` on the NHWC tensor itself would pad W and
    C; ``_ReflectPad`` pads H and W without a layout copy."""
    return _ReflectPad.apply(x.contiguous(), pad)


def conv2d_padded(x, kernel, bias=None, stride: int = 1, pad: int = 0, reflect: bool = False):
    """A conv with ``pad`` rows and columns on each side, zeros or mirrored
    (``reflect``), and ``bias``: ``nn.Conv2d(k, stride, padding=pad)``
    behind an optional ``nn.ReflectionPad2d(pad)``. NHWC, kernel HWIO."""
    if reflect and pad:
        x, pad = reflect_pad(x, pad), 0
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=pad))


def conv2d_transpose_padded(x, kernel, bias=None, stride: int = 2, pad: int = 1,
                            output_pad: int = 1):
    """``nn.ConvTranspose2d(k, stride, padding=pad, output_padding=output_pad)``:
    output (H − 1)·stride − 2·pad + k + output_pad, which for k3/s2 pad 1
    and output pad 1 is 2·H. NHWC; kernel HWIO in dataflow orientation (I
    = this op's input channels), as ``conv2d_transpose``'s."""
    w = kernel.to(x.dtype).permute(2, 3, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=stride, padding=pad,
                                    output_padding=output_pad))


def down_conv(x, kernel, bias, relu: bool = True):
    """DownShuffle op (reference train.py:158-169): 4×4/s2 SAME conv + ReLU;
    B4 where its gate admits the shapes."""
    if (bias is not None and _kernels_take(x)
            and fused_down_conv.supported(tuple(x.shape), tuple(kernel.shape))):
        return fused_down_conv.down_conv_fused(x.contiguous(), kernel, bias, relu)
    return conv2d(x, kernel, bias, stride=2, relu=relu)


def up_conv(x, kernel, bias, relu: bool = True, other=None):
    """UpShuffle op (reference train.py:145-156): 4×4/s2 transposed conv + ReLU."""
    return conv2d_transpose(x, kernel, bias, stride=2, relu=relu, other=other)


def dense(x, kernel, bias=None):
    return epilogue_plain(torch.matmul(x, kernel.to(x.dtype)), bias)
