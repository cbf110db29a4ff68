"""Fused k4/s2 TF-SAME down conv + bias + ReLU — counterpart of
gan_class_transfer2_tpu/ops/pallas_conv.py.

Three pieces, as for every kernel of the port:

  * ``supported`` — the JAX package's shape gate, kept identical, so both
    packages route the same convs to their kernel;
  * ``down_conv_fused`` — the op: ``DownConv``, an ``autograd.Function``
    whose forward is the wrapper of the hand-written CUDA kernel in
    csrc/down_conv.cu (``_forward``, launch counter
    ``down_conv_fused.launches``);
  * ``down_conv_plain`` — the same forward in plain PyTorch. The wrapper
    takes it only for a tensor on the CPU; a CUDA tensor launches the kernel
    or raises.

The backward follows pallas_conv.py:149-165, where it is XLA convs outside
any Pallas kernel; here they are cuDNN's (``torch.nn.grad``) on the card:
the ReLU mask from the saved output, ``db`` the float32 sum over (B, H, W),
``dx`` the adjoint of the strided conv, ``dK`` its weight gradient, both
with the TF-SAME pad (1, 1) of even inputs. Only the gradients autograd
asks for are computed (the GAN's G step holds D's weights constant), and
the backward is built of differentiable ops, so R1's double backward
through a discriminator differentiates it again.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import _build

_N_TILE = 128  # the kernel's output-channel tile; the weight is padded to it


def supported(x_shape, kernel_shape) -> bool:
    """Shapes the kernel handles (identical to the JAX package's gate)."""
    b, h, w, c = x_shape
    kh, kw, ci, o = kernel_shape
    ntile = min(o, 128 if c >= 256 else 256)
    return (
        kh == 4 and kw == 4 and ci == c
        and c % 128 == 0
        and h % 2 == 0 and w % 2 == 0
        and (h // 2) >= 8 and (w // 2) >= 8
        and o % ntile == 0
    )


@contextlib.contextmanager
def _native_cpu_conv(device):
    """The plain version is the kernel's reference. On the CPU, oneDNN's
    convolution sums the K = 16·C products in an order that loses about four
    times the precision of PyTorch's native path (1.5e-5 against 4e-6 of a
    float64 result at C = 128), so the reference takes the native path."""
    if device.type != "cpu":
        yield
        return
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def down_conv_plain(x, kernel, bias, relu: bool = True):
    """F.pad → F.conv2d(stride=2) → + bias → relu, in float32 on NCHW views
    of the operands cast to ``x.dtype`` (as the kernel sees them); returned
    NHWC in ``x.dtype``."""
    w = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
    xn = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    with _native_cpu_conv(x.device):
        y = F.conv2d(xn, w, stride=2)
    y = y + bias.to(x.dtype).float()[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


_ENTRY = {torch.float32: "gct2_down_conv_f32", torch.bfloat16: "gct2_down_conv_bf16"}


def _entry(dtype):
    lib = _build.load("down_conv")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _forward(x, kernel, bias, relu: bool):
    """The forward: the plain version for a CPU tensor, the kernel on the
    current stream for a CUDA tensor (or an exception)."""
    if x.device.type == "cpu":
        return down_conv_plain(x, kernel, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"down_conv_fused: no kernel for device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"down_conv_fused: float32 or bfloat16 only, got {x.dtype}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("down_conv_fused: x, kernel and bias must share a device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("down_conv_fused: x must be contiguous NHWC, 16-byte aligned")
    if not supported(tuple(x.shape), tuple(kernel.shape)) or tuple(bias.shape) != (
        kernel.shape[3],
    ):
        raise ValueError(
            f"down_conv_fused: unsupported shapes x{tuple(x.shape)} "
            f"kernel{tuple(kernel.shape)} bias{tuple(bias.shape)}"
        )
    b, h, w, c = x.shape
    o = kernel.shape[3]
    # HWIO is already the (16·C, O) GEMM operand, rows ordered (di, dj, c);
    # the weight and bias are cast to x.dtype on every call (as the Pallas
    # wrapper does) and zero-padded to the kernel's 128-wide N tile
    o_pad = -(-o // _N_TILE) * _N_TILE
    w2 = kernel.to(x.dtype).reshape(16 * c, o)
    b2 = bias.to(x.dtype)
    if o_pad != o:
        w2 = F.pad(w2, (0, o_pad - o))
        b2 = F.pad(b2, (0, o_pad - o))
    w2, b2 = w2.contiguous(), b2.contiguous()
    y = torch.empty((b, h // 2, w // 2, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _entry(x.dtype)(
            x.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            b, h, w, c, o, o_pad, int(relu), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"down_conv kernel launch failed: CUDA error {err}")
    down_conv_fused.launches += 1
    return y


class DownConv(torch.autograd.Function):
    """B4 with the backward of pallas_conv.py:149-165."""

    @staticmethod
    def forward(ctx, x, kernel, bias, relu):
        y = _forward(x, kernel, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, kernel, bias, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, y = ctx.saved_tensors
        need_x, need_k, need_b = ctx.needs_input_grad[:3]
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros_like(g))
        gn = g.permute(0, 3, 1, 2)  # NCHW views of the NHWC memory
        xn = x.permute(0, 3, 1, 2)
        w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        dx = dk = db = None
        if need_x:
            dx = torch.nn.grad.conv2d_input(xn.shape, w, gn, stride=2, padding=1)
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if need_k:
            dk = torch.nn.grad.conv2d_weight(xn, w.shape, gn, stride=2, padding=1)
            dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)
        if need_b:
            db = g.float().sum((0, 1, 2)).to(bias.dtype)
        return dx, dk, db, None


def down_conv_fused(x, kernel, bias, relu: bool = True):
    """relu(conv_k4s2_SAME(x, kernel) + bias): x (B,H,W,C) NHWC, kernel
    (4,4,C,O) HWIO, bias (O,), differentiable in all three. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream or raises."""
    return DownConv.apply(x, kernel, bias, relu)


down_conv_fused.launches = 0
