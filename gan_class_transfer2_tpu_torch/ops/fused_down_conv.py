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
    or raises;
  * ``plan`` — the kernel's tiles and split of K, from the shape alone;
  * ``gct2::down_conv_k4s2`` — the forward as a ``torch.library`` custom op,
    so that ``torch.export`` (utils/bundle.py) holds the kernel by name: its
    implementation is ``_forward`` (the kernel on a CUDA tensor, the plain
    version on a CPU one), its fake implementation gives the output's shape
    over a symbolic batch. Eager calls go to ``_forward`` directly (a Python
    custom op adds dispatcher time to every call, PERF.md); the op is taken
    while ``torch.compiler.is_exporting()``, and for a fake tensor (shapes
    only, ``utils/profiler.compiled_stats``), which the flop counter counts
    by the formula registered for the op (the launch wrapper never sees a
    fake tensor).

The backward follows pallas_conv.py:149-165, where it is XLA convs outside
any Pallas kernel; here they are cuDNN's (``torch.nn.grad``) on the card:
the ReLU mask from the saved output and ``db`` the float32 sum over (B, H,
W), both the conv epilogue's backward (ops/conv_epilogue.py, one kernel),
``dx`` the adjoint of the strided conv, ``dK`` its weight gradient, both
with the TF-SAME pad (1, 1) of even inputs. Only the gradients autograd
asks for are computed (the GAN's G step holds D's weights constant), and
the backward is built of differentiable ops, so R1's double backward
through a discriminator differentiates it again.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from . import _build, conv_epilogue


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


def down_conv_plain(x, kernel, bias, relu: bool = True):
    """The kernel's GEMM in torch ops: each output pixel's 4×4 window of the
    SAME-padded x, rows ordered (di, dj, c) as the HWIO kernel's, times the
    kernel read as a (16·C, O) matrix, + bias → relu. Operands cast to
    ``x.dtype`` (as the kernel sees them), computed in float32 for a 16-bit
    ``x`` (as the kernel sums) and in ``x.dtype`` otherwise; returned NHWC in
    ``x.dtype``. One matmul of K = 16·C, not ``F.conv2d``: the CPU's oneDNN
    convolution sums those products in an order that loses about four times
    the precision (1.5e-5 against 4e-6 of a float64 result at C = 128)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, h, w, c = x.shape
    o = kernel.shape[3]
    win = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1)).unfold(1, 4, 2).unfold(2, 4, 2)
    a = win.permute(0, 1, 2, 4, 5, 3).reshape(b * (h // 2) * (w // 2), 16 * c)
    y = a @ kernel.to(x.dtype).to(acc).reshape(16 * c, o) + bias.to(x.dtype).to(acc)
    if relu:
        y = torch.relu(y)
    return y.view(b, h // 2, w // 2, o).to(x.dtype)


_ENTRY = {torch.float32: "gct2_down_conv_f32", torch.bfloat16: "gct2_down_conv_bf16",
          torch.float16: "gct2_down_conv_f16"}
_FNS: dict = {}
_TILE = 128  # output rows (pixels) and columns (channels) of one block's tile
K_SLICE = {torch.float32: 8, torch.bfloat16: 64, torch.float16: 64}  # depth of one K slice
# blocks a call should put on the card: 7/8 of one full wave, RESIDENT blocks
# on each SM (the float32 kernel's 256 threads and 32 KB twice, the 16-bit
# kernels' 129 KB ring once). 7/8, not all: a 128-tile layer (64²×256→512 at
# batch 4) runs faster unsplit on 132 SMs than split in two, whose workspace
# and second launch cost more than the 4 idle SMs (PERF.md, Findings)
RESIDENT = {torch.float32: 2, torch.bfloat16: 1, torch.float16: 1}
FILL_TARGET = {dt: -(-7 * n * _build.SM_COUNT // 8) for dt, n in RESIDENT.items()}


class Plan(NamedTuple):
    """How the kernel cuts one call, from the shape alone.

    ``box``: 16-bit tiles (bfloat16, float16) are boxes of (TW, TH, TB)
    output pixels along (W/2, H/2, B), TW·TH·TB = 128, the box the TMA map
    loads; float32 tiles are 128 consecutive output pixels, ``box`` (0, 0,
    0). ``split``: K ranges
    per tile, each ``k_slices // split`` whole slices; ``ws_elems`` the float32
    workspace (split, M, Opad) that holds their partial sums (0 for split 1).
    """

    tiles_m: int
    tiles_n: int
    split: int
    k_slices: int
    box: tuple
    o_pad: int
    ws_elems: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.split


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, o: int, dtype) -> Plan:
    """Tiles and split-K of the kernel for x (b, h, w, c) → o channels: the
    smallest power-of-2 split (dividing the K slices) that puts at least
    ``FILL_TARGET[dtype]`` blocks on the card."""
    h2, w2 = h // 2, w // 2
    o_pad = -(-o // _TILE) * _TILE
    if dtype != torch.float32:
        tw = min(_pow2_at_least(w2), _TILE)
        th = min(_pow2_at_least(h2), _TILE // tw)
        tb = _TILE // (tw * th)
        box = (tw, th, tb)
        tiles_m = -(-w2 // tw) * -(-h2 // th) * -(-b // tb)
    else:
        box = (0, 0, 0)
        tiles_m = -(-(b * h2 * w2) // _TILE)
    tiles_n = o_pad // _TILE
    k_slices = 16 * c // K_SLICE[dtype]
    split = 1
    while tiles_m * tiles_n * split < FILL_TARGET[dtype] and k_slices % (2 * split) == 0:
        split *= 2
    ws = split * b * h2 * w2 * o_pad if split > 1 else 0
    return Plan(tiles_m, tiles_n, split, k_slices, box, o_pad, ws)


def _entry(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = _FNS[dtype] = getattr(_build.load("down_conv"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _forward(x, kernel, bias, relu: bool):
    """The forward: the plain version for a CPU tensor, the kernel on the
    current stream for a CUDA tensor (or an exception)."""
    dev = x.device
    if dev.type == "cpu":
        return down_conv_plain(x, kernel, bias, relu)
    if dev.type != "cuda":
        raise ValueError(f"down_conv_fused: no kernel for device {dev}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"down_conv_fused: float32, bfloat16 or float16 only, got {x.dtype}")
    if kernel.device != dev or bias.device != dev:
        raise ValueError("down_conv_fused: x, kernel and bias must share a device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("down_conv_fused: x must be contiguous NHWC, 16-byte aligned")
    x_shape, k_shape = tuple(x.shape), tuple(kernel.shape)
    if not supported(x_shape, k_shape) or tuple(bias.shape) != (k_shape[3],):
        raise ValueError(
            f"down_conv_fused: unsupported shapes x{x_shape} kernel{k_shape} "
            f"bias{tuple(bias.shape)}"
        )
    b, h, w, c = x_shape
    o = k_shape[3]
    p = plan(b, h, w, c, o, x.dtype)
    # HWIO is already the (16·C, O) GEMM operand, rows ordered (di, dj, c);
    # the weight and bias are cast to x.dtype (as the Pallas wrapper does, a
    # no-op for the models, which cast them first) and zero-padded to whole
    # 128-wide N tiles where O is not one
    w2 = kernel.to(x.dtype).reshape(16 * c, o)
    b2 = bias.to(x.dtype)
    if p.o_pad != o:
        w2 = F.pad(w2, (0, p.o_pad - o))
        b2 = F.pad(b2, (0, p.o_pad - o))
    if not w2.is_contiguous():
        w2 = w2.contiguous()
    if not b2.is_contiguous():
        b2 = b2.contiguous()
    y = torch.empty((b, h // 2, w // 2, o), dtype=x.dtype, device=dev)
    ws = torch.empty(p.ws_elems, dtype=torch.float32, device=dev) if p.ws_elems else None
    args = (x.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, b, h, w, c, o, p.o_pad, int(relu),
            p.split, *p.box)
    _build.launch(_entry(x.dtype), args, dev.index, "down_conv")
    _build.count(down_conv_fused)
    return y


@torch.library.custom_op("gct2::down_conv_k4s2", mutates_args=())
def down_conv_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 relu: bool) -> torch.Tensor:
    """B4's forward by name: the kernel on a CUDA tensor, the plain version
    on a CPU one, an exception elsewhere."""
    return _forward(x, kernel, bias, relu)


@down_conv_op.register_fake
def _(x, kernel, bias, relu):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // 2, w // 2, kernel.shape[3]))


@register_flop_formula(torch.ops.gct2.down_conv_k4s2)
def _down_conv_flops(x_shape, kernel_shape, bias_shape, relu, out_shape=None, **kwargs) -> int:
    """2 per multiply-add: B·(H/2)·(W/2)·16·C·O."""
    b, h, w, c = x_shape
    return 2 * b * (h // 2) * (w // 2) * 16 * c * kernel_shape[3]


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
        # ReLU's mask and db: the conv epilogue's backward (one kernel)
        g, db = conv_epilogue.epilogue_backward(g, y if ctx.relu else None, need_x or need_k,
                                                need_b, bias.dtype)
        dx = dk = None
        if not (need_x or need_k):
            return dx, dk, db, None
        gn = g.permute(0, 3, 1, 2)  # NCHW views of the NHWC memory
        xn = x.permute(0, 3, 1, 2)
        w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        if need_x:
            dx = torch.nn.grad.conv2d_input(xn.shape, w, gn, stride=2, padding=1)
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if need_k:
            dk = torch.nn.grad.conv2d_weight(xn, w.shape, gn, stride=2, padding=1)
            dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)
        return dx, dk, db, None


def down_conv_fused(x, kernel, bias, relu: bool = True):
    """relu(conv_k4s2_SAME(x, kernel) + bias): x (B,H,W,C) NHWC, kernel
    (4,4,C,O) HWIO, bias (O,), differentiable in all three. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream or raises. Under ``torch.export`` (inference) and for a
    fake tensor (shapes only, ``utils/profiler.compiled_stats``; forward
    only) the forward is the custom op ``gct2::down_conv_k4s2``."""
    if torch.compiler.is_exporting() or isinstance(x, FakeTensor):
        return down_conv_op(x, kernel, bias, relu)
    return DownConv.apply(x, kernel, bias, relu)


down_conv_fused.launches = 0
