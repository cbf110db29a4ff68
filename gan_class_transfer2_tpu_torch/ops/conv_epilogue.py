"""The conv epilogue: ``act(other + (y + bias))`` after a TF-SAME conv, one
hand-written CUDA pass each way (csrc/conv_epilogue.cu).

The JAX package has no kernel here: XLA fuses a conv's bias, its ReLU and
the sum of a concat pair's two convs (models/unet.py ``_pair_up_conv``,
``_pair_block_conv``) into the conv. On the card cuDNN's convs end at the
conv, and the tail ran as ATen passes over the output: a broadcast bias add,
the pair's sum, the ReLU; backward, ReLU's mask and the bias gradient's
reduction. Pieces, as for every kernel of the port:

  * ``conv_epilogue`` — the op: ``ConvEpilogue``, an ``autograd.Function``
    whose forward is ``epilogue_fused`` (launch counter
    ``conv_epilogue.launches``, one launch a forward) and whose backward is
    ``epilogue_backward``: one launch for ``gs = g·[out > 0]``, one more
    for the bias gradient (per-block float32 partial sums, added in a fixed
    order, rounded once to the bias's dtype, so runs repeat bit for bit);
  * ``epilogue_plain`` — the torch-op composition the convs ran before
    (``y + bias``, ``other + ·``, ``relu``), and ``_backward_plain``, its
    gradients as autograd forms them. The wrappers take them only for a
    tensor on the CPU; a CUDA tensor launches the kernel or raises (a
    dtype but float32, bfloat16 and float16: TypeError);
  * ``plan`` — the launch's vector width, block shape and grid, from the
    shape alone.

The kernel sums in float32 and rounds once to the compute dtype, where the
composition rounds after each op: float32 agrees bit for bit, bfloat16
and float16 within one rounding. Each call adapts to what it is given —
one branch or two, a bias or none, ReLU or not, the dtype, and whether
autograd records the backward: a ``create_graph=True`` backward (R1's
double backward through a discriminator) takes the differentiable torch
ops, counted by ``ConvEpilogue.graph_backwards``. B4's backward
(ops/fused_down_conv.py) is this epilogue's backward and calls
``epilogue_backward`` too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build

_ENTRY = {kind: {dt: f"gct2_epilogue_{kind}_{name}" for dt, name in
                 ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.float16, "f16"))}
          for kind in ("fwd", "bwd")}
_ARGS = {
    "fwd": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_FNS: dict = {}
BLOCKS_PER_SM = 8  # 256-thread blocks: 2048 threads, an SM's most
_THREADS, _UNROLL = 256, 4  # as csrc/conv_epilogue.cu


class Plan(NamedTuple):
    """One launch: ``vec`` elements a thread's load (16 bytes, or 1 where C
    or an address does not allow it), ``tx`` lanes along the C / vec channel
    vectors by 256 / tx pixel rows a block, ``grid_x`` blocks along the
    pixels (each walks them in strides); the kernel puts ⌈C / vec / tx⌉
    blocks along the channels."""

    vec: int
    tx: int
    grid_x: int


@functools.lru_cache(maxsize=None)
def plan(pixels: int, c: int, itemsize: int, aligned: bool) -> Plan:
    """The launch over ``pixels`` rows of ``c`` channels of ``itemsize``
    bytes, from the shape alone and whether every operand is 16-byte
    aligned."""
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    cv = c // vec
    tx = min(1 << max(0, (cv - 1).bit_length()), 32)
    grid_y = -(-cv // tx)
    rows = _THREADS // tx
    fill = -(-_build.SM_COUNT * BLOCKS_PER_SM // grid_y)
    grid_x = max(1, min(-(-pixels // (rows * _UNROLL)), fill))
    return Plan(vec, tx, grid_x)


def epilogue_plain(y, bias=None, relu: bool = False, other=None):
    """``act(other + (y + bias))`` as the convs composed it in torch ops,
    in ``y``'s dtype; ``other`` and ``bias`` may be None."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if other is not None:
        y = other + y
    if relu:
        y = torch.relu(y)
    return y


def _backward_plain(g, out, need_g: bool, need_bias: bool, bias_dtype):
    """``(gs, db)`` in torch ops, as autograd forms them through
    ``epilogue_plain``: ReLU's ``threshold_backward`` on the saved output
    (``out`` None without ReLU), the bias gradient summed over every axis
    but the last (float32 for a 16-bit ``g``) and cast to the bias's dtype."""
    gs = g if out is None else torch.ops.aten.threshold_backward(g, out, 0)
    db = None
    if need_bias:
        acc = torch.promote_types(gs.dtype, torch.float32)
        db = gs.sum(tuple(range(gs.dim() - 1)), dtype=acc).to(bias_dtype)
    return (gs if need_g else None), db


def _entry(kind, dtype):
    key = (kind, dtype)
    fn = _FNS.get(key)
    if fn is None:
        if dtype not in _ENTRY[kind]:
            raise TypeError(f"conv_epilogue: float32, bfloat16 or float16 only, got {dtype}")
        fn = _FNS[key] = getattr(_build.load("conv_epilogue"), _ENTRY[kind][dtype])
        fn.argtypes = _ARGS[kind]
        fn.restype = ctypes.c_int
    return fn


def _refuse(who, t, like, what):
    """The error for an operand the kernel does not take: ``t`` must be a
    non-empty contiguous CUDA tensor of ``like``'s shape, dtype and device."""
    if t.device.type != "cuda":
        return ValueError(f"{who}: no kernel for device {t.device}")
    return ValueError(f"{who}: {what} must be contiguous (channels last), non-empty and match "
                      f"{tuple(like.shape)} {like.dtype} on {like.device}, got "
                      f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _takes(t, like) -> bool:
    return (t.is_cuda and t.is_contiguous() and t.shape == like.shape and t.dtype == like.dtype
            and t.get_device() == like.get_device() and t.dim() > 0 and t.numel() > 0)


def epilogue_fused(y, bias=None, relu: bool = False, other=None):
    """The forward: ``epilogue_plain`` for a CPU tensor, one launch on the
    current stream for a CUDA tensor (or an exception). ``y`` contiguous,
    channels last, float32, bfloat16 or float16; ``other`` the same shape,
    dtype and layout, or None; ``bias`` (C,) on ``y``'s device (cast to its
    dtype), or None. The checks are few and cheap: a sampler call makes eight."""
    if y.device.type == "cpu":
        return epilogue_plain(y, bias, relu, other)
    if not _takes(y, y):
        raise _refuse("epilogue_fused", y, y, "y")
    fn = _entry("fwd", y.dtype)
    if other is not None and not _takes(other, y):
        raise _refuse("epilogue_fused", other, y, "other")
    c = y.shape[-1]
    if bias is not None:
        if bias.shape != (c,) or bias.get_device() != y.get_device():
            raise ValueError(f"epilogue_fused: bias must be ({c},) on {y.device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        if bias.dtype != y.dtype:
            bias = bias.to(y.dtype)
        bias = bias.contiguous()
    out = torch.empty_like(y)
    ptrs = (y.data_ptr(), 0 if other is None else other.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr())
    pixels = y.numel() // c
    p = plan(pixels, c, y.element_size(), (ptrs[0] | ptrs[1] | ptrs[3]) % 16 == 0)
    _build.launch(fn, (*ptrs, pixels, c, p.vec, p.tx, p.grid_x, int(relu)), y.get_device(),
                  "conv_epilogue forward")
    _build.count(conv_epilogue)
    return out


def _backward_fused(g, out, need_g: bool, need_bias: bool, bias_dtype):
    """``(gs, db)`` by the kernel: one launch for gs (none without ReLU,
    where gs is ``g`` itself), one more for db, summed in float32 and
    written in ``bias_dtype`` where that is ``g``'s dtype, else in float32
    (cast to ``bias_dtype`` where that is neither)."""
    if not need_bias and (out is None or not need_g):
        return (g if need_g else None), None
    g = g.contiguous()
    if not _takes(g, g):
        raise _refuse("epilogue_backward", g, g, "g")
    fn = _entry("bwd", g.dtype)
    if out is not None and not _takes(out, g):
        raise _refuse("epilogue_backward", out, g, "the saved output")
    c = g.shape[-1]
    pixels = g.numel() // c
    gs = torch.empty_like(g) if out is not None and need_g else None
    ptrs = [0 if t is None else t.data_ptr() for t in (g, out, gs)]
    p = plan(pixels, c, g.element_size(), (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    parts = db = None
    if need_bias:
        parts = torch.empty(p.grid_x * c, dtype=torch.float32, device=g.device)
        db = torch.empty(c, dtype=g.dtype if bias_dtype == g.dtype else torch.float32,
                         device=g.device)
        ptrs += [parts.data_ptr(), db.data_ptr()]
    else:
        ptrs += [0, 0]
    _build.launch(fn, (*ptrs, pixels, c, p.vec, p.tx, p.grid_x,
                       int(db is not None and db.dtype == torch.float32)), g.get_device(),
                  "conv_epilogue backward")
    _build.count(conv_epilogue)
    if need_bias:
        _build.count(conv_epilogue)
        db = db.to(bias_dtype)
    if out is None:
        gs = g
    return (gs if need_g else None), db


def epilogue_backward(g, out, need_g: bool, need_bias: bool, bias_dtype=None):
    """The epilogue's backward ``(gs, db)``: ``gs = g·[out > 0]`` (``out``
    the saved output, None without ReLU: then ``gs`` is ``g``), and ``db``,
    the sum of ``gs`` over every axis but the last in ``bias_dtype``; each
    None where it is not needed. The torch ops where autograd records the
    backward (counted by ``ConvEpilogue.graph_backwards``) and for a CPU
    tensor, else the kernel."""
    if torch.is_grad_enabled():
        _build.count(ConvEpilogue, "graph_backwards")
        return _backward_plain(g, out, need_g, need_bias, bias_dtype)
    if g.device.type == "cpu":
        return _backward_plain(g, out, need_g, need_bias, bias_dtype)
    return _backward_fused(g, out, need_g, need_bias, bias_dtype)


class ConvEpilogue(torch.autograd.Function):
    """``act(other + (y + bias))`` with ``epilogue_backward`` as its
    backward; ``graph_backwards`` counts the backwards autograd recorded
    (``create_graph=True``), which take the torch ops on any device."""

    graph_backwards = 0

    @staticmethod
    def forward(ctx, y, bias, relu, other):
        out = epilogue_fused(y, bias, relu, other)
        ctx.relu = relu
        ctx.bias_dtype = None if bias is None else bias.dtype
        if relu:
            ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        need_y, need_bias, _, need_other = ctx.needs_input_grad
        out = ctx.saved_tensors[0] if ctx.relu else None
        gs, db = epilogue_backward(g, out, need_y or need_other, need_bias, ctx.bias_dtype)
        return (gs if need_y else None), db, None, (gs if need_other else None)


def conv_epilogue(y, bias=None, relu: bool = False, other=None):
    """``act(other + (y + bias))`` over a conv's NHWC output ``y``: ``other``
    a second conv output of ``y``'s shape (the pair of a concat's two
    halves) or None, ``bias`` (C,) or None, ``relu`` the activation.
    Differentiable in ``y``, ``bias`` and ``other``. Returns ``y`` itself
    when there is nothing to add or activate. A CUDA tensor takes the
    kernel (its operands made contiguous first), and raises TypeError
    unless it is float32, bfloat16 or float16; a CPU tensor takes the torch
    ops, and so does the forward under ``torch.export`` and for a fake or
    meta tensor (shapes only). Without a gradient to record (the sampler) the
    forward is called directly, not through the autograd Function."""
    if bias is None and other is None and not relu:
        return y
    if y.is_meta or isinstance(y, FakeTensor) or torch.compiler.is_exporting():
        return epilogue_plain(y, bias, relu, other)
    if y.is_cuda:
        y = y.contiguous()
        other = None if other is None else other.contiguous()
    if torch.is_grad_enabled() and (y.requires_grad or (bias is not None and bias.requires_grad)
                                    or (other is not None and other.requires_grad)):
        return ConvEpilogue.apply(y, bias, relu, other)
    return epilogue_fused(y, bias, relu, other)


conv_epilogue.launches = 0
