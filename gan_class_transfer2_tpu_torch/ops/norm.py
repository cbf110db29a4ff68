"""Instance norm (B3) and batch norm — counterpart of
gan_class_transfer2_tpu/ops/norm.py.

The reference model has no normalization; the GAN-mode models do
(``g_norm``/``d_norm``). Pieces, as for every kernel of the port:

  * ``instance_norm`` — the op: ``InstanceNorm``, an ``autograd.Function``
    whose forward is ``instance_norm_fused``, the wrapper of the hand-written
    CUDA kernel in csrc/instance_norm.cu (launch counter
    ``instance_norm_fused.launches``), and whose backward is ``_in_bwd``
    (norm.py:109-119, plain jnp there, so torch ops here);
  * ``instance_norm_plain`` — ``_instance_norm_ref`` (norm.py:32-45): two-pass
    float32 statistics, ``rsqrt(v + 1e-5)``, with γ and β first rounded to
    x's dtype as the Pallas wrapper rounds them (norm.py:76). The wrapper
    takes it only for a tensor on the CPU; a CUDA tensor launches the kernel
    or raises;
  * ``plan`` — the kernel's split of H·W across a thread-block cluster,
    from the shape alone;
  * ``gct2::instance_norm`` — the forward as a ``torch.library`` custom op,
    so that ``torch.export`` (utils/bundle.py) holds the kernel by name
    (``instance_norm_fused`` on any device, a fake implementation of x's
    shape); eager calls go to ``instance_norm_fused`` directly, the op is
    taken while ``torch.compiler.is_exporting()``, as for B4.

The JAX package sends a norm to its Pallas kernel only on a TPU, for
``C % 128 == 0`` and a per-sample block of at most 6 MB (``_use_pallas``,
norm.py:80-86): the (8, 128) lane tiling and the VMEM budget of a TPU core.
Neither binds on Hopper, so there is no such gate here: the kernel takes
every NHWC shape, the GAN path's 256²×64 up-norm included, which the TPU
sent to XLA.

The backward recomputes the statistics from the saved input with
differentiable torch ops, never from values the forward made under no-grad:
R1's double backward through a normalised discriminator (train/gan.py
``r1_penalty``) differentiates this backward once more and needs the
∂(m, r)/∂x terms, which JAX gets because its residuals are traced functions
of x (norm.py:103-106).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import nn

from . import _build

_EPS = 1e-5


def _stats(x):
    """(mean, rstd) over (H, W) per (B, C), float32 (norm.py:32-38)."""
    xf = x.float()
    m = xf.mean(dim=(1, 2), keepdim=True)
    v = torch.square(xf - m).mean(dim=(1, 2), keepdim=True)
    return m, torch.rsqrt(v + _EPS)


def instance_norm_plain(x, gamma, beta):
    """The kernel's function in plain PyTorch: x (B, H, W, C), gamma/beta
    (C,); returns x's dtype."""
    m, r = _stats(x)
    g = gamma.to(x.dtype).float()
    b = beta.to(x.dtype).float()
    return ((x.float() - m) * r * g + b).to(x.dtype)


_ENTRY = {torch.float32: "gct2_instance_norm_f32", torch.bfloat16: "gct2_instance_norm_bf16"}
_FNS: dict = {}
SM_COUNT = 132  # H100 SXM
CLUSTER_MAX = 8  # portable thread-block cluster size
CHANNELS = 32  # channels per cluster
# blocks a norm should put on the card: 7/8 of one per SM. Larger clusters
# that reach 132 or 256 blocks measured slower on the two big maps (PERF.md,
# Findings)
FILL_TARGET = -(-7 * SM_COUNT // 8)


class NormPlan(NamedTuple):
    """How the kernel cuts one norm: ``cluster`` blocks split H·W into
    chunks of ``chunk`` pixels (the last ones may be short or empty);
    ``blocks``: the grid's size."""

    cluster: int
    chunk: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int) -> NormPlan:
    """The smallest cluster (a power of 2, at most ``CLUSTER_MAX``) that puts
    at least ``FILL_TARGET`` blocks on the card."""
    base = -(-c // CHANNELS) * b  # one cluster per (sample, 32-channel group)
    s = 1
    while base * s < FILL_TARGET and s < CLUSTER_MAX:
        s *= 2
    return NormPlan(s, -(-(h * w) // s), base * s)


def _entry(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = _FNS[dtype] = getattr(_build.load("instance_norm"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _f32(t):
    """A float32 contiguous tensor of ``t``'s values, ``t`` itself if it is one."""
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


def instance_norm_fused(x, gamma, beta):
    """Forward of B3: the plain version for a CPU tensor, the kernel on the
    current stream for a CUDA tensor (or an exception). x (B, H, W, C)
    contiguous, float32 or bfloat16; gamma/beta (C,) on x's device."""
    dev = x.device
    if dev.type == "cpu":
        return instance_norm_plain(x, gamma, beta)
    if dev.type != "cuda":
        raise ValueError(f"instance_norm_fused: no kernel for device {dev}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"instance_norm_fused: float32 or bfloat16 only, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"instance_norm_fused: x must be contiguous NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"instance_norm_fused: gamma/beta must be ({c},)")
    if gamma.device != dev or beta.device != dev:
        raise ValueError("instance_norm_fused: x, gamma and beta must share a device")
    if b > 65535:
        raise ValueError(f"instance_norm_fused: batch {b} exceeds the grid's 65535")
    p = plan(b, h, w, c)
    # γ and β go over as float32 (no copy for the float32 parameters); the
    # kernel rounds them to x's dtype, as the Pallas wrapper does (norm.py:76)
    g, bt = _f32(gamma), _f32(beta)
    y = torch.empty_like(x)
    args = (x.data_ptr(), g.data_ptr(), bt.data_ptr(), y.data_ptr(), b, h * w, c, p.cluster)
    fn = _entry(x.dtype)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, _build.current_stream(dev.index))
    else:
        with torch.cuda.device(dev):  # the launch goes to the current device
            err = fn(*args, _build.current_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: CUDA error {err}")
    instance_norm_fused.launches += 1
    return y


instance_norm_fused.launches = 0


def _in_bwd(x, gamma, dy):
    """norm.py:109-119 with (m, r) recomputed from x by differentiable ops."""
    m, r = _stats(x)
    dy = dy.float()
    xhat = (x.float() - m) * r
    dgamma = torch.sum(dy * xhat, dim=(0, 1, 2)).to(gamma.dtype)
    dbeta = torch.sum(dy, dim=(0, 1, 2)).to(gamma.dtype)
    g = dy * gamma.float()
    mean_g = g.mean(dim=(1, 2), keepdim=True)
    mean_gx = (g * xhat).mean(dim=(1, 2), keepdim=True)
    dx = r * (g - mean_g - xhat * mean_gx)
    return dx.to(x.dtype), dgamma, dbeta


@torch.library.custom_op("gct2::instance_norm", mutates_args=())
def instance_norm_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """B3's forward by name: the kernel on a CUDA tensor, the plain version
    on a CPU one, an exception elsewhere."""
    return instance_norm_fused(x, gamma, beta)


@instance_norm_op.register_fake
def _(x, gamma, beta):
    return torch.empty_like(x)


class InstanceNorm(torch.autograd.Function):
    """B3 with the custom VJP of norm.py:95-122. Its backward is made of
    torch ops on the saved inputs, so it is differentiable again."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        ctx.save_for_backward(x, gamma)
        return instance_norm_fused(x, gamma, beta)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        return _in_bwd(x, gamma, dy)


def instance_norm(x, gamma, beta):
    """Per-(sample, channel) normalization over (H, W) with affine γ/β.
    x: (B, H, W, C); gamma/beta: (C,). Under ``torch.export`` (inference)
    the forward is the custom op ``gct2::instance_norm``."""
    if torch.compiler.is_exporting():
        return instance_norm_op(x.contiguous(), gamma, beta)
    return InstanceNorm.apply(x.contiguous(), gamma, beta)


def batch_norm(x, gamma, beta, eps: float = _EPS):
    """Training-mode batch norm: stats over (B, H, W) per channel
    (norm.py:125-133)."""
    xf = x.float()
    m = xf.mean(dim=(0, 1, 2), keepdim=True)
    v = torch.square(xf - m).mean(dim=(0, 1, 2), keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


class Norm(nn.Module):
    """A norm layer's ``gamma`` (ones) and ``beta`` (zeros), float32."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    @torch.no_grad()
    def reset_parameters(self):
        self.gamma.fill_(1.0)
        self.beta.zero_()
        return self


def init_norm(c: int) -> Norm:
    return Norm(c)


def apply_norm(kind: str, x, params):
    """Dispatch helper for model code. kind: none|instance|batch; ``params``
    has ``gamma`` and ``beta``."""
    if kind == "none" or kind is None:
        return x
    if kind == "instance":
        return instance_norm(x, params.gamma, params.beta)
    if kind == "batch":
        return batch_norm(x, params.gamma, params.beta)
    raise ValueError(f"unknown norm {kind!r}")
