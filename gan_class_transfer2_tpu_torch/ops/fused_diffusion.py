"""Fused forward diffusion (B1) — counterpart of
gan_class_transfer2_tpu/ops/kernels.py (``_diffuse_kernel``,
``fused_forward_diffuse``, ``forward_diffuse_fused``).

``noised = x·ss[b] + ε·sn[b]`` with ``ε ~ N(0, 1)`` drawn inside the kernel
and never written to memory: one read of x and one write of ``noised``,
where the unfused path writes ε, reads it back and reads x.

The TPU kernel draws ε from the core's own PRNG, whose bits cannot be
reproduced elsewhere. Here ε comes from Philox4x32-10 (Salmon et al.,
SC'11), keyed by a 64-bit seed (key = (seed low word, seed high word)), at
counter ``(element // 4, sample, half, 0)``: each group of four elements of a
sample takes two Philox blocks (``half`` 0 and 1), and each pair of words
``(a, b)`` of a block gives one normal through the Box–Muller transform of
``_normal_from_bits`` (kernels.py:31-41): ``u1 = (a >> 8)·2⁻²⁴ + 2⁻²⁵``,
``u2 = (b >> 8)·2⁻²⁴``, ``ε = √(−2 ln u1)·cos(2π·u2)``. Element
``4g + 2·half + j`` takes words ``(2j, 2j + 1)`` of block ``half``.

Three pieces, as for every kernel of the port:

  * ``diffuse_fused`` — the wrapper of csrc/diffuse.cu, with its launch
    counter ``diffuse_fused.launches``, inside ``FusedDiffuse``, the
    autograd Function whose backward is ``g·ss[b]`` (kernels.py:117-120);
  * ``diffuse_plain`` — the same function in plain PyTorch: the same Philox
    written in int64 arithmetic, its 32×32-bit products split into 16-bit
    halves so that nothing overflows. Kernel and plain version draw the same
    ε; they differ only by the float rounding of ``log`` and ``cos``;
  * ``use_fused`` — the gate of trainer.py:289-296.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.schedule import alpha_dash

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit words of ``m·x`` for a 32-bit constant ``m`` and an
    int64 tensor ``x`` of 32-bit values, without int64 overflow."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    t = ml * xl
    mid = mh * xl + ml * xh + (t >> 16)
    lo = ((mid & 0xFFFF) << 16) | (t & 0xFFFF)
    hi = mh * xh + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter`` a
    4-tuple, ``key`` a 2-tuple (tensors or ints, broadcast together).
    Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normal_from_words(a, b):
    """Box–Muller of ``_normal_from_bits``: two int64 tensors of 32-bit words
    → one float32 standard normal each."""
    u1 = (a >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (b >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def philox_normal(b: int, n: int, seed, device) -> torch.Tensor:
    """The (b, n) float32 ε the kernel draws for ``seed`` (an int64 tensor of
    one element); n must be a multiple of 4."""
    seed = seed.reshape(()).to(device=device, dtype=torch.int64)
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    g = torch.arange(n // 4, device=device, dtype=torch.int64)
    sample = torch.arange(b, device=device, dtype=torch.int64)
    half = torch.arange(2, device=device, dtype=torch.int64)
    counter = (g[None, :, None], sample[:, None, None], half[None, None, :],
               torch.zeros((), device=device, dtype=torch.int64))
    w = philox4x32_10(counter, key)  # each (b, n/4, 2)
    eps = torch.stack([normal_from_words(w[0], w[1]), normal_from_words(w[2], w[3])], -1)
    return eps.reshape(b, n)  # element 4g + 2·half + j


def diffuse_plain(x, ss, sn, seed):
    """``x·ss[b] + ε·sn[b]`` with the kernel's ε, in float32. x: (B, N)
    float32, ss/sn: (B,) float32, seed: int64 tensor of one element."""
    b, n = x.shape
    eps = philox_normal(b, n, seed, x.device)
    return x * ss[:, None] + eps * sn[:, None]


def _entry():
    fn = _build.load("diffuse").gct2_diffuse_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def diffuse_fused(x, ss, sn, seed):
    """Forward of B1: x (B, N) float32 contiguous with N % 4 == 0, ss/sn (B,)
    float32, seed an int64 tensor of one element on x's device (read by the
    kernel, so drawing it needs no host sync)."""
    if x.device.type == "cpu":
        return diffuse_plain(x, ss, sn, seed)
    if x.device.type != "cuda":
        raise ValueError(f"diffuse_fused: no kernel for device {x.device}")
    b, n = x.shape
    if x.dtype != torch.float32 or ss.dtype != torch.float32 or sn.dtype != torch.float32:
        raise TypeError("diffuse_fused: x, ss and sn must be float32")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise TypeError("diffuse_fused: seed must be one int64 element")
    if any(t.device != x.device for t in (ss, sn, seed)):
        raise ValueError("diffuse_fused: x, ss, sn and seed must share a device")
    if not x.is_contiguous() or x.data_ptr() % 16 or n % 4:
        raise ValueError("diffuse_fused: x must be contiguous, 16-byte aligned, N % 4 == 0")
    if tuple(ss.shape) != (b,) or tuple(sn.shape) != (b,):
        raise ValueError(f"diffuse_fused: ss/sn must be ({b},)")
    ss, sn = ss.contiguous(), sn.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), ss.data_ptr(), sn.data_ptr(), seed.data_ptr(),
                       out.data_ptr(), b, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"diffuse kernel launch failed: CUDA error {err}")
    diffuse_fused.launches += 1
    return out


diffuse_fused.launches = 0


class FusedDiffuse(torch.autograd.Function):
    """B1 with its backward: d noised / dx = ss[b]. The scales and the seed
    get no gradient (kernels.py:156-162: the schedule is not learned)."""

    @staticmethod
    def forward(ctx, x, ss, sn, seed):
        ctx.save_for_backward(ss)
        return diffuse_fused(x, ss, sn, seed)

    @staticmethod
    def backward(ctx, g):
        (ss,) = ctx.saved_tensors
        return g * ss[:, None].to(g.dtype), None, None, None


def use_fused(cfg, batch_shape, epsilon_in=None) -> bool:
    """The gate of trainer.py:289-296: ε drawn here (not injected), the
    ``x`` parameterization (ε unused downstream), a flattened sample that is
    a multiple of 128. The JAX gate also asks for a TPU, because Pallas
    interpret mode stubs the PRNG bits on other backends (kernels.py:136-141);
    the plain version here draws the kernel's own stream, so the CPU takes
    this path too, through it, and a CPU run sees the card's noise."""
    n = batch_shape[1] * batch_shape[2] * batch_shape[3]
    return (
        epsilon_in is None
        and cfg.fused_diffusion
        and cfg.parameterization == "x"
        and n % 128 == 0
    )


def forward_diffuse_fused(cfg, x, t, seed):
    """Drop-in for ``core.diffusion.forward_diffuse`` on the ``x`` path.
    x: (B, H, W, C) float32; t: (B, 1, 1, 1) float; seed: int64 tensor of one
    element on x's device. Returns ``noised``."""
    b = x.shape[0]
    ad = alpha_dash(t.reshape(b), cfg.steps, cfg.schedule).to(torch.float32)
    ss = torch.sqrt(ad).detach()
    sn = torch.sqrt(1.0 - ad).detach()
    out = FusedDiffuse.apply(x.reshape(b, -1), ss, sn, seed)
    return out.reshape(x.shape)
