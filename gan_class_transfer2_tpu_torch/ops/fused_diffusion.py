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

The per-sample scales ``(ss, sn) = (√ᾱ(t), √(1 − ᾱ(t)))`` come from a
(steps + 1, 2) table built once per ``(steps, schedule, device)``
(``scale_table``), gathered by t inside the kernel: the step's draw of t and
of the seed and the kernel are its only three launches for the noising.

B1s (kernels.py:209 ``forward_diffuse_fused_sharded``, B1 under a
``shard_map``) is B1 on one rank's block of the batch: every rank draws the
same seed, and the kernel XORs the seed's low word with ``fold_word(p) =
(p + 1)·0x9E3779B9 mod 2³²``, JAX's ``seed ^ ((lin + 1)·-1640531527)`` in
wrapping int32 arithmetic, for the rank's linear mesh position ``p``; the
high word stays. The word is computed on the host from the position, a
Python int, and passed to the kernel (``gct2_diffuse_f32_folded``): no
device op and no host sync. ``diffuse_fused_sharded`` counts its own
launches, so a run shows which of B1 and B1s it took; its plain version is
``diffuse_plain`` with the folded seed (``diffuse_sharded_plain``).
``fused_sharded_ok`` is JAX's gate on the local shape.

Three pieces, as for every kernel of the port:

  * ``diffuse_fused`` — the wrapper of csrc/diffuse.cu, with its launch
    counter ``diffuse_fused.launches``, inside ``FusedDiffuse``, the
    autograd Function whose backward is ``g·ss[b]`` (kernels.py:117-120);
  * ``diffuse_plain`` — the same function in plain PyTorch: the same table
    gather, the same Philox written in int64 arithmetic, its 32×32-bit
    products split into 16-bit halves so that nothing overflows. Kernel and
    plain version draw the same ε; on the card they agree bit for bit (the
    kernel uses the library's IEEE log and cos), on the CPU up to the
    rounding of ``log`` and ``cos``;
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


def diffuse_plain(x, t, table, seed):
    """``x·ss[b] + ε·sn[b]`` with ``(ss, sn) = table[t[b]]`` and the kernel's
    ε, in float32. x: (B, N) float32; t: (B,) integer; table: (rows, 2)
    float32; seed: int64 tensor of one element."""
    b, n = x.shape
    sc = table[t.reshape(b).long()]  # (B, 2)
    eps = philox_normal(b, n, seed, x.device)
    return x * sc[:, :1] + eps * sc[:, 1:]


_tables: dict = {}


def scale_table(steps: int, schedule: str, device) -> torch.Tensor:
    """The (steps + 1, 2) float32 table of ``(√ᾱ(t), √(1 − ᾱ(t)))`` for
    t = 0 … steps on ``device``, built once per ``(steps, schedule,
    device)`` by the torch ops the step ran on each batch before: float32 t,
    ``alpha_dash``, ``sqrt(ad)``, ``sqrt(1 − ad)``."""
    device = torch.device(device)
    key = (steps, schedule, device)
    table = _tables.get(key)
    if table is None:
        t = torch.arange(steps + 1, device=device).to(torch.float32)
        ad = alpha_dash(t, steps, schedule).to(torch.float32)
        table = _tables[key] = torch.stack([torch.sqrt(ad), torch.sqrt(1.0 - ad)], 1)
    return table


def fold_word(position: int) -> int:
    """The 32-bit word B1s XORs into the seed's low word at linear mesh
    position ``position``: JAX's ``(lin + 1) * jnp.int32(-1640531527)``
    (kernels.py:258-259) as an unsigned word (−1640531527 is 0x9E3779B9)."""
    return ((position + 1) * _W0) & _MASK32


def fold_seed(seed, position: int):
    """``seed`` (an int64 tensor) with its low word folded for
    ``position``; the high word is left as it is."""
    return seed ^ fold_word(position)


def diffuse_sharded_plain(x, t, table, seed, position: int):
    """B1s's plain version: ``diffuse_plain`` with the folded seed."""
    return diffuse_plain(x, t, table, fold_seed(seed, position))


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("diffuse").gct2_diffuse_f32_folded
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                                               ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def diffuse_fused(x, t, table, seed):
    """Forward of B1: the plain version for a CPU tensor, the kernel on the
    current stream for a CUDA tensor (or an exception). x (B, N) float32
    contiguous, 16-byte aligned, N % 4 == 0; t (B,) int32 and table
    (rows, 2) float32, both contiguous; seed an int64 tensor of one element
    (read by the kernel, so drawing it needs no host sync). All on x's
    device. The checks read ints and flags only (no device or string
    objects): the wrapper's host time paces back-to-back calls."""
    if not x.is_cuda:
        if x.is_cpu:
            return diffuse_plain(x, t, table, seed)
        raise ValueError(f"diffuse_fused: no kernel for device {x.device}")
    out = _launch(x, t, table, seed, 0)
    _build.count(diffuse_fused)
    return out


diffuse_fused.launches = 0


def diffuse_fused_sharded(x, t, table, seed, position: int):
    """Forward of B1s: B1 on one rank's block ``x`` with the seed folded for
    the rank's linear mesh ``position`` (inside the kernel). The plain
    version for a CPU tensor, the kernel for a CUDA tensor (or an
    exception); the arguments as ``diffuse_fused``'s."""
    if not x.is_cuda:
        if x.is_cpu:
            return diffuse_sharded_plain(x, t, table, seed, position)
        raise ValueError(f"diffuse_fused_sharded: no kernel for device {x.device}")
    out = _launch(x, t, table, seed, fold_word(position))
    _build.count(diffuse_fused_sharded)
    return out


diffuse_fused_sharded.launches = 0


def _launch(x, t, table, seed, fold: int):
    """One launch of csrc/diffuse.cu on CUDA tensors, checked."""
    f32 = torch.float32
    if x.dtype is not f32 or table.dtype is not f32 or t.dtype is not torch.int32 or (
            seed.dtype is not torch.int64):
        raise TypeError("diffuse_fused: x float32, t int32, table float32, seed int64")
    index = x.get_device()
    if t.get_device() != index or table.get_device() != index or seed.get_device() != index:
        raise ValueError("diffuse_fused: x, t, table and seed must share a device")
    b, n = x.shape
    rows = table.shape
    xp = x.data_ptr()
    if (n % 4 or xp % 16 or not x.is_contiguous() or t.numel() != b or not t.is_contiguous()
            or len(rows) != 2 or rows[1] != 2 or not table.is_contiguous() or seed.numel() != 1):
        raise ValueError("diffuse_fused: x (B, N) contiguous, 16-byte aligned, N % 4 == 0; "
                         "t (B,) and table (rows, 2) contiguous; one seed")
    out = torch.empty_like(x)
    args = (xp, t.data_ptr(), table.data_ptr(), rows[0], seed.data_ptr(), fold, out.data_ptr(),
            b, n)
    _build.launch(_entry(), args, index, "diffuse")
    return out


class FusedDiffuse(torch.autograd.Function):
    """B1 (``position`` None) or B1s (a rank's linear mesh position) with
    its backward: d noised / dx = ss[b] = table[t[b], 0]. The table and the
    seed get no gradient (kernels.py:156-162: the schedule is not
    learned)."""

    @staticmethod
    def forward(ctx, x, t, table, seed, position=None):
        ctx.save_for_backward(t, table)
        if position is None:
            return diffuse_fused(x, t, table, seed)
        return diffuse_fused_sharded(x, t, table, seed, position)

    @staticmethod
    def backward(ctx, g):
        t, table = ctx.saved_tensors
        ss = table[t.long(), 0]
        return g * ss[:, None].to(g.dtype), None, None, None, None


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


def _local_shape(x_shape, spec, extents):
    """The per-rank block shape of an array of ``x_shape`` split by ``spec``
    (one entry per leading dim: None, an axis name, or a tuple of names)
    over a mesh of ``extents`` ({axis: size}); None when a split dim does
    not divide (kernels.py:178-196)."""
    local = []
    for i, dim in enumerate(x_shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        k = 1
        for name in names:
            k *= extents[name]
        if dim % k:
            return None
        local.append(dim // k)
    return tuple(local)


def fused_sharded_ok(cfg, x_shape, world, spec) -> bool:
    """JAX's ``fused_sharded_ok`` (kernels.py:199): every split dim of the
    (B, H, W, C) batch divides, and each rank's flattened sample is a
    multiple of 128. ``world``: the data extent (an int), or the mesh's
    {axis: size}; ``spec``: the batch's split, e.g. ``("data",)``,
    ``(None, "spatial")`` or ``("data", "spatial")``."""
    extents = {"data": world} if isinstance(world, int) else dict(world)
    local = _local_shape(x_shape, spec, extents)
    if local is None:
        return False
    return (local[1] * local[2] * local[3]) % 128 == 0


def forward_diffuse_fused_sharded(cfg, x_local, t_local, seed, position: int):
    """B1s (kernels.py:209): ``forward_diffuse_fused`` on this rank's block
    ``x_local`` (b, H, W, C) float32 with ``t_local`` its b timesteps,
    ``seed`` the step's int64 seed (the same on every rank) and
    ``position`` the rank's linear mesh position, which the kernel folds
    into the seed. Returns the block's ``noised``."""
    b = x_local.shape[0]
    t = t_local.reshape(b)
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    table = scale_table(cfg.steps, cfg.schedule, x_local.device)
    out = FusedDiffuse.apply(x_local.reshape(b, -1), t.contiguous(), table, seed, int(position))
    return out.reshape(x_local.shape)


def forward_diffuse_fused(cfg, x, t_int, seed):
    """Drop-in for ``core.diffusion.forward_diffuse`` on the ``x`` path.
    x: (B, H, W, C) float32; t_int: B integer timesteps; seed: int64 tensor
    of one element; all on x's device. The kernel gathers its scales from
    ``scale_table`` by t, so the step launches nothing for them. Returns
    ``noised``."""
    b = x.shape[0]
    t = t_int.reshape(b)
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    table = scale_table(cfg.steps, cfg.schedule, x.device)
    out = FusedDiffuse.apply(x.reshape(b, -1), t.contiguous(), table, seed)
    return out.reshape(x.shape)
