"""Instance norm (B3) and batch norm — counterpart of
gan_class_transfer2_tpu/ops/norm.py.

The reference model has no normalization; the GAN-mode models do
(``g_norm``/``d_norm``). Pieces, as for every kernel of the port:

  * ``instance_norm`` — the op: ``InstanceNorm``, an ``autograd.Function``
    whose forward is ``instance_norm_fused``, the wrapper of the hand-written
    CUDA kernel in csrc/instance_norm.cu (launch counter
    ``instance_norm_fused.launches``), and whose backward, inside the span
    ``norm.backward`` (``utils/profiler.annotate``), is
    ``instance_norm_bwd_fused``: a kernel of its own in the same source
    (norm.py:109-119 is plain jnp, so it replaces no Pallas kernel; launch
    counter ``instance_norm_bwd_fused.launches``, one launch a norm, two
    where γ and β need their gradients), whose plain version is ``_in_bwd``;
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
    taken while ``torch.compiler.is_exporting()`` and for a fake tensor, as
    for B4.

The JAX package sends a norm to its Pallas kernel only on a TPU, for
``C % 128 == 0`` and a per-sample block of at most 6 MB (``_use_pallas``,
norm.py:80-86): the (8, 128) lane tiling and the VMEM budget of a TPU core.
Neither binds on Hopper, so there is no such gate here: the kernel takes
every NHWC shape, the GAN path's 256²×64 up-norm included, which the TPU
sent to XLA.

The backward recomputes the statistics from the saved input, never from
values the forward made under no-grad. Where the backward is itself recorded
(``create_graph=True``: R1's double backward through a normalised
discriminator, train/gan.py ``r1_penalty``, differentiates it once more and
needs the ∂(m, r)/∂x terms, which JAX gets because its residuals are traced
functions of x, norm.py:103-106) it is ``_in_bwd``'s differentiable torch
ops, counted on a CUDA tensor by ``InstanceNorm.graph_backwards``; otherwise
a CUDA tensor takes the kernel. Grad mode says which, nothing else.

Statistics across ranks. JAX runs a step over its mesh as one program over
the global arrays, so a norm's statistics span whatever the mesh splits.
Here each rank holds a block, and two routes take the collectives:

  * ``batch_norm`` over the ranks of registered axes (``parallel/multihost``
    ``set_axes``): the steps over a mesh open ``stats_over("batch")`` around
    their forward (the spatial body ``stats_over("data", "spatial")``), and
    every batch norm inside sums its per-channel sums and counts, then its
    centred sums of squares, over those ranks (JAX's two-pass
    ``mean(square(x − m))`` over the global batch). The sums are
    ``sum_over_ranks``, an autograd Function that keeps its axes for the
    backward: its adjoint is the same sum of the cotangents (each rank's
    loss a summand of the global one) and is itself that Function, so R1's
    double backward differentiates through it, on whatever thread autograd
    runs it. A forward recomputed in the backward (``cfg.remat``'s
    checkpoints) reopens the context it ran under
    (``models/unet.unet_apply``). Outside the context (one process, a
    sampler, a server) nothing changes;
  * B3 over height blocks (``instance_norm_blocks``): a rank holds rows of
    every image, so each (b, c) statistic spans the spatial group's
    blocks. Two launches of csrc/instance_norm.cu a norm, kernels of their
    own beside the single launch's: ``block_stats`` writes the block's
    count, mean and M2 per (b, c) into the rank's slot of an (s·B, C, 3)
    buffer, which ``all_gather_into_tensor`` fills in place; then
    ``block_merge_apply`` merges the s triples by Chan's rule in rank order
    inside the launch (the formulas and order of ``merge_block_stats``, so
    every rank holds bit-identical statistics), normalises with γ and β in
    one read and one write, and writes the (mean, r) the backward keeps.
    ``block_plan`` cuts each block for the card: a (sample, 32-channel
    group) takes a warp or a few where its pixels are few (no cluster), a
    block or a cluster of blocks where they are many; the statistics pass
    sums x − K about the block's first pixel K (3 instructions an element,
    no division) with the next loads in flight. On the CPU the same route
    takes the plain pieces (``block_stats_plain``,
    ``block_merge_apply_plain``). Its backward sums the per-(b, c) Σg and
    Σg·x̂ of the block over the group (one ``all_reduce``) and forms dx in
    torch ops, as B3's; dγ and dβ are the block's own, summed by the
    step's gradient all-reduce. The spatial step has no R1, so this
    backward is not differentiated again.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor

from ..parallel import multihost
from ..utils import profiler
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
    (C,), or both None (no affine); returns x's dtype."""
    m, r = _stats(x)
    if gamma is None:
        return ((x.float() - m) * r).to(x.dtype)
    g = gamma.to(x.dtype).float()
    b = beta.to(x.dtype).float()
    return ((x.float() - m) * r * g + b).to(x.dtype)


_ENTRY = {torch.float32: "gct2_instance_norm_f32", torch.bfloat16: "gct2_instance_norm_bf16"}
_FNS: dict = {}
CLUSTER_MAX = 8  # portable thread-block cluster size
CHANNELS = 32  # channels per cluster
# blocks a norm should put on the card: 7/8 of one per SM. Larger clusters
# that reach 132 or 256 blocks measured slower on the two big maps (PERF.md,
# Findings)
FILL_TARGET = -(-7 * _build.SM_COUNT // 8)


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


@functools.lru_cache(maxsize=None)
def _unit_affine(c: int, device: torch.device):
    """float32 ones and zeros (C,) on ``device``: what a launch reads as γ and
    β where the norm has none (the ResNet generator's and the 70×70
    PatchGAN's). ``y = x̂·1 + 0`` and ``dx`` from ``dy·1`` are exact, so the
    kernels compute the norm without affine bit for bit; the backward then
    skips the dγ, dβ launch."""
    return (torch.ones(c, dtype=torch.float32, device=device),
            torch.zeros(c, dtype=torch.float32, device=device))


def _affine_f32(gamma, beta, c, device):
    """γ and β as float32 contiguous tensors for a launch's pointers."""
    if gamma is None:
        return _unit_affine(c, device)
    return _f32(gamma), _f32(beta)


def _f32(t):
    """A float32 contiguous tensor of ``t``'s values (for its pointer), ``t``
    itself if it is one."""
    if t.dtype != torch.float32:
        t = t.detach().float()
    return t if t.is_contiguous() else t.detach().contiguous()


def instance_norm_fused(x, gamma, beta):
    """Forward of B3: the plain version for a CPU tensor, the kernel on the
    current stream for a CUDA tensor (or an exception). x (B, H, W, C)
    contiguous, float32 or bfloat16; gamma/beta (C,) on x's device, or both
    None (no affine)."""
    dev = x.device
    if dev.type == "cpu":
        return instance_norm_plain(x, gamma, beta)
    if dev.type != "cuda":
        raise ValueError(f"instance_norm_fused: no kernel for device {dev}")
    _check(x, gamma, beta, "instance_norm_fused")
    b, h, w, c = x.shape
    # γ and β go over as float32 (no copy for the float32 parameters); the
    # kernel rounds them to x's dtype, as the Pallas wrapper does (norm.py:76)
    g, bt = _affine_f32(gamma, beta, c, dev)
    y = torch.empty_like(x)
    _build.launch(_entry(x.dtype), (x.data_ptr(), g.data_ptr(), bt.data_ptr(), y.data_ptr(), b,
                                    h * w, c, plan(b, h, w, c).cluster), dev.index,
                  "instance_norm")
    _build.count(instance_norm_fused)
    return y


instance_norm_fused.launches = 0


def _check(x, gamma, beta, who):
    """What a launch of B3's kernel takes: x contiguous NHWC float32 or
    bfloat16 of at most 65535 samples; γ and β (C,) on x's device, or both
    None."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"{who}: float32 or bfloat16 only, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous NHWC, got {tuple(x.shape)}")
    c = x.shape[-1]
    if (gamma is None) != (beta is None):
        raise ValueError(f"{who}: gamma and beta are both given or both None")
    if gamma is not None:
        if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
            raise ValueError(f"{who}: gamma/beta must be ({c},)")
        if gamma.device != x.device or beta.device != x.device:
            raise ValueError(f"{who}: x, gamma and beta must share a device")
    if x.shape[0] > 65535:
        raise ValueError(f"{who}: batch {x.shape[0]} exceeds the grid's 65535")


def _in_bwd(x, gamma, dy):
    """norm.py:109-119 with (m, r) recomputed from x by differentiable ops:
    ``instance_norm_bwd_fused``'s plain version, and the backward that a
    double backward differentiates. Without γ (None), ``(dx, None, None)``."""
    m, r = _stats(x)
    dy = dy.float()
    xhat = (x.float() - m) * r
    if gamma is None:
        dgamma = dbeta = None
        g = dy
    else:
        dgamma = torch.sum(dy * xhat, dim=(0, 1, 2)).to(gamma.dtype)
        dbeta = torch.sum(dy, dim=(0, 1, 2)).to(gamma.dtype)
        g = dy * gamma.float()
    mean_g = g.mean(dim=(1, 2), keepdim=True)
    mean_gx = (g * xhat).mean(dim=(1, 2), keepdim=True)
    dx = r * (g - mean_g - xhat * mean_gx)
    return dx.to(x.dtype), dgamma, dbeta


@torch.library.custom_op("gct2::instance_norm", mutates_args=())
def instance_norm_op(x: torch.Tensor, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor]) -> torch.Tensor:
    """B3's forward by name: the kernel on a CUDA tensor, the plain version
    on a CPU one, an exception elsewhere; γ and β both None for a norm
    without affine."""
    return instance_norm_fused(x, gamma, beta)


@instance_norm_op.register_fake
def _(x, gamma, beta):
    return torch.empty_like(x)


class InstanceNorm(torch.autograd.Function):
    """B3 with the custom VJP of norm.py:95-122. Its backward is the kernel
    on a CUDA tensor, unless autograd records it (grad mode on: a
    ``create_graph=True`` backward), which takes the torch ops of
    ``_in_bwd`` on the saved inputs, differentiable again;
    ``graph_backwards`` counts those on a CUDA tensor."""

    graph_backwards = 0

    @staticmethod
    def forward(ctx, x, gamma, beta):
        ctx.save_for_backward(x, gamma)
        return instance_norm_fused(x, gamma, beta)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        with profiler.annotate("norm.backward"):
            if dy.device.type != "cuda":
                return _in_bwd(x, gamma, dy)
            if torch.is_grad_enabled():
                _build.count(InstanceNorm, "graph_backwards")
                return _in_bwd(x, gamma, dy)
            _, need_gamma, need_beta = ctx.needs_input_grad
            dx, dgamma, dbeta = instance_norm_bwd_fused(x, gamma, dy, need_gamma or need_beta)
            return dx, dgamma if need_gamma else None, dbeta if need_beta else None


def instance_norm(x, gamma, beta):
    """Per-(sample, channel) normalization over (H, W) with affine γ/β.
    x: (B, H, W, C); gamma/beta: (C,), or both None for a norm without
    affine (no dγ, dβ in the backward). Under ``torch.export`` (inference)
    and for a fake or meta tensor (shapes only: ``utils/profiler
    .compiled_stats``, a model built on the meta device; forward only) the
    forward is the custom op ``gct2::instance_norm``."""
    if torch.compiler.is_exporting() or isinstance(x, FakeTensor) or x.is_meta:
        return instance_norm_op(x.contiguous(), gamma, beta)
    return InstanceNorm.apply(x.contiguous(), gamma, beta)


# ------------------------------------------------------- across ranks

_RANKS = threading.local()  # .names: the axes a step's norm statistics span;
# .replica: (ReplicaGroup, index) of a replica thread (over_replicas)


@contextlib.contextmanager
def stats_over(*names):
    """Within: batch norm's statistics span the ranks of the registered
    axes ``names`` (``multihost.axis``; an axis of one rank adds nothing).
    Read when a batch norm's forward runs: the steps over a mesh hold it
    around their forward. It is this thread's and ends with the block."""
    saved = getattr(_RANKS, "names", ())
    _RANKS.names = tuple(names)
    try:
        yield
    finally:
        _RANKS.names = saved


def stats_names() -> tuple:
    """The axes' names of the open ``stats_over`` (none outside one): what a
    recomputed forward reopens."""
    return getattr(_RANKS, "names", ())


def rank_axes() -> list:
    """The ``multihost.Axis`` of each name of the open ``stats_over`` that
    spans more than one rank."""
    return [a for a in (multihost.axis(n) for n in stats_names()) if a.size > 1]


def _all_reduce(x, axes):
    out = x.contiguous().clone()
    for ax in axes:
        with multihost.comm.record("norm", out):
            dist.all_reduce(out, group=ax.group)
    return out


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, ctx.axes), None


def sum_over_ranks(x, axes):
    """The sum of ``x`` over the ranks of ``axes`` (a list of
    ``multihost.Axis``), the same on each; differentiable any number of
    times, its adjoint the sum of the ranks' cotangents."""
    return _SumOverRanks.apply(x, axes) if axes else x


class ReplicaGroup:
    """``size`` threads of one process, each running a replica on its rows
    of a batch, that sum batch norm's statistics between them (the
    pipeline's PP × DP replicas). The threads take turns, in replica
    order: one runs until its next norm posts its part of the sums, then
    hands the turn on, and when the turn comes back every part is posted,
    so it adds the parts in replica order on its own device (every replica
    normalises with the same bits) and runs on. One thread is on the host
    at a time, so a device's stream takes the replicas' launches in a
    fixed order and no thread waits for the GIL, which every torch call
    lets go of and takes back; the launches stay asynchronous on the
    devices. Sums alternate between two banks of
    slots: a bank is written again only after every replica has read it.
    The sum is plain torch ops, differentiable, so its adjoint is an
    ordinary edge of the graph: no wait is left in the backward, which on
    the card runs on autograd's one thread a device. A wait longer than
    ``timeout`` seconds, or ``abort`` (a replica that raised), breaks every
    wait with ``threading.BrokenBarrierError``."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self.timeout = timeout
        self._cond = threading.Condition()
        self.sums = 0  # sums taken (each one a call from every replica)
        self.clear()

    def clear(self):
        """Drop the slots' tensors and give replica 0 the turn (between runs
        of the replicas' threads)."""
        self._banks = [[None] * self.size, [None] * self.size]
        self._reads = [0] * self.size
        self._turn = 0
        self._broken = False

    def wait_turn(self, index: int):
        with self._cond:
            ok = self._cond.wait_for(lambda: self._broken or self._turn == index, self.timeout)
            if self._broken or not ok:
                self._broken = True
                self._cond.notify_all()
                raise threading.BrokenBarrierError(f"replica {index}: the group is broken")

    def pass_turn(self, index: int):
        with self._cond:
            self._turn = (index + 1) % self.size
            self._cond.notify_all()

    def abort(self):
        with self._cond:
            self._broken = True
            self._cond.notify_all()

    def sum(self, x, index: int):
        """Σ over the replicas of their ``x`` (this thread's is replica
        ``index``'s), on ``x``'s device."""
        slots = self._banks[self._reads[index] % 2]
        self._reads[index] += 1
        slots[index] = x
        self.pass_turn(index)
        self.wait_turn(index)
        total = slots[0].to(x.device)
        for part in slots[1:]:
            total = total + part.to(x.device)
        if index == 0:
            self.sums += 1
        return total


@contextlib.contextmanager
def over_replicas(group, index: int):
    """Within (this thread): batch norm's statistics also span the replicas
    of ``group`` (a ``ReplicaGroup``; None adds nothing), this thread being
    replica ``index``: it waits for its turn on entry and hands the turn on
    at the end, or breaks the group's waits if the block raises."""
    saved = getattr(_RANKS, "replica", None)
    if group is not None:
        group.wait_turn(index)
    _RANKS.replica = None if group is None else (group, index)
    try:
        yield
    except BaseException:
        if group is not None:
            group.abort()
        raise
    else:
        if group is not None:
            group.pass_turn(index)
    finally:
        _RANKS.replica = saved


def batch_norm(x, gamma, beta, eps: float = _EPS):
    """Training-mode batch norm: stats over (B, H, W) per channel
    (norm.py:125-133), and over the ranks of the open ``stats_over`` and
    the replicas of the open ``over_replicas``: the sums and the count
    summed over them, then the centred squares."""
    axes = rank_axes()
    replica = getattr(_RANKS, "replica", None)
    xf = x.float()
    if not axes and replica is None:
        m = xf.mean(dim=(0, 1, 2), keepdim=True)
        v = torch.square(xf - m).mean(dim=(0, 1, 2), keepdim=True)
    else:
        def total(part):
            part = sum_over_ranks(part, axes)
            return part if replica is None else replica[0].sum(part, replica[1])

        c = x.shape[-1]
        sums = total(torch.cat([xf.sum(dim=(0, 1, 2)), xf.new_full((1,), xf.numel() // c)]))
        count = sums[c]
        m = (sums[:c] / count).reshape(1, 1, 1, c)
        v = (total(torch.square(xf - m).sum(dim=(0, 1, 2))) / count).reshape(1, 1, 1, c)
    y = (xf - m) * torch.rsqrt(v + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


# ---------------------------------------------- B3 over height blocks

_BLOCK_ENTRY = {
    "stats": {torch.float32: "gct2_instance_norm_block_stats_f32",
              torch.bfloat16: "gct2_instance_norm_block_stats_bf16"},
    "apply": {torch.float32: "gct2_instance_norm_block_apply_f32",
              torch.bfloat16: "gct2_instance_norm_block_apply_bf16"},
    "bwd": {torch.float32: "gct2_instance_norm_bwd_f32",
            torch.bfloat16: "gct2_instance_norm_bwd_bf16"},
}
_BLOCK_ARGS = {
    # x, stats; B, HW, C, wpg, wpb, S; stream
    "stats": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    # x, parts, s, gamma, beta, y, mean_r; B, HW, C, wpg, wpb, S; stream
    "apply": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    # x, dy, gamma, dx, parts, dgamma, dbeta; B, HW, C, wpg, wpb, S; stream
    "bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
WARPS = 8  # the most warps of a height-block launch's thread block (256 threads)
# pixels a lane of a warp should stream before a group takes more warps
# (tools/kernel_plan_sweep.py b3, PERF.md Findings)
LANE_PIXELS = 8


class BlockPlan(NamedTuple):
    """How the height-block kernels cut a block (B, h, W, C): a (sample,
    32-channel group) takes ``wpg`` warps and a thread block ``wpb`` warps
    (``wpb // wpg`` groups); ``cluster`` blocks split a group's h·W pixels
    into chunks of ``chunk`` (the stats launch's thread-block cluster; 1:
    no cluster, one chunk); ``blocks``: the grid's size."""

    wpg: int
    wpb: int
    cluster: int
    chunk: int
    blocks: int


@functools.lru_cache(maxsize=None)
def block_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype,
               lane_pixels: int = LANE_PIXELS) -> BlockPlan:
    """The height-block kernels' plan, from the shape alone (and the
    backward's, ``instance_norm_bwd_fused``, of a whole image). A warp reads
    VEC = 16 / itemsize pixels at a time (4 float32, 8 bfloat16); a group
    takes the fewest warps (a power of 2, at most ``WARPS``) whose lanes
    stream at most ``lane_pixels`` pixels each. A group of fewer than
    ``WARPS`` warps shares its thread block with others, as many as keep
    ``FILL_TARGET`` blocks on the card; a group of ``WARPS`` warps takes a
    block, and the smallest cluster (a power of 2, at most
    ``CLUSTER_MAX``) that puts ``FILL_TARGET`` blocks on the card, as
    ``plan`` picks for the single launch."""
    hw = h * w
    lanes = 16 // dtype.itemsize
    nq = b * -(-c // CHANNELS)  # (sample, channel group)s
    wpg = 1
    while wpg < WARPS and wpg * lanes * lane_pixels < hw:
        wpg *= 2
    s, wpb = 1, wpg
    if wpg == WARPS:
        while nq * s < FILL_TARGET and s < CLUSTER_MAX and 2 * s <= hw:
            s *= 2
    else:
        while wpb < WARPS and -(-nq * wpg // (2 * wpb)) >= FILL_TARGET:
            wpb *= 2
    return BlockPlan(wpg, wpb, s, -(-hw // s), -(-nq * wpg // wpb) * s)


def _block_entry(kind, dtype):
    key = (kind, dtype)
    fn = _FNS.get(key)
    if fn is None:
        fn = _FNS[key] = getattr(_build.load("instance_norm"), _BLOCK_ENTRY[kind][dtype])
        fn.argtypes = _BLOCK_ARGS[kind]
        fn.restype = ctypes.c_int
    return fn


def instance_norm_bwd_fused(x, gamma, dy, need_affine=True):
    """B3's backward ``(dx, dγ, dβ)``: the plain version ``_in_bwd`` for a
    CPU tensor, the kernel on the current stream for a CUDA tensor (or an
    exception). x (B, H, W, C) contiguous, float32 or bfloat16; dy of x's
    shape and dtype; gamma (C,) on x's device, or None (a norm without
    affine: read as ones). The statistics are recomputed from x in float32,
    dx is rounded once to x's dtype, dγ and dβ are float32, or None where
    ``need_affine`` is false (one launch instead of two). The launch cuts
    the image as ``block_plan`` cuts a height block."""
    dev = dy.device
    if dev.type == "cpu":
        dx, dgamma, dbeta = _in_bwd(x, gamma, dy)
        return (dx, dgamma, dbeta) if need_affine else (dx, None, None)
    if dev.type != "cuda":
        raise ValueError(f"instance_norm_bwd_fused: no kernel for device {dev}")
    _check(x, gamma, gamma, "instance_norm_bwd_fused")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"instance_norm_bwd_fused: dy must match x {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    dy = dy.contiguous()
    b, h, w, c = x.shape
    p = block_plan(b, h, w, c, x.dtype)
    dx = torch.empty_like(x)
    # the (b, c) sums, dγ and dβ; no view or select of them: each is one
    # more host call inside the backward
    out = (None, None, None)
    if need_affine:
        out = tuple(torch.empty(n, dtype=torch.float32, device=dev) for n in (b * c * 2, c, c))
    _build.launch(_block_entry("bwd", x.dtype),
                  (x.data_ptr(), dy.data_ptr(), _affine_f32(gamma, gamma, c, dev)[0].data_ptr(),
                   dx.data_ptr(), *(None if t is None else t.data_ptr() for t in out), b, h * w,
                   c, p.wpg, p.wpb, p.cluster), dev.index, "instance_norm backward")
    _build.count(instance_norm_bwd_fused)
    if need_affine:
        _build.count(instance_norm_bwd_fused)
    return dx, out[1], out[2]


instance_norm_bwd_fused.launches = 0


def block_stats_plain(x):
    """A block's (count, mean, M2) per (sample, channel) in plain PyTorch:
    float32 (B, C, 3), two passes."""
    xf = x.float()
    m = xf.mean(dim=(1, 2))
    m2 = torch.square(xf - m[:, None, None, :]).sum(dim=(1, 2))
    return torch.stack([torch.full_like(m, x.shape[1] * x.shape[2]), m, m2], -1)


def block_stats(x, out=None):
    """A block's (count, mean, M2) per (sample, channel), float32 (B, C, 3),
    into ``out`` (a contiguous float32 (B, C, 3) on x's device, a rank's
    slot of the gather's buffer) or a new tensor: the plain version for a
    CPU tensor, the stats launch on the card for a CUDA tensor (or an
    exception). x (B, h, W, C) contiguous."""
    dev = x.device
    if dev.type == "cpu":
        got = block_stats_plain(x)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"block_stats: no kernel for device {dev}")
    _check(x, None, None, "block_stats")
    b, h, w, c = x.shape
    if out is None:
        out = torch.empty((b, c, 3), dtype=torch.float32, device=dev)
    elif (tuple(out.shape) != (b, c, 3) or out.dtype != torch.float32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"block_stats: out must be contiguous float32 ({b}, {c}, 3) on {dev}")
    p = block_plan(b, h, w, c, x.dtype)
    _build.launch(_block_entry("stats", x.dtype),
                  (x.data_ptr(), out.data_ptr(), b, h * w, c, p.wpg, p.wpb, p.cluster), dev.index,
                  "instance_norm block stats")
    _build.count(block_stats)
    return out


block_stats.launches = 0


def merge_block_stats(parts):
    """Every block's triples (s, B, C, 3), merged by Chan's rule in block
    order: ``(mean, r)`` float32 (B, C) each, r = 1/√(var + 1e-5), the
    variance clamped at 0 as the kernel clamps it."""
    n, mean, m2 = parts[0].unbind(-1)
    for p in parts[1:]:
        nb, mb, m2b = p.unbind(-1)
        tot = n + nb
        d = mb - mean
        f = nb / tot
        mean = mean + d * f
        m2 = m2 + m2b + d * d * n * f
        n = tot
    var = torch.clamp(m2 / n, min=0.0)
    return mean, torch.rsqrt(var + _EPS)


def block_apply_plain(x, mean, rstd, gamma, beta):
    """``((x − mean)·r)·γ + β`` in plain PyTorch, mean and r (B, C), γ and β
    first rounded to x's dtype (as B3); returns x's dtype."""
    g = gamma.to(x.dtype).float()
    b = beta.to(x.dtype).float()
    y = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :] * g + b
    return y.to(x.dtype)


def block_merge_apply_plain(x, parts, gamma, beta):
    """The merge-and-apply launch's function in plain PyTorch: ``(y, mean,
    r)`` from a block x and every block's triples ``parts`` (s, B, C, 3)."""
    mean, rstd = merge_block_stats(parts)
    return block_apply_plain(x, mean, rstd, gamma, beta), mean, rstd


def block_merge_apply(x, parts, gamma, beta):
    """``(y, mean, r)`` of a block: every block's triples ``parts`` (s, B, C,
    3) merged in block order and the block normalised with γ and β. The
    plain version for a CPU tensor; on the card for a CUDA tensor (or an
    exception) one launch that merges and applies, mean and r (B, C) views
    of the float32 (B, C, 2) it writes."""
    dev = x.device
    if dev.type == "cpu":
        return block_merge_apply_plain(x, parts, gamma, beta)
    if dev.type != "cuda":
        raise ValueError(f"block_merge_apply: no kernel for device {dev}")
    _check(x, gamma, beta, "block_merge_apply")
    b, h, w, c = x.shape
    if (parts.dim() != 4 or tuple(parts.shape[1:]) != (b, c, 3) or parts.shape[0] < 1
            or parts.dtype != torch.float32 or parts.device != dev
            or not parts.is_contiguous()):
        raise ValueError(f"block_merge_apply: parts must be contiguous float32 (s, {b}, {c}, 3) "
                         f"on {dev}, got {tuple(parts.shape)} {parts.dtype}")
    p = block_plan(b, h, w, c, x.dtype)
    g, bt = _f32(gamma), _f32(beta)
    y = torch.empty_like(x)
    mr = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    _build.launch(_block_entry("apply", x.dtype),
                  (x.data_ptr(), parts.data_ptr(), parts.shape[0], g.data_ptr(), bt.data_ptr(),
                   y.data_ptr(), mr.data_ptr(), b, h * w, c, p.wpg, p.wpb, p.cluster), dev.index,
                  "instance_norm block merge and apply")
    _build.count(block_merge_apply)
    return y, mr[..., 0], mr[..., 1]


block_merge_apply.launches = 0


def block_launches() -> int:
    """Launches of B3 over height blocks so far (both kernels)."""
    return block_stats.launches + block_merge_apply.launches


# torch 2.13 names the concatenating gather ``all_gather_single`` and warns
# on the old name, which is all torch 2.11 has
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_stats(x, ax):
    """Every rank's block triples (s, B, C, 3) in the order of ``ax``'s
    index: this rank's stats launch writes its slot of the buffer, the
    gather (in place) the others'."""
    b, c = x.shape[0], x.shape[-1]
    parts = torch.empty((ax.size * b, c, 3), dtype=torch.float32, device=x.device)
    mine = block_stats(x, out=parts[ax.index * b:(ax.index + 1) * b])
    if ax.size > 1:
        with multihost.comm.record("norm", mine):
            _gather_into(parts, mine, group=ax.group)
    return parts.view(ax.size, b, c, 3)


class InstanceNormBlocks(torch.autograd.Function):
    """B3 over the height blocks of a spatial axis ``ax``: statistics of the
    whole image from every rank's block, y this rank's block."""

    @staticmethod
    def forward(ctx, x, gamma, beta, ax):
        y, mean, rstd = block_merge_apply(x, _gather_stats(x, ax), gamma, beta)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.ax = ax
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        ax = ctx.ax
        dy = dy.float()
        xhat = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :]
        dgamma = torch.sum(dy * xhat, dim=(0, 1, 2)).to(gamma.dtype)
        dbeta = torch.sum(dy, dim=(0, 1, 2)).to(gamma.dtype)
        g = dy * gamma.float()
        sums = torch.stack([g.sum(dim=(1, 2)), (g * xhat).sum(dim=(1, 2))])
        if ax.size > 1:
            sums = _all_reduce(sums, [ax])
        count = x.shape[1] * x.shape[2] * ax.size
        mean_g, mean_gx = (sums / count)[:, :, None, None, :].unbind(0)
        dx = rstd[:, None, None, :] * (g - mean_g - xhat * mean_gx)
        return dx.to(x.dtype), dgamma, dbeta, None


def instance_norm_blocks(x, gamma, beta, ax):
    """Instance norm of the images whose rows ``x`` (B, h, W, C) holds, the
    other rows on the other ranks of the spatial axis ``ax`` (a
    ``multihost.Axis``): every (b, c) statistic spans all of them. Equal
    blocks (the spatial path's) on every rank."""
    return InstanceNormBlocks.apply(x.contiguous(), gamma, beta, ax)


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
