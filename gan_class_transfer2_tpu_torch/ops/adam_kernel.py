"""Fused Adam (B2) — counterpart of gan_class_transfer2_tpu/ops/adam_kernel.py.

One pass per element, in float32 math, of the Keras-form Adam update
(reference train.py:75; train/trainer.py ``_scale_by_adam_tf``)::

    m' = β₁·m + (1−β₁)·g
    v' = β₂·v + (1−β₂)·g²
    p' = p − s·m' / (√v' + ε),   s = lr·√(1−β₂ᵗ)/(1−β₁ᵗ)

with ``s`` computed outside the kernel, as a float32 tensor on the card that
the kernel reads (no host sync). ``p``, ``m`` and ``v`` are updated in place,
as the Pallas kernel's ``input_output_aliases`` do; moments are float32 or
bfloat16 (``moment_dtype``).

The JAX package launches one Pallas kernel per leaf and sends leaves whose
size is not a multiple of 128 to XLA (adam_kernel.py:145-151). The CUDA
kernel (csrc/adam.cu) takes every leaf in one multi-tensor launch (a table
of pointers and sizes passed as the kernel's parameter, at most
``LEAVES_PER_LAUNCH`` leaves each), running the same math on the small
leaves, so no leaf needs another path.

Pieces: ``adam_fused`` (the wrapper, launch counter ``adam_fused.launches``),
``adam_plain`` (``_leaf_update_xla`` in torch, leaf by leaf, in place),
``fused_adam_ok`` (the gate, as in the JAX package) and
``fused_adam_apply`` (one step over the train state's optimizer state).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LEAVES_PER_LAUNCH = 48  # csrc/adam.cu MAX_LEAVES: the table fits the 4 KB parameter space
B1, B2 = 0.9, 0.999


def fused_adam_ok(cfg, mesh_size: int = 1) -> bool:
    """True when the train step may take the fused update: plain Adam, no
    chained clip/decay, no accumulation, no dynamic loss scale, no ZeRO-1,
    and a data-parallel world of one rank (adam_kernel.py:104-117: the
    train step passes its mesh's size). The JAX step also asks for a TPU
    (trainer.py:424-427); here the CPU takes the kernel's plain version."""
    return (
        cfg.optimizer == "adam_fused"
        and cfg.grad_clip_norm <= 0
        and cfg.weight_decay <= 0
        and cfg.grad_accum == 1
        and not cfg.dynamic_loss_scale
        and not cfg.zero1
        and mesh_size == 1
    )


@torch.no_grad()
def adam_plain(params, mus, nus, grads, step_size, eps, b1=B1, b2=B2):
    """``_leaf_update_xla`` (adam_kernel.py:92-101) leaf by leaf, written in
    place into ``params``, ``mus`` and ``nus``. ``step_size``: a float32
    tensor of one element."""
    s = step_size.reshape(()).to(torch.float32)
    for p, m, v, g in zip(params, mus, nus, grads):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1.0 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1.0 - b2) * g32 * g32
        upd = s * m32 / (torch.sqrt(v32) + eps)
        p.copy_((p.to(torch.float32) - upd).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))


_ENTRY = {torch.float32: "gct2_adam_f32m", torch.bfloat16: "gct2_adam_bf16m"}


def _entry(moment_dtype):
    fn = getattr(_build.load("adam"), _ENTRY[moment_dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def adam_fused(params, mus, nus, grads, step_size, eps, b1=B1, b2=B2):
    """B2 over lists of leaves, in place. params and grads float32, mus and
    nus all float32 or all bfloat16, every tensor contiguous and on one
    device; ``step_size`` a float32 tensor of one element on that device."""
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        return adam_plain(params, mus, nus, grads, step_size, eps, b1, b2)
    if dev.type != "cuda":
        raise ValueError(f"adam_fused: no kernel for device {dev}")
    if not len(params) == len(mus) == len(nus) == len(grads):
        raise ValueError("adam_fused: params, mus, nus and grads differ in length")
    mdt = mus[0].dtype
    if mdt not in _ENTRY:
        raise TypeError(f"adam_fused: moments must be float32 or bfloat16, got {mdt}")
    if step_size.dtype != torch.float32 or step_size.numel() != 1 or step_size.device != dev:
        raise ValueError("adam_fused: step_size must be one float32 on the params' device")
    rows = []
    for p, m, v, g in zip(params, mus, nus, grads):
        n = p.numel()
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError("adam_fused: params and grads must be float32")
        if m.dtype != mdt or v.dtype != mdt:
            raise TypeError("adam_fused: all moments must share one dtype")
        for t in (p, m, v, g):
            if t.device != dev or not t.is_contiguous() or t.numel() != n:
                raise ValueError("adam_fused: leaves must be contiguous, same size, one device")
        rows.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), n))
    fn = _entry(mdt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(0, len(rows), LEAVES_PER_LAUNCH):
        chunk = rows[i : i + LEAVES_PER_LAUNCH]
        flat = [v for row in chunk for v in row]
        table = (ctypes.c_longlong * len(flat))(*flat)
        with torch.cuda.device(dev):
            err = fn(len(chunk), table, step_size.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2,
                     eps, stream)
        if err != 0:
            raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
        _build.count(adam_fused)


adam_fused.launches = 0


def launches_per_step(n_leaves: int) -> int:
    """Kernel launches of one ``adam_fused`` call over ``n_leaves`` leaves."""
    return -(-n_leaves // LEAVES_PER_LAUNCH)


def step_size(count, lr, b1=B1):
    """``lr·√(1−β₂ᵗ)/(1−β₁ᵗ)`` in float32 with t = count + 1
    (adam_kernel.py:133-137); ``count`` an int32 tensor on the card, ``lr``
    the schedule's float32 tensor."""
    t = (count + 1).to(torch.float32)
    lr = lr.to(torch.float32)
    alpha = torch.sqrt(1.0 - torch.pow(B2, t)) / (1.0 - torch.pow(b1, t))
    return (lr * alpha).to(torch.float32).reshape(1)


def fused_adam_apply(cfg, params, opt_state, grads):
    """One fused Adam step. ``opt_state`` is the port's form of the optax
    chain state of adam_fused/adam_tf, ``(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))``; params and moments are updated in place
    and the state with both counts advanced is returned."""
    from ..core.schedule import make_lr_schedule

    adam_st, sched_st = opt_state
    s = step_size(adam_st.count, make_lr_schedule(cfg)(sched_st.count), cfg.adam_b1)
    adam_fused(params, adam_st.mu, adam_st.nu, grads, s, cfg.adam_eps, cfg.adam_b1)
    return (adam_st._replace(count=adam_st.count + 1),
            sched_st._replace(count=sched_st.count + 1))
