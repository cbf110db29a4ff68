"""Noise schedules — counterpart of gan_class_transfer2_tpu/core/schedule.py.

``alpha_dash`` takes a Python number or a tensor. On a tensor it computes in
the tensor's dtype (the samplers pass float32 timesteps, as the JAX sampler
does under ``lax.scan``); on a Python number in Python floats, except that
``cosine2`` evaluates its cosine in float32, as ``jnp.cos`` does.

The learning-rate schedules (schedule.py:50-126) map an optimizer count (an
int32 tensor, or a Python int) to a float32 tensor on the count's device, in
the JAX copy's float32 arithmetic.
"""

from __future__ import annotations

import math

import torch


def alpha_dash(t, steps: int, schedule: str = "quadratic"):
    """Cumulative signal fraction ᾱ(t) for diffusion timestep ``t``
    (reference train.py:85-93). Continuous in t."""
    s = t / (steps + 1)
    if schedule == "quadratic":  # reference train.py:93 (active)
        return (1 - s) ** 2 * 0.25
    if schedule == "exponential":  # reference train.py:88
        return 1 - 2 ** (s - 1)
    if schedule == "rational_exponential":  # reference train.py:89
        # (256 - u) / (255·u + 256) with u = 2**(8**s) — see the JAX copy
        u = 2.0 ** (8.0**s)
        return (256.0 - u) / (255.0 * u + 256.0)
    if schedule == "geometric":  # reference train.py:90
        return (256.0 * 256.0) ** (-1.0 * s)
    if schedule == "cosine2":  # reference train.py:91
        angle = math.pi / 2 * s
        if not torch.is_tensor(angle):
            angle = torch.tensor(angle, dtype=torch.float32)
        return torch.cos(angle) ** 2
    if schedule == "quartic":  # reference train.py:92
        return (1 - s) ** 4
    raise ValueError(f"unknown schedule {schedule!r}")


def _count(count):
    return torch.as_tensor(count).to(torch.float32)


def warmup_schedule(base: float, warmup_steps: int):
    """Linear warmup (reference train.py:50-65): ``base·(count+1)/(warm+1)``
    below ``warmup_steps``, then ``base``."""

    def schedule(count):
        c = _count(count)
        ramp = base * (c + 1.0) / (warmup_steps + 1.0)
        return torch.where(c < warmup_steps, ramp, torch.full_like(c, base))

    return schedule


def inverse_time_decay_schedule(base: float, decay_steps: int, decay_rate: float = 1.0):
    """InverseTimeDecay (reference train.py:68-70)."""

    def schedule(count):
        return base / (1.0 + decay_rate * _count(count) / decay_steps)

    return schedule


def constant_schedule(base: float):
    def schedule(count):
        return torch.full_like(_count(count), base)

    return schedule


def warmup_cosine_schedule(base: float, warmup_steps: int, total_steps: int):
    """The warmup ramp, then cosine decay to zero at ``total_steps``."""

    def schedule(count):
        c = _count(count)
        ramp = base * (c + 1.0) / (warmup_steps + 1.0)
        span = max(total_steps - warmup_steps, 1)
        frac = torch.clip((c - warmup_steps) / span, 0.0, 1.0)
        cos = base * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(c < warmup_steps, ramp, cos)

    return schedule


def make_lr_schedule(cfg):
    """The schedule named by ``cfg.lr_schedule``. Under ``grad_accum > 1``
    every schedule counts applied optimizer updates (the optimizer advances
    its count only when the accumulation window closes), so ``warm_up`` and
    ``inverse_time_decay_steps`` are in applied updates; only the cosine
    horizon, ``epochs·steps_per_epoch`` micro-steps, is divided by
    ``grad_accum`` (schedule.py:98-125)."""
    if cfg.lr_schedule == "warmup":
        return warmup_schedule(cfg.learning_rate, cfg.warm_up)
    if cfg.lr_schedule == "inverse_time_decay":
        return inverse_time_decay_schedule(cfg.learning_rate, cfg.inverse_time_decay_steps)
    if cfg.lr_schedule == "constant":
        return constant_schedule(cfg.learning_rate)
    if cfg.lr_schedule == "cosine":
        accum = max(cfg.grad_accum, 1)
        return warmup_cosine_schedule(
            cfg.learning_rate, cfg.warm_up, cfg.epochs * cfg.steps_per_epoch // accum
        )
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
