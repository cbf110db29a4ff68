"""Noise schedules — counterpart of gan_class_transfer2_tpu/core/schedule.py.

``alpha_dash`` takes a Python number or a tensor. On a tensor it computes in
the tensor's dtype (the samplers pass float32 timesteps, as the JAX sampler
does under ``lax.scan``); on a Python number in Python floats, except that
``cosine2`` evaluates its cosine in float32, as ``jnp.cos`` does. The learning
rate schedules come with the training slice.
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
