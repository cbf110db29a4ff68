"""Diffusion algebra — counterpart of gan_class_transfer2_tpu/core/diffusion.py.

Pure functions over tensors (or Python numbers for ``t``); the expressions
are written in the same order as the JAX copy so that float32 results agree
to rounding. The reference quirks are kept on purpose:

  * In ODE mode the inversion/sampling update only ever changes ``x_theta``;
    ``epsilon_theta`` stays stale (reference train.py:392,462 are dead code).
  * The ODE preview noises at ᾱ(T/2)**0.5 (an extra square root).
  * ``prediction_weighting`` scales both target and prediction by √(1-ᾱ).
"""

from __future__ import annotations

from .schedule import alpha_dash


def _ad(cfg, t):
    return alpha_dash(t, cfg.steps, cfg.schedule)


def forward_diffuse(cfg, x, epsilon, t):
    """q(x_t | x_0): ``x·√ᾱ(t) + ε·√(1-ᾱ(t))`` (reference train.py:231-234)."""
    ad = _ad(cfg, t)
    return x * ad**0.5 + epsilon * (1 - ad) ** 0.5


def training_target(cfg, x, epsilon, t):
    """``(target, prediction_scale)`` for the loss (reference train.py:238-252).
    ᾱ(t) is computed only where the target needs it (``t`` may be None on the
    ``x`` path)."""
    if cfg.parameterization == "ode":
        ad_prev = _ad(cfg, t - 1)
        return x * ad_prev**0.5 + epsilon * (1 - ad_prev) ** 0.5, 1.0
    if cfg.parameterization == "x":
        return x, 1.0
    ad = _ad(cfg, t)
    target = epsilon
    if cfg.parameterization == "scaled_epsilon":
        target = target * (1 - ad) ** 0.5
    if cfg.prediction_weighting:
        return target * (1 - ad) ** 0.5, (1 - ad) ** 0.5
    return target, 1.0


def preview_image_factor(cfg):
    """Noise factor for the single-step preview (reference train.py:325-328)."""
    if cfg.parameterization == "ode":
        return _ad(cfg, cfg.steps / 2) ** 0.5
    return _ad(cfg, cfg.test_step)


def preview_denoise(cfg, noised, prediction):
    """One prediction back to a clean-image estimate (reference train.py:338-355)."""
    if cfg.parameterization == "ode":
        t = cfg.steps / 2
        ad, ad_prev = _ad(cfg, t), _ad(cfg, t - 1)
        return (
            prediction * (1 - ad) ** 0.5 - noised * (1 - ad_prev) ** 0.5
        ) / (ad_prev**0.5 * (1 - ad) ** 0.5 - ad**0.5 * (1 - ad_prev) ** 0.5)
    if cfg.parameterization == "x":
        return prediction
    factor = preview_image_factor(cfg)
    if cfg.parameterization == "epsilon":
        prediction = prediction * (1 - factor) ** 0.5
    return (noised - prediction) / factor**0.5


def step_update(cfg, prediction, fake, epsilon_theta, t):
    """One inversion/sampling update ``(x_θ, ε_θ) ← f(pred, fake, t)``
    (reference train.py:369-413 and 439-479 share it)."""
    ad = _ad(cfg, t)
    if cfg.parameterization == "ode":
        ad_prev = _ad(cfg, t - 1)
        x_theta = (
            prediction * (1 - ad) ** 0.5 - fake * (1 - ad_prev) ** 0.5
        ) / (ad_prev**0.5 * (1 - ad) ** 0.5 - ad**0.5 * (1 - ad_prev) ** 0.5)
        return x_theta, epsilon_theta  # ε_θ intentionally stale
    if cfg.parameterization == "x":
        x_theta = prediction
        epsilon_theta = (fake - ad**0.5 * x_theta) / (1 - ad) ** 0.5
        return x_theta, epsilon_theta
    if cfg.parameterization == "scaled_epsilon":
        epsilon_theta = prediction / (1 - ad) ** 0.5
        scaled_epsilon = prediction
    else:  # epsilon
        epsilon_theta = prediction
        scaled_epsilon = prediction * (1 - ad) ** 0.5
    x_theta = (fake - scaled_epsilon) / ad**0.5
    return x_theta, epsilon_theta


def renoise(cfg, x_theta, epsilon_theta, t):
    """Loop-head remix ``√ᾱ·x_θ + √(1-ᾱ)·ε_θ`` (reference train.py:372-375)."""
    return forward_diffuse(cfg, x_theta, epsilon_theta, t)
