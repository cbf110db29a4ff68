"""Inversion, noise-space edits and reverse-diffusion sampling — counterpart
of gan_class_transfer2_tpu/sample/sampler.py.

Where the JAX package runs each loop as one ``lax.scan``, the port runs a
Python loop of denoiser calls under ``torch.inference_mode()``. Each step
takes its timestep as a float32 scalar, as the scan does, so the schedule
algebra rounds as in the JAX package. ``model`` is a ``models.unet.Denoiser``
or a ``models.conditional.ConditionalDenoiser``, whose ``class_idx`` ((B,)
integers on the batch's device; class 0 when None) every entry point passes
through; ``cfg`` supplies the sampling knobs and the compute dtype.

  (a) ``preview``    — single-step denoise at ``test_step``   (train.py:325-361)
  (b) ``invert``     — t = 1…T ascending DDIM-style encoder   (train.py:364-413)
  (c) ``edit_noise`` — pixelate / shift / VQ-quantise ε̂       (train.py:415-437)
  (d) ``sample``     — t = T…1 reverse diffusion + snapshots  (train.py:439-496)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import diffusion
from ..models import api as model_api
from ..models.unet import DTYPES
from ..ops import image as image_ops


def sample_timesteps(cfg):
    """The reverse-diffusion visit order T, T−s, … under ``cfg.sample_stride``."""
    stride = max(cfg.sample_stride, 1)
    return np.arange(cfg.steps, 0, -stride)


def _f32(t):
    return torch.tensor(float(t), dtype=torch.float32)


def _denoise_call(cfg, model, fake, t, class_idx=None):
    if torch.is_tensor(t):  # a 0-d float32 timestep: made from the input, on its device
        t_vec = t.to(torch.int32).expand(fake.shape[0])
    else:
        t_vec = torch.full((fake.shape[0],), int(t), dtype=torch.int32, device=fake.device)
    return model_api.apply_denoiser(
        cfg, model, fake.to(DTYPES[cfg.compute_dtype]), t_vec, class_idx=class_idx
    ).float()


def step(cfg, model, x_theta, epsilon_theta, t, class_idx=None):
    """One sampler/inversion step at timestep ``t``: re-noise, denoise,
    update (x̂, ε̂). ``t`` is a Python int, or a 0-d float32 tensor on the
    state's device (a bundle's exported step program takes it as an input,
    so that no tensor in its graph is made on a fixed device)."""
    tf = t if torch.is_tensor(t) else _f32(t)
    fake = diffusion.renoise(cfg, x_theta, epsilon_theta, tf)
    prediction = _denoise_call(cfg, model, fake, t, class_idx)
    return diffusion.step_update(cfg, prediction, fake, epsilon_theta, tf)


@torch.inference_mode()
def preview(cfg, model, example_image, noise, class_idx=None):
    """Single-step denoise preview. Returns (denoised, rmse)."""
    factor = diffusion.preview_image_factor(cfg)
    noised = example_image * factor**0.5 + noise * (1 - factor) ** 0.5
    t_vec = torch.full_like(noised[:, 0, 0, 0], cfg.test_step, dtype=torch.int32)
    prediction = model_api.apply_denoiser(cfg, model, noised, t_vec,
                                          class_idx=class_idx).float()
    denoised = diffusion.preview_denoise(cfg, noised, prediction)
    rmse = torch.mean((example_image - denoised) ** 2) ** 0.5
    return denoised, rmse


@torch.inference_mode()
def invert(cfg, model, image, class_idx=None):
    """DDIM-style encoder over t = 1…T. Returns (x̂, ε̂). ε̂ starts as the
    image itself (reference train.py:367, "might be close enough")."""
    x_theta = epsilon_theta = image
    for t in range(1, cfg.steps + 1):
        x_theta, epsilon_theta = step(cfg, model, x_theta, epsilon_theta, t, class_idx)
    return x_theta, epsilon_theta


def apply_edit(name: str, epsilon_theta, dictionary=None):
    """ONE noise-space edit (reference train.py:418-430)."""
    if name == "pixelate":
        return image_ops.upsample_nearest(image_ops.avg_pool(epsilon_theta, 4), 4)
    if name == "shift":
        return image_ops.roll2d(epsilon_theta, 1, 1)
    if name == "quantise":
        return image_ops.vq_quantise(epsilon_theta, dictionary)
    raise ValueError(f"unknown edit {name!r}")


def edit_noise(cfg, epsilon_theta, dictionary, extra_noise):
    """The (2 + 4·B)-image batch [2 pure-noise draws, ε̂, pixelated, shifted,
    VQ-quantised] (reference train.py:415-437)."""
    fake = torch.cat(
        [epsilon_theta]
        + [apply_edit(n, epsilon_theta, dictionary) for n in ("pixelate", "shift", "quantise")],
        0,
    )
    return torch.cat([extra_noise, fake], 0)


class SampleResult(NamedTuple):
    images: torch.Tensor  # final x̂ batch
    snapshots: Optional[torch.Tensor]  # (4, B, H, W, C) at t = T, 3T/4, T/2, T/4


@torch.inference_mode()
def sample(cfg, model, init_batch, class_idx=None, snapshots: bool = True) -> SampleResult:
    """Reverse diffusion over ``sample_timesteps(cfg)``; ``init_batch`` seeds
    both x̂ and ε̂ (train.py:436-437). With snapshots, x̂ is kept at the four
    reference timesteps, each mapped to the nearest visited timestep at or
    below it (the lowest visited one when none is below)."""
    T = cfg.steps
    visited = [int(t) for t in sample_timesteps(cfg)]

    def nearest(s):
        below = [v for v in visited if v <= s]
        return max(below) if below else visited[-1]

    snap_ts = [nearest(s) for s in (T, 3 * T // 4, 2 * T // 4, T // 4)]
    snaps = torch.zeros((4,) + tuple(init_batch.shape), device=init_batch.device) if snapshots else None
    x_theta = epsilon_theta = init_batch
    for t in visited:
        x_theta, epsilon_theta = step(cfg, model, x_theta, epsilon_theta, t, class_idx)
        if snapshots:
            for slot, st in enumerate(snap_ts):
                if st == t:
                    snaps[slot] = x_theta
    return SampleResult(x_theta, snaps)


def make_segment_fn(cfg, class_idx=None, mesh=None):
    """Partial reverse diffusion: ``seg(model, x̂, ε̂, ts)`` advances the state
    over the timesteps ``ts`` (serve/server.py streams with it), conditioned
    on ``class_idx``.

    ``mesh``: the (x̂, ε̂) batch and the class vector are split over the
    mesh and the blocks gathered (``parallel/mesh.make_data_parallel_apply``;
    on a ``LocalMesh`` ``model`` is the list of replicas); the caller pads
    the batch to a multiple of the data extent
    (serve/server.ModelService._pad_bucket)."""
    from ..parallel import mesh as mesh_lib

    def advance(model, x_theta, epsilon_theta, c, ts):
        for t in ts:
            x_theta, epsilon_theta = step(cfg, model, x_theta, epsilon_theta, t, c)
        return x_theta, epsilon_theta

    advance = mesh_lib.make_data_parallel_apply(mesh, advance)

    @torch.inference_mode()
    def seg(model, x_theta, epsilon_theta, ts):
        return advance(model, x_theta, epsilon_theta, class_idx, tuple(int(t) for t in ts))

    return seg


def sample_stream(cfg, model, init_batch, segments: int = 4, class_idx=None):
    """Yields ``segments`` intermediate x̂ states as numpy arrays; the last is
    ``sample(...).images``."""
    seg = make_segment_fn(cfg, class_idx)
    ts_all = sample_timesteps(cfg)
    segments = min(max(int(segments), 1), len(ts_all))
    x_theta = epsilon_theta = init_batch
    for ts in np.array_split(ts_all, segments):
        if len(ts) == 0:
            continue
        x_theta, epsilon_theta = seg(model, x_theta, epsilon_theta, ts)
        yield x_theta.cpu().numpy()


@torch.inference_mode()
def edit_image(cfg, model, image, edits=("pixelate", "shift", "quantise"),
               dictionary=None, generator: torch.Generator | None = None, class_idx=None):
    """Invert a real image to its noise estimate, apply noise-space edits and
    decode each edited noise (reference train.py:364-496). image:
    (B, H, W, 3) in [-1, 1). Returns {edit name: (B, H, W, 3)} plus
    "reconstruction" for the unedited noise. Without ``dictionary`` the VQ
    codebook is drawn from ``generator`` (CPU, seeded with ``cfg.seed`` by
    default). ``class_idx``: the class of each input image, applied to its
    inversion and to each of its decoded candidates."""
    unknown = [e for e in edits if e not in ("pixelate", "shift", "quantise")]
    if unknown:
        raise ValueError(f"unknown edits {unknown}; valid: pixelate, shift, quantise")
    if dictionary is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        dictionary = torch.randn(
            (cfg.size, cfg.size, 2**cfg.bits_per_pixel, 3), generator=generator
        ).to(image.device)
    B = image.shape[0]
    _, epsilon_theta = invert(cfg, model, image, class_idx)
    candidates = {"reconstruction": epsilon_theta}
    for name in ("pixelate", "shift", "quantise"):
        if name in edits:
            candidates[name] = apply_edit(name, epsilon_theta, dictionary)
    names = list(candidates)
    batch = torch.cat([candidates[n] for n in names], 0)
    if class_idx is not None:
        # the candidates decode as one batch in blocks of B: each input
        # image's class applies to its block row
        class_idx = class_idx.reshape(-1)[:B].repeat(len(names))
    decoded = sample(cfg, model, batch, class_idx, snapshots=False).images
    return {n: decoded[i * B : (i + 1) * B] for i, n in enumerate(names)}


def make_eval_fn(cfg):
    """``eval_fn(model, example_image, noise_bank, dictionary)`` → the
    reference's TensorBoard artifacts (denoised, example_loss, fake,
    step_1/0.75/0.5/0.25): preview + invert + edits + sample, in one
    process (``parallel/mesh.sampler_eval`` without a mesh)."""
    from ..parallel import mesh as mesh_lib

    return mesh_lib.sampler_eval(cfg)
