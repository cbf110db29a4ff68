"""Plain diffusion pieces: the quadratic schedule, the reference's augment,
the step's draws, the Philox normals of the fused noising, Adam in both
forms, and the x-parameterised reverse-diffusion sampler
(relgukxilef/GAN-Class-Transfer2 train.py:85-93, 217-280, 288-292, 439-496).

The train step's randomness comes from a ``torch.Generator`` that the
benchmark seeds and hands to the program. ``draw_step`` makes the same draws
from a generator seeded alike, in the order the step documents: the crop
rows, columns and flips of the augment, the timesteps t ∈ [1, T], then one
int64 seed for the noise. The noise ε is Philox4x32-10 keyed by that seed
(the published counter scheme of the port's fused noising, restated here in
int64 arithmetic): a different draw or a different ε in the program shows
as a different loss.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
B1, B2 = 0.9, 0.999


def alpha_dash(t, steps, schedule="quadratic"):
    s = t / (steps + 1)
    if schedule != "quadratic":
        raise NotImplementedError(f"reference schedule {schedule!r}")
    return (1 - s) ** 2 * 0.25


def warmup_lr(base, warm_up, count):
    """The learning rate at optimizer count ``count`` (0 for the first step)."""
    return base * (count + 1.0) / (warm_up + 1.0) if count < warm_up else base


def draw_augment(b, h, w, size, g):
    rows = torch.randint(0, h - size + 1, (b,), generator=g, device=g.device)
    cols = torch.randint(0, w - size + 1, (b,), generator=g, device=g.device)
    flips = torch.randint(0, 2, (b,), generator=g, device=g.device) == 1
    return rows, cols, flips


def augment(raw, rows, cols, flips, size):
    """raw (B, H, W, 3) uint8 → (B, size, size, 3) float32 in [−1, 1): the
    crop at (row, col), flipped along W where ``flips``, ·1/128 − 1, one
    sample at a time."""
    out = []
    for i in range(raw.shape[0]):
        r, c = int(rows[i]), int(cols[i])
        crop = raw[i, r:r + size, c:c + size].to(torch.float32)
        if bool(flips[i]):
            crop = torch.flip(crop, (1,))
        out.append(crop / 128.0 - 1.0)
    return torch.stack(out)


def draw_step(b, steps, g):
    """The timesteps (B,) int64 and the int64 noise seed of one step."""
    t = torch.randint(1, steps + 1, (b, 1, 1, 1), generator=g, device=g.device,
                      dtype=torch.int32)
    seed = torch.randint(0, 2**62, (1,), generator=g, device=g.device, dtype=torch.int64)
    return t.reshape(b).long(), int(seed)


def _mulhilo(m, x):
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    t = ml * xl
    mid = mh * xl + ml * xh + (t >> 16)
    return mh * xh + (mid >> 16), ((mid & 0xFFFF) << 16) | (t & 0xFFFF)


def philox_normal(sample_ids, n, seed, device):
    """(len(sample_ids), n) float32 normals: element 4g + 2·half + j of
    sample s from Philox4x32-10 block (g, s, half, 0) under key (seed low
    word, seed high word), words (2j, 2j + 1) through Box–Muller."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    g = torch.arange(n // 4, device=device, dtype=torch.int64)[None, :, None]
    s = torch.as_tensor(sample_ids, device=device, dtype=torch.int64)[:, None, None]
    half = torch.arange(2, device=device, dtype=torch.int64)[None, None, :]
    c0, c1, c2, c3 = g + 0 * s + 0 * half, s + 0 * g + 0 * half, half + 0 * g + 0 * s, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0

    def normal(a, b):
        u1 = (a >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
        u2 = (b >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)

    eps = torch.stack([normal(c0, c1), normal(c2, c3)], -1)
    return eps.reshape(len(sample_ids), n)


def fold_seed(seed: int, position: int) -> int:
    """The seed of data rank ``position``: its low word XORed with
    (position + 1)·0x9E3779B9 mod 2³², the high word kept."""
    return seed ^ (((position + 1) * _W0) & _MASK32)


def noise_batch(x, t, seed, steps, schedule="quadratic", sample_ids=None):
    """x (B, H, W, 3) float32 → √ᾱ(t)·x + √(1 − ᾱ(t))·ε, ε of ``philox_normal``."""
    b = x.shape[0]
    ids = range(b) if sample_ids is None else sample_ids
    eps = philox_normal(list(ids), x[0].numel(), seed, x.device).reshape(x.shape)
    ad = alpha_dash(t.to(torch.float32), steps, schedule)
    ss, sn = torch.sqrt(ad), torch.sqrt(1.0 - ad)
    return x * ss[:, None, None, None] + eps * sn[:, None, None, None]


class Adam:
    """Adam over a dict of float32 leaves. ``keras=True``: the Keras form
    (ε after √v, bias corrections folded into α = √(1−β₂ᵗ)/(1−β₁ᵗ));
    otherwise optax's (ε after √v̂). Learning rate: the linear warm-up."""

    def __init__(self, params, lr, warm_up, eps, keras):
        self.lr, self.warm_up, self.eps, self.keras = lr, warm_up, eps, keras
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        lr = warmup_lr(self.lr, self.warm_up, self.count)
        self.count += 1
        t = self.count
        for k, g in grads.items():
            m = self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            v = self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            if self.keras:
                alpha = (1 - B2**t) ** 0.5 / (1 - B1**t)
                upd = lr * alpha * m / (torch.sqrt(v) + self.eps)
            else:
                upd = lr * (m / (1 - B1**t)) / (torch.sqrt(v / (1 - B2**t)) + self.eps)
            params[k] = params[k] - upd


def sample_x(cfg, denoise, init):
    """Reverse diffusion t = T … 1 with the x parameterisation
    (train.py:439-479): x̂ = ε̂ = init; each step re-noises
    √ᾱ·x̂ + √(1−ᾱ)·ε̂, predicts x̂ = denoise(fake), ε̂ = (fake − √ᾱ·x̂)/√(1−ᾱ).
    ``denoise``: NHWC float32 → NHWC float32. Returns the final x̂."""
    x_theta = eps_theta = init
    for t in range(cfg.steps, 0, -1):
        ad = alpha_dash(torch.tensor(float(t), dtype=torch.float32), cfg.steps, cfg.schedule)
        fake = x_theta * ad**0.5 + eps_theta * (1 - ad) ** 0.5
        x_theta = denoise(fake)
        eps_theta = (fake - ad**0.5 * x_theta) / (1 - ad) ** 0.5
    return x_theta
