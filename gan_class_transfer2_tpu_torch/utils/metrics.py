"""Sample-quality metrics: Fréchet distance (FID-style), KID (unbiased
MMD²), PSNR, RMSE — counterpart of gan_class_transfer2_tpu/utils/metrics.py.

The embedding is the pinned trained extractor (``utils/fid_extractor.py``)
when its weights are present, else a fixed-seed random-conv projection;
any callable ``images -> (N, D)`` can be plugged in. Features are extracted
in batches on ``device`` (the card unless the caller asks for the CPU) and
come back as float64 numpy; the statistics, ``sqrtm`` and the KID are the
JAX module's numpy and scipy code, line for line.

What differs from the JAX module, and why:

  * ``random_conv_features`` draws its kernels from a seeded
    ``torch.Generator``: ``jax.random`` cannot be reproduced, so the two
    packages' ``random`` scores differ unless the JAX kernels are carried
    across with ``random_feature_params_from_numpy``.
  * ``inception:`` / ``inception-tv:`` extractors are ``utils/inception.py``'s
    pool3 features of the named weights file, on the device the metric
    runs on.

The Fréchet distance is exact: ``|μ₁−μ₂|² + tr(Σ₁+Σ₂−2·(Σ₁Σ₂)^{1/2})``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..models.api import resolve_device
from ..models.unet import ieee_fp32
from ..ops import conv as conv_ops
from ..ops import init as init_ops

# ------------------------------------------------------- feature extractor ---


@functools.lru_cache(maxsize=4)
def random_feature_params(depth: int = 4, width: int = 32, seed: int = 0) -> tuple:
    """The random extractor's 4×4 HWIO kernels (CPU float32), Glorot draws
    from ``torch.Generator().manual_seed(seed)`` (cached)."""
    generator = torch.Generator().manual_seed(seed)
    params, c = [], 3
    for i in range(depth):
        f = min(width * 2**i, 256)
        params.append(init_ops.conv_kernel(generator, 4, 4, c, f))
        c = f
    return tuple(params)


def random_feature_params_from_numpy(kernels) -> tuple:
    """Kernels given as numpy arrays — JAX's ``_random_feature_params(depth,
    width, seed)`` carried across — as the ``params`` of
    ``random_conv_features``; each (4, 4, C, F) with C the previous F."""
    out, c = [], 3
    for k in kernels:
        k = np.asarray(k, np.float32)
        if k.ndim != 4 or k.shape[:2] != (4, 4) or k.shape[2] != c:
            raise ValueError(f"kernel {k.shape}: expected (4, 4, {c}, F)")
        out.append(torch.from_numpy(k.copy()))
        c = k.shape[3]
    return tuple(out)


@torch.inference_mode()
def random_conv_features(images, depth: int = 4, width: int = 32, seed: int = 0,
                         params=None):
    """Fixed random strided conv net → global-avg-pooled features (N, D), on
    the images' device. images: (N, H, W, 3) float32 in [−1, 1)."""
    params = random_feature_params(depth, width, seed) if params is None else params
    h = images.to(torch.float32)
    with ieee_fp32(torch.float32, h.device):
        for k in params:
            h = conv_ops.conv2d(h, k.to(h.device), stride=2, relu=True)
        return h.mean(dim=(1, 2))


# ---------------------------------------------------------------- Fréchet ---


def _sqrtm_psd_product(s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """(Σ₁Σ₂)^{1/2} via scipy with PSD cleanup.

    Tiny imaginary components are normal numerical noise on a
    near-singular product and are discarded; LARGE ones mean sqrtm did
    not converge and the score would be silently wrong — rejected, as the
    reference FID implementations do."""
    import scipy.linalg

    out = scipy.linalg.sqrtm(s1 @ s2)  # scipy>=1.17 returns the matrix alone
    covmean = out[0] if isinstance(out, tuple) else out
    if np.iscomplexobj(covmean):
        scale = max(float(np.abs(covmean.real).max()), 1.0)
        imag = float(np.abs(covmean.imag).max())
        if imag > 1e-3 * scale:
            raise ValueError(
                f"matrix sqrt did not converge (max imaginary component "
                f"{imag:.3g}); the eval sets are too small or degenerate "
                "for a meaningful FID — raise fid_samples or use KID"
            )
        covmean = covmean.real
    return covmean


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm_psd_product(sigma1, sigma2)
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def _stats(feats: np.ndarray, ridge: float = 1e-6):
    mu = feats.mean(0)
    sigma = np.atleast_2d(np.cov(feats, rowvar=False))
    # few-sample covariances are rank-deficient; the standard ridge keeps
    # sqrtm well-conditioned without visibly moving the score
    sigma = sigma + ridge * np.eye(sigma.shape[0])
    return mu, sigma


def get_extractor(name: str = "auto") -> Callable:
    """Resolve a named feature extractor.

    ``trained``: the pinned committed classifier (utils/fid_extractor.py);
    ``random``: the fixed-seed random-conv projection;
    ``auto``: trained when its weights file exists, else random;
    ``inception:<path>``: InceptionV3 pool3 (utils/inception.py) of a
    standard state-dict file (.pth/.npz), the FID papers publish;
    ``inception-tv:<path>``: the same weights, stock torchvision pooling."""
    from . import fid_extractor

    if name.startswith("inception:") or name.startswith("inception-tv:"):
        from . import inception

        kind, _, path = name.partition(":")
        return inception.features_from_file(
            path, variant="fid" if kind == "inception" else "torchvision")
    if name == "auto":
        name = "trained" if fid_extractor.available() else "random"
    if name == "trained":
        return fid_extractor.trained_features
    if name == "random":
        return random_conv_features
    raise ValueError(
        f"unknown extractor {name!r} "
        "(trained | random | auto | inception:<path> | inception-tv:<path>)"
    )


def _features(images, extractor: Callable, batch_size: int, min_images: int = 1,
              device="cuda") -> np.ndarray:
    """``extractor`` over ``images`` (numpy or tensor, (N, H, W, 3)) in
    batches on ``device``; (N, D) float64 numpy."""
    if len(images) < min_images:
        # guard BEFORE extraction: an empty set would die inside
        # np.concatenate with an opaque error
        raise ValueError(
            f"need >= {min_images} images per set, got {len(images)}"
        )
    dev = resolve_device(device)
    out = []
    for i in range(0, len(images), batch_size):
        chunk = torch.as_tensor(images[i: i + batch_size]).to(dev, torch.float32)
        out.append(torch.as_tensor(extractor(chunk)).detach().cpu().numpy())
    return np.concatenate(out, 0).astype(np.float64)


def fid(images_a, images_b, extractor: Optional[Callable] = None, batch_size: int = 64,
        device="cuda") -> float:
    """FID-style score between two image sets ((N, H, W, 3) in [−1, 1))."""
    extractor = extractor or get_extractor("auto")
    if len(images_a) < 2 or len(images_b) < 2:
        # np.cov on a single row silently produces a nonsense scalar
        raise ValueError(
            f"fid needs >= 2 images per set, got {len(images_a)} and "
            f"{len(images_b)}"
        )
    mu_a, s_a = _stats(_features(images_a, extractor, batch_size, device=device))
    mu_b, s_b = _stats(_features(images_b, extractor, batch_size, device=device))
    return frechet_distance(mu_a, s_a, mu_b, s_b)


# --------------------------------------------------------------------- KID ---


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kid(images_a, images_b, extractor: Optional[Callable] = None, batch_size: int = 64,
        device="cuda") -> float:
    """Kernel Inception Distance: the unbiased MMD² between the two feature
    sets under the polynomial kernel k(x,y) = (xᵀy/d + 1)³ (Bińkowski et
    al., 2018), over the embedding FID uses. Matched distributions score
    ≈ 0 at any set size, so KID compares across eval-set sizes where the
    biased FID estimator does not."""
    extractor = extractor or get_extractor("auto")
    x = _features(images_a, extractor, batch_size, min_images=2, device=device)
    y = _features(images_b, extractor, batch_size, min_images=2, device=device)
    return _kid_from_features(x, y)


def _kid_from_features(x: np.ndarray, y: np.ndarray) -> float:
    n, m = len(x), len(y)
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    sum_off_xx = kxx.sum() - np.trace(kxx)
    sum_off_yy = kyy.sum() - np.trace(kyy)
    return float(
        sum_off_xx / (n * (n - 1))
        + sum_off_yy / (m * (m - 1))
        - 2.0 * kxy.mean()
    )


def extract_features(images, extractor: Optional[Callable] = None, batch_size: int = 64,
                     device="cuda") -> np.ndarray:
    """An image set's embedding, to pass as ``features_b`` to
    :func:`fid_and_kid` when the set is fixed across calls (the runners
    re-score against the same held-out sets every epoch). Must use the
    same extractor as the comparison call."""
    extractor = extractor or get_extractor("auto")
    return _features(images, extractor, batch_size, device=device)


def fid_and_kid(images_a, images_b, extractor: Optional[Callable] = None,
                batch_size: int = 64, features_b: Optional[np.ndarray] = None,
                device="cuda") -> dict:
    """Both quality scores from one extraction pass per image set.

    ``features_b``: precomputed :func:`extract_features` of ``images_b``
    (which is then ignored) — for fixed reference sets scored repeatedly."""
    extractor = extractor or get_extractor("auto")
    x = _features(images_a, extractor, batch_size, min_images=2, device=device)
    y = (
        np.asarray(features_b, np.float64)
        if features_b is not None
        else _features(images_b, extractor, batch_size, min_images=2, device=device)
    )
    if len(y) < 2:  # precomputed features_b skips the in-extractor guard
        raise ValueError(f"need >= 2 images per set, got {len(y)}")
    mu_a, s_a = _stats(x)
    mu_b, s_b = _stats(y)
    return {
        "fid": frechet_distance(mu_a, s_a, mu_b, s_b),
        "kid": _kid_from_features(x, y),
    }


# ------------------------------------------------------------ pixel metrics ---


def rmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b, data_range: float = 2.0) -> float:
    """PSNR in dB; default data_range=2 for images in [−1, 1)."""
    e = rmse(a, b)
    if e == 0:
        return float("inf")
    return float(20.0 * np.log10(data_range / e))
