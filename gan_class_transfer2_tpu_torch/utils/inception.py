"""InceptionV3 pool3 features, the standard FID embedding — counterpart of
gan_class_transfer2_tpu/utils/inception.py.

``--fid-extractor inception:<path>`` (or ``inception-tv:<path>``) scores
with the 2048-d pool3 activations of an InceptionV3 state dict, as FID is
defined (Heusel et al. 2017), so scores compare with published ones once
standard weights are on the machine. No InceptionV3 weights are in the
repository; ``synthetic_state_dict`` draws a random state dict with the
exact torchvision key set and shapes, which the tests and the card's smoke
run load.

Accepted weight files (by extension): ``.pth`` / ``.pt``, a torch
``state_dict`` with torchvision ``inception_v3`` module names (torchvision's
``inception_v3_google-*.pth`` and pytorch-fid's ``pt_inception-*.pth``
alike), read with ``torch.load(weights_only=True)``; ``.npz``, the same keys
as a numpy archive, conv kernels OIHW or HWIO (told apart per array from
the shape table). Each conv's BatchNorm (ε = 1e-3) is folded into the
kernel and a bias at load time.

Variants (pooling only; the weights are shared): ``"fid"`` (default) is
pytorch-fid's network, every InceptionA/C/E branch pool an average that
excludes the padding and Mixed_7c's branch pool a 3×3 max pool;
``"torchvision"`` keeps the stock pooling.

What differs from the JAX module, and why:

  * The folded kernels are OIHW torch tensors and the forward runs NCHW
    through ``F.conv2d`` (cuDNN on the card); JAX keeps HWIO and NHWC. The
    features are the same function of the same NHWC input.
  * The forward runs in IEEE float32 (``models/unet.ieee_fp32``): JAX runs
    its convs at HIGHEST precision, and cuDNN's TF32 would move the
    features.
  * The resize to 299² is ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)``, which equals
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
    widened triangle filter when it downsamples.
  * The folded parameters are cached per file and per device; JAX caches
    them per file and passes them to its jit as arguments.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import ieee_fp32

INPUT_SIZE = 299
POOL3_DIM = 2048
BN_EPS = 1e-3

# ---------------------------------------------------------------- spec table ---

# Each BasicConv2d: name -> (cin, cout, (kh, kw), (sh, sw), (ph, pw)), with
# torchvision.models.inception_v3's module names.


def _conv_specs() -> dict:
    specs = {}

    def c(name, cin, cout, k, s=(1, 1), p=(0, 0)):
        specs[name] = (cin, cout, k, s, p)

    # stem
    c("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2))
    c("Conv2d_2a_3x3", 32, 32, (3, 3))
    c("Conv2d_2b_3x3", 32, 64, (3, 3), p=(1, 1))
    c("Conv2d_3b_1x1", 64, 80, (1, 1))
    c("Conv2d_4a_3x3", 80, 192, (3, 3))

    def inception_a(prefix, cin, pool_features):
        c(f"{prefix}.branch1x1", cin, 64, (1, 1))
        c(f"{prefix}.branch5x5_1", cin, 48, (1, 1))
        c(f"{prefix}.branch5x5_2", 48, 64, (5, 5), p=(2, 2))
        c(f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1))
        c(f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), p=(1, 1))
        c(f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), p=(1, 1))
        c(f"{prefix}.branch_pool", cin, pool_features, (1, 1))
        return 64 + 64 + 96 + pool_features

    def inception_b(prefix, cin):
        c(f"{prefix}.branch3x3", cin, 384, (3, 3), (2, 2))
        c(f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1))
        c(f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), p=(1, 1))
        c(f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), (2, 2))
        return 384 + 96 + cin

    def inception_c(prefix, cin, c7):
        c(f"{prefix}.branch1x1", cin, 192, (1, 1))
        c(f"{prefix}.branch7x7_1", cin, c7, (1, 1))
        c(f"{prefix}.branch7x7_2", c7, c7, (1, 7), p=(0, 3))
        c(f"{prefix}.branch7x7_3", c7, 192, (7, 1), p=(3, 0))
        c(f"{prefix}.branch7x7dbl_1", cin, c7, (1, 1))
        c(f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0))
        c(f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3))
        c(f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0))
        c(f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3))
        c(f"{prefix}.branch_pool", cin, 192, (1, 1))
        return 768

    def inception_d(prefix, cin):
        c(f"{prefix}.branch3x3_1", cin, 192, (1, 1))
        c(f"{prefix}.branch3x3_2", 192, 320, (3, 3), (2, 2))
        c(f"{prefix}.branch7x7x3_1", cin, 192, (1, 1))
        c(f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3))
        c(f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0))
        c(f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), (2, 2))
        return 320 + 192 + cin

    def inception_e(prefix, cin):
        c(f"{prefix}.branch1x1", cin, 320, (1, 1))
        c(f"{prefix}.branch3x3_1", cin, 384, (1, 1))
        c(f"{prefix}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1))
        c(f"{prefix}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0))
        c(f"{prefix}.branch3x3dbl_1", cin, 448, (1, 1))
        c(f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), p=(1, 1))
        c(f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1))
        c(f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0))
        c(f"{prefix}.branch_pool", cin, 192, (1, 1))
        return 320 + 384 * 2 + 384 * 2 + 192

    n = inception_a("Mixed_5b", 192, 32)   # 256
    n = inception_a("Mixed_5c", n, 64)     # 288
    n = inception_a("Mixed_5d", n, 64)     # 288
    n = inception_b("Mixed_6a", n)         # 768
    n = inception_c("Mixed_6b", n, 128)
    n = inception_c("Mixed_6c", n, 160)
    n = inception_c("Mixed_6d", n, 160)
    n = inception_c("Mixed_6e", n, 192)
    n = inception_d("Mixed_7a", n)         # 1280
    n = inception_e("Mixed_7b", n)         # 2048
    n = inception_e("Mixed_7c", n)         # 2048
    if n != POOL3_DIM:
        raise AssertionError(f"the spec table ends at {n} channels, not {POOL3_DIM}")
    return specs


CONV_SPECS = _conv_specs()


def synthetic_state_dict(seed: int = 0) -> dict:
    """A random state dict (numpy float32) with the exact torchvision key
    set and shapes, the JAX module's draws from ``np.random.default_rng(seed)``
    — for the loader and forward where no real weights exist."""
    r = np.random.default_rng(seed)
    sd = {}
    for name, (cin, cout, (kh, kw), _, _) in CONV_SPECS.items():
        sd[f"{name}.conv.weight"] = r.normal(0, 0.05, (cout, cin, kh, kw)).astype(np.float32)
        sd[f"{name}.bn.weight"] = r.uniform(0.5, 1.5, cout).astype(np.float32)
        sd[f"{name}.bn.bias"] = r.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = r.normal(0, 0.1, cout).astype(np.float32)
        sd[f"{name}.bn.running_var"] = r.uniform(0.5, 1.5, cout).astype(np.float32)
    return sd


# ------------------------------------------------------------------- loader ---


def _fold_bn(kernel_oihw, gamma, beta, mean, var):
    """Inference BatchNorm folded into (OIHW kernel, bias):
    γ·(conv(x) − μ)/√(σ²+ε) + β = conv(x)·s + (β − μ·s), s = γ/√(σ²+ε)
    per output channel."""
    scale = gamma / np.sqrt(var + BN_EPS)
    k = kernel_oihw * scale[:, None, None, None]
    bias = beta - mean * scale
    return k.astype(np.float32), bias.astype(np.float32)


def load_params(path: str) -> dict:
    """Load and fold an InceptionV3 state dict (.pth/.pt or .npz). Unknown
    keys (``fc.*``, ``AuxLogits.*``) are ignored; a missing or wrongly shaped
    conv or BN tensor raises, naming the key."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pth", ".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):  # a full module was saved
            sd = sd.state_dict()
        sd = {k: v.numpy() for k, v in sd.items()}
    elif ext == ".npz":
        sd = dict(np.load(path))
    else:
        raise ValueError(f"unsupported weight format {ext!r} (want .pth/.pt/.npz): {path}")
    return fold_state_dict(sd)


def fold_state_dict(sd: dict) -> dict:
    """{conv name: {"kernel": OIHW float32 tensor, "bias": (O,)}} on the CPU,
    BatchNorm folded; a kernel may come OIHW or HWIO."""
    params = {}
    for name, (cin, cout, (kh, kw), _, _) in CONV_SPECS.items():
        try:
            kernel = np.asarray(sd[f"{name}.conv.weight"], np.float32)
            gamma = np.asarray(sd[f"{name}.bn.weight"], np.float32)
            beta = np.asarray(sd[f"{name}.bn.bias"], np.float32)
            mean = np.asarray(sd[f"{name}.bn.running_mean"], np.float32)
            var = np.asarray(sd[f"{name}.bn.running_var"], np.float32)
        except KeyError as e:
            raise ValueError(f"state dict is missing {e.args[0]!r}") from None
        if kernel.shape == (kh, kw, cin, cout) and kernel.shape != (cout, cin, kh, kw):
            kernel = np.transpose(kernel, (3, 2, 0, 1))  # HWIO npz -> OIHW
        if kernel.shape != (cout, cin, kh, kw):
            raise ValueError(
                f"{name}.conv.weight: expected OIHW {(cout, cin, kh, kw)} "
                f"(or HWIO), got {kernel.shape}"
            )
        for arr, label in ((gamma, "weight"), (beta, "bias"),
                           (mean, "running_mean"), (var, "running_var")):
            if arr.shape != (cout,):
                raise ValueError(f"{name}.bn.{label}: expected {(cout,)}, got {arr.shape}")
        k, b = _fold_bn(kernel, gamma, beta, mean, var)
        params[name] = {"kernel": torch.from_numpy(k), "bias": torch.from_numpy(b)}
    return params


# ------------------------------------------------------------------ forward ---
# NCHW inside: (N, C, H, W) float32.


def _conv(params, name, x):
    _, _, _, stride, padding = CONV_SPECS[name]
    p = params[name]
    return F.relu(F.conv2d(x, p["kernel"], p["bias"], stride=stride, padding=padding))


def _branch_avg_pool(x, fid_variant: bool):
    # pytorch-fid sets count_include_pad=False on every branch-pool average
    # (FIDInceptionA/C/E_1); torchvision keeps the default True
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid_variant)


def _mixed_a(params, prefix, x, fid_variant):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b5 = _conv(params, f"{prefix}.branch5x5_2", _conv(params, f"{prefix}.branch5x5_1", x))
    b3 = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_2", b3)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_3", b3)
    bp = _conv(params, f"{prefix}.branch_pool", _branch_avg_pool(x, fid_variant))
    return torch.cat([b1, b5, b3, bp], 1)


def _mixed_b(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3", x)
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd)
    bd = _conv(params, f"{prefix}.branch3x3dbl_3", bd)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


def _mixed_c(params, prefix, x, fid_variant):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b7 = _conv(params, f"{prefix}.branch7x7_1", x)
    b7 = _conv(params, f"{prefix}.branch7x7_2", b7)
    b7 = _conv(params, f"{prefix}.branch7x7_3", b7)
    bd = _conv(params, f"{prefix}.branch7x7dbl_1", x)
    for i in (2, 3, 4, 5):
        bd = _conv(params, f"{prefix}.branch7x7dbl_{i}", bd)
    bp = _conv(params, f"{prefix}.branch_pool", _branch_avg_pool(x, fid_variant))
    return torch.cat([b1, b7, bd, bp], 1)


def _mixed_d(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3_2", _conv(params, f"{prefix}.branch3x3_1", x))
    b7 = _conv(params, f"{prefix}.branch7x7x3_1", x)
    for i in (2, 3, 4):
        b7 = _conv(params, f"{prefix}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


def _mixed_e(params, prefix, x, pool: str, fid_variant: bool):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b3 = _conv(params, f"{prefix}.branch3x3_1", x)
    b3 = torch.cat([_conv(params, f"{prefix}.branch3x3_2a", b3),
                    _conv(params, f"{prefix}.branch3x3_2b", b3)], 1)
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd)
    bd = torch.cat([_conv(params, f"{prefix}.branch3x3dbl_3a", bd),
                    _conv(params, f"{prefix}.branch3x3dbl_3b", bd)], 1)
    if pool == "max":  # FIDInceptionE_2 (Mixed_7c under variant="fid")
        pooled = F.max_pool2d(x, 3, 1, 1)
    else:
        pooled = _branch_avg_pool(x, fid_variant)
    bp = _conv(params, f"{prefix}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], 1)


def _resize_to_input(x):
    """NCHW float32 resized to 299² as ``jax.image.resize(..., "bilinear")``
    does (a no-op at 299²)."""
    if x.shape[2] == INPUT_SIZE and x.shape[3] == INPUT_SIZE:
        return x
    return F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                         align_corners=False, antialias=True)


@torch.inference_mode()
def pool3_features(params, x, variant: str = "fid"):
    """(N, H, W, 3) images in [−1, 1) → (N, 2048) pool3 activations, on the
    images' device (``params`` there too). Any H, W: resized to 299² first
    (pytorch-fid's resize_input=True); [−1, 1) is pytorch-fid's
    normalize_input range."""
    if variant not in ("fid", "torchvision"):
        raise ValueError(f"unknown variant {variant!r} (fid | torchvision)")
    fid_variant = variant == "fid"
    x = torch.as_tensor(x).to(torch.float32)
    with ieee_fp32(torch.float32, x.device):
        h = _resize_to_input(x.permute(0, 3, 1, 2))
        h = _conv(params, "Conv2d_1a_3x3", h)          # 149², 32
        h = _conv(params, "Conv2d_2a_3x3", h)          # 147², 32
        h = _conv(params, "Conv2d_2b_3x3", h)          # 147², 64
        h = F.max_pool2d(h, 3, 2)                      # 73², 64
        h = _conv(params, "Conv2d_3b_1x1", h)          # 73², 80
        h = _conv(params, "Conv2d_4a_3x3", h)          # 71², 192
        h = F.max_pool2d(h, 3, 2)                      # 35², 192
        h = _mixed_a(params, "Mixed_5b", h, fid_variant)   # 35², 256
        h = _mixed_a(params, "Mixed_5c", h, fid_variant)   # 35², 288
        h = _mixed_a(params, "Mixed_5d", h, fid_variant)   # 35², 288
        h = _mixed_b(params, "Mixed_6a", h)                # 17², 768
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            h = _mixed_c(params, name, h, fid_variant)     # 17², 768
        h = _mixed_d(params, "Mixed_7a", h)                # 8², 1280
        h = _mixed_e(params, "Mixed_7b", h, "avg", fid_variant)  # 8², 2048
        h = _mixed_e(params, "Mixed_7c", h, "max" if fid_variant else "avg", fid_variant)
        return h.mean(dim=(2, 3))                      # adaptive avg pool → 2048


# ---------------------------------------------------------------- extractor ---


@functools.lru_cache(maxsize=2)
def _cached_params(path: str) -> dict:
    return load_params(path)


@functools.lru_cache(maxsize=4)
def _params_on(path: str, device: str) -> dict:
    return {name: {k: v.to(device) for k, v in p.items()}
            for name, p in _cached_params(path).items()}


def features_from_file(path: str, variant: str = "fid"):
    """``images -> (N, 2048)`` extractor for ``utils/metrics``, resolved by
    ``metrics.get_extractor("inception:<path>")``: the folded parameters
    are read once per file and placed once per device, and each call runs
    on the images' device."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Inception weights not found: {path} — download e.g. "
            "pytorch-fid's pt_inception-2015-12-05-6726825d.pth or "
            "torchvision's inception_v3_google weights and point "
            "--fid-extractor inception:<path> at the file"
        )
    path = os.path.abspath(path)

    def extract(images):
        images = torch.as_tensor(images)
        return pool3_features(_params_on(path, str(images.device)), images, variant)

    return extract
