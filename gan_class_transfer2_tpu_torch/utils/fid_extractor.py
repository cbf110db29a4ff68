"""The pinned, trained FID feature extractor — counterpart of
gan_class_transfer2_tpu/utils/fid_extractor.py.

A small strided-conv classifier trained on the 8-class synthetic shape
corpus; its global-average-pooled 256 features are the default embedding of
``utils/metrics.py``. The weights are the JAX package's committed file
(``gan_class_transfer2_tpu/weights/fid_extractor.npz``), read by path as
data, never imported, so the two packages score with one embedding.

Architecture (NHWC, inputs resized to 64², values in [-1, 1)):
  conv3x3/s2 32 → conv3x3/s2 64 → conv3x3/s2 128 → conv3x3/s2 256
  → GAP (features) → dense 8 (classifier head, unused by FID)

What differs from the JAX module, and why:

  * The resize to 64² is ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)``: ``jax.image.resize`` antialiases
    when it downsamples, and without ``antialias=True`` a 256² input's
    features move by ~0.85 (absolute, on values ~1).
  * The forward runs in IEEE float32 (``models/unet.ieee_fp32``): cuDNN's
    TF32 would move the features by ~1e-3.
  * ``save_params`` (retraining the extractor) is not ported.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import ieee_fp32
from ..ops import conv as conv_ops

INPUT_SIZE = 64
FEATURE_DIM = 256
NUM_CLASSES = 8
_WIDTHS = (32, 64, 128, 256)

WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gan_class_transfer2_tpu", "weights", "fid_extractor.npz",
)


def features(params, x):
    """Penultimate features (N, 256). ``x``: (N, H, W, 3) in [-1, 1), any
    H, W — resized to the trained 64²."""
    x = x.to(torch.float32)
    with ieee_fp32(torch.float32, x.device):
        if x.shape[1] != INPUT_SIZE or x.shape[2] != INPUT_SIZE:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(INPUT_SIZE, INPUT_SIZE),
                              mode="bilinear", align_corners=False, antialias=True)
            x = x.permute(0, 2, 3, 1)
        h = x
        for layer in params["convs"]:
            h = conv_ops.conv2d(h, layer["kernel"], layer["bias"], stride=2, relu=True)
        return h.mean(dim=(1, 2))


def logits(params, x):
    with ieee_fp32(torch.float32, x.device):
        return conv_ops.dense(features(params, x), params["head"]["kernel"],
                              params["head"]["bias"])


@functools.lru_cache(maxsize=1)
def load_params(path: str = WEIGHTS_PATH):
    """The committed weights as float32 CPU tensors (cached)."""
    data = np.load(path)

    def t(name):
        return torch.from_numpy(np.asarray(data[name], np.float32))

    return {
        "convs": [{"kernel": t(f"conv{i}_kernel"), "bias": t(f"conv{i}_bias")}
                  for i in range(len(_WIDTHS))],
        "head": {"kernel": t("head_kernel"), "bias": t("head_bias")},
    }


@functools.lru_cache(maxsize=4)
def _params_on(device: str):
    params = load_params()
    return {
        "convs": [{k: v.to(device) for k, v in layer.items()} for layer in params["convs"]],
        "head": {k: v.to(device) for k, v in params["head"].items()},
    }


def available(path: str = WEIGHTS_PATH) -> bool:
    return os.path.exists(path)


@torch.inference_mode()
def trained_features(images):
    """images (N, H, W, 3) tensor → (N, 256) with the pinned weights, on
    the images' device — the plug-in extractor of ``utils/metrics``."""
    return features(_params_on(str(images.device)), images)
