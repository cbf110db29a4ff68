"""Carrying weights between the JAX package and the port — counterpart of
gan_class_transfer2_tpu/utils/tf_import.py.

Two forms:

  * the JAX param pytree (``init_unet``'s nested dicts and lists) with numpy
    leaves: ``from_jax_params`` / ``to_jax_params``;
  * the flat Keras build-order list — the ``.npz`` that the JAX CLI's
    ``export-weights`` writes (keys ``w_00000``…): ``import_flat_weights`` /
    ``export_flat_weights`` / ``load_flat_npz``. Keras order is downs
    outside-in (each with its block_in), middle, ups inside-out (block_out,
    then the up conv, then skip_dense), post block, head. Conv2DTranspose
    kernels are stored there as TF's (kh, kw, out, in) and converted to the
    dataflow HWIO here.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import unet
from ..models.api import resolve_device


def _np(p) -> np.ndarray:
    return p.detach().cpu().numpy()


def to_jax_params(model: unet.Denoiser) -> dict:
    """The JAX param pytree of ``model``, numpy leaves."""

    def conv(layer):
        return {"kernel": _np(layer.kernel), "bias": _np(layer.bias)}

    octaves = []
    for level in model.octaves:
        entry = {
            "down": conv(level.down),
            "block_in": [conv(x) for x in level.block_in],
            "block_out": [conv(x) for x in level.block_out],
            "up": conv(level.up),
        }
        if hasattr(level, "skip_dense"):
            entry["skip_dense"] = _np(level.skip_dense)
        octaves.append(entry)
    return {
        "pre_block": [conv(x) for x in model.pre_block],
        "octaves": octaves,
        "middle": [conv(x) for x in model.middle],
        "post_block": [conv(x) for x in model.post_block],
        "head": conv(model.head),
    }


def _jax_state(tree) -> dict:
    """Flatten a JAX param pytree into the Denoiser's state_dict names."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk("", tree)
    return out


def from_jax_params(cfg, tree, device="cuda") -> unet.Denoiser:
    """A Denoiser on ``device`` holding the JAX param pytree ``tree`` (numpy
    or array-like leaves). Names and shapes must match exactly."""
    model = unet.Denoiser(cfg)
    model.load_state_dict(_jax_state(tree), strict=True)
    return model.to(resolve_device(device))


def _keras_order(model: unet.Denoiser):
    """Yield ``(parameter, is_conv_transpose_kernel)`` in Keras build order."""

    def block(layers):
        for layer in layers:
            yield layer.kernel, False
            yield layer.bias, False

    yield from block(model.pre_block)
    for level in model.octaves:
        yield level.down.kernel, False
        yield level.down.bias, False
        yield from block(level.block_in)
    yield from block(model.middle)
    for level in reversed(model.octaves):
        yield from block(level.block_out)
        yield level.up.kernel, True
        yield level.up.bias, False
        if hasattr(level, "skip_dense"):
            yield level.skip_dense, False
    yield from block(model.post_block)
    yield model.head.kernel, False
    yield model.head.bias, False


@torch.no_grad()
def import_flat_weights(model: unet.Denoiser, flat) -> unet.Denoiser:
    """Fill ``model`` in place from a flat Keras build-order weight list."""
    flat = list(flat)
    slots = list(_keras_order(model))
    if len(flat) != len(slots):
        raise ValueError(
            f"{len(flat)} weights given, the model has {len(slots)} — order mismatch"
        )
    for n, ((param, convt), arr) in enumerate(zip(slots, flat)):
        arr = np.asarray(arr, dtype=np.float32)
        if convt:
            arr = arr.transpose(0, 1, 3, 2)  # TF convT (kh,kw,out,in) -> HWIO
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"weight {n}: shape {arr.shape}, model expects {tuple(param.shape)}"
            )
        param.copy_(torch.tensor(arr))
    return model


def export_flat_weights(model: unet.Denoiser) -> List[np.ndarray]:
    """Inverse of ``import_flat_weights``: the Keras build-order list."""
    out = []
    for param, convt in _keras_order(model):
        arr = _np(param)
        out.append(arr.transpose(0, 1, 3, 2) if convt else arr)
    return out


def load_flat_npz(path) -> List[np.ndarray]:
    """The flat list stored in an ``export-weights`` npz (keys ``w_<n>``,
    in numeric order whatever their zero padding)."""
    with np.load(path) as data:
        keys = sorted((k for k in data.files if k.startswith("w_")), key=lambda k: int(k[2:]))
        return [data[k] for k in keys]


def save_flat_npz(path, flat) -> None:
    """Write a flat list as the JAX CLI's ``export-weights`` does."""
    np.savez(path, **{f"w_{i:05d}": w for i, w in enumerate(flat)})
