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

A whole JAX ``TrainState`` (params, optax optimizer state, EMA, loss-scale
state), given with numpy leaves, carries into the port's
``train.trainer.TrainState`` by ``from_jax_train_state`` and back by
``to_jax_train_state``, so a JAX run and a port run continue from the same
state.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import unet
from ..models.api import resolve_device


def _np(p) -> np.ndarray:
    if p.dtype == torch.bfloat16:  # numpy has no bfloat16: carry the values as float32
        p = p.float()
    return p.detach().cpu().numpy()


def to_jax_params(model: unet.Denoiser, values=None) -> dict:
    """The JAX param pytree of ``model``, numpy leaves: the parameters
    themselves, or ``values[i]`` for the i-th of ``model.parameters()`` (a
    list of tensors shaped like them, such as Adam's moments)."""
    by_id = {id(p): v for p, v in zip(model.parameters(), values)} if values is not None else {}

    def leaf(p):
        return _np(by_id.get(id(p), p))

    def conv(layer):
        return {"kernel": leaf(layer.kernel), "bias": leaf(layer.bias)}

    octaves = []
    for level in model.octaves:
        entry = {
            "down": conv(level.down),
            "block_in": [conv(x) for x in level.block_in],
            "block_out": [conv(x) for x in level.block_out],
            "up": conv(level.up),
        }
        if hasattr(level, "skip_dense"):
            entry["skip_dense"] = leaf(level.skip_dense)
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


# ------------------------------------------------------------ train state


def _param_list(model: unet.Denoiser, tree, dtype=None) -> list:
    """A JAX param-shaped tree as one tensor per ``model.parameters()``, on
    the model's device."""
    flat = _jax_state(tree)
    device = next(model.parameters()).device
    return [flat[name].to(device=device, dtype=dtype or torch.float32)
            for name, _ in model.named_parameters()]


def _is_param_tree(node) -> bool:
    return isinstance(node, dict) and "octaves" in node


def _opt_from_jax(model, node, moment_dtype):
    from ..train import trainer

    if _is_param_tree(node):
        return _param_list(model, node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        name = type(node).__name__
        cls = getattr(trainer, name, None)
        if cls is None:
            raise ValueError(f"optimizer state {name} has no counterpart in the port")
        fields = {}
        for field, value in zip(node._fields, node):
            if name == "MultiStepsState" and field in ("mini_step", "gradient_step"):
                fields[field] = int(np.asarray(value))
            elif name == "ScaleByAdamState" and field in ("mu", "nu"):
                fields[field] = _param_list(model, value, moment_dtype)
            elif field == "skip_state":
                fields[field] = tuple(value)
            else:
                fields[field] = _opt_from_jax(model, value, moment_dtype)
        return cls(**fields)
    if isinstance(node, (tuple, list)):
        return type(node)(_opt_from_jax(model, v, moment_dtype) for v in node)
    device = next(model.parameters()).device
    return torch.from_numpy(np.array(node)).to(device)


def _opt_to_jax(model, node):
    if isinstance(node, list):
        return to_jax_params(model, node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(np.asarray(v, np.int32) if isinstance(v, int) else
                            _opt_to_jax(model, v) for v in node))
    if isinstance(node, tuple):
        return tuple(_opt_to_jax(model, v) for v in node)
    return _np(node)


def from_jax_train_state(cfg, state, device="cuda"):
    """The port's ``TrainState`` from a JAX one with numpy leaves: params,
    optimizer state (optax's NamedTuples by name and field; moments in
    ``cfg.moment_dtype`` for the Keras-form Adam), EMA and loss-scale
    state."""
    from ..train import trainer

    model = from_jax_params(cfg, state.params, device)
    moment_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" and cfg.optimizer in (
        "adam_tf", "adam_fused") else None
    opt_state = _opt_from_jax(model, state.opt_state, moment_dtype)
    ema = _param_list(model, state.ema_params) if state.ema_params is not None else None
    scale = None
    if state.scale_state is not None:
        dev = next(model.parameters()).device
        scale = trainer.ScaleState(
            torch.from_numpy(np.array(state.scale_state.scale, np.float32)).to(dev),
            torch.from_numpy(np.array(state.scale_state.good_steps, np.int32)).to(dev))
    return trainer.TrainState(int(np.asarray(state.step)), model, opt_state, ema, scale)


def to_jax_train_state(state) -> dict:
    """The inverse of ``from_jax_train_state``: the JAX ``TrainState``'s
    fields as a dict of numpy trees, optimizer states as the port's
    NamedTuples (optax's names and fields); bfloat16 moments come back as
    float32 values."""
    model = state.model
    scale = None
    if state.scale_state is not None:
        scale = type(state.scale_state)(_np(state.scale_state.scale),
                                        _np(state.scale_state.good_steps))
    return {
        "step": np.asarray(state.step, np.int32),
        "params": to_jax_params(model),
        "opt_state": _opt_to_jax(model, state.opt_state),
        "ema_params": to_jax_params(model, state.ema_params)
        if state.ema_params is not None else None,
        "scale_state": scale,
    }
