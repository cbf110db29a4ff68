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
state; a JAX ``GANState`` likewise by ``from_jax_gan_state`` and
``to_jax_gan_state`` (four nets, the optimizer states over ``{"ab", "ba"}``
and ``{"a", "b"}``, the generator EMAs), and a ``ConditionalGANState`` by
``from_jax_conditional_gan_state`` and ``to_jax_conditional_gan_state``.
The class-conditional denoiser's ``{"embed", "unet"}`` tree carries by
``from_jax_conditional_params`` / ``to_jax_conditional_params``, which
``from_jax_params`` / ``to_jax_params`` and the train-state functions
dispatch to. Norm layers (GAN mode) carry under
``down_norm``/``up_norm`` and ``convs[i]["norm"]``; the flat Keras order
has none, as the reference model has none.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..models import conditional
from ..models import discriminator as d_lib
from ..models import unet
from ..models.api import resolve_device


def _np(p) -> np.ndarray:
    if p.dtype == torch.bfloat16:  # numpy has no bfloat16: carry the values as float32
        p = p.float()
    return p.detach().cpu().numpy()


def to_jax_params(model, values=None) -> dict:
    """The JAX param pytree of ``model``, numpy leaves: the parameters
    themselves, or ``values[i]`` for the i-th of ``model.parameters()`` (a
    list of tensors shaped like them, such as Adam's moments)."""
    if isinstance(model, conditional.ConditionalDenoiser):
        return to_jax_conditional_params(model, values)
    by_id = {id(p): v for p, v in zip(model.parameters(), values)} if values is not None else {}

    def leaf(p):
        return _np(by_id.get(id(p), p))

    def conv(layer):
        return {"kernel": leaf(layer.kernel), "bias": leaf(layer.bias)}

    def norm(layer):
        return {"gamma": leaf(layer.gamma), "beta": leaf(layer.beta)}

    octaves = []
    for level in model.octaves:
        entry = {
            "down": conv(level.down),
            "block_in": [conv(x) for x in level.block_in],
            "block_out": [conv(x) for x in level.block_out],
            "up": conv(level.up),
        }
        for name in ("down_norm", "up_norm"):
            if hasattr(level, name):
                entry[name] = norm(getattr(level, name))
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


def from_jax_params(cfg, tree, device="cuda", out_channels=None):
    """A Denoiser on ``device`` holding the JAX param pytree ``tree`` (numpy
    or array-like leaves), a ConditionalDenoiser when the tree has an
    ``embed``. Names and shapes must match exactly."""
    if "embed" in tree:
        return from_jax_conditional_params(cfg, tree, device, out_channels)
    model = unet.Denoiser(cfg, out_channels=out_channels)
    model.load_state_dict(_jax_state(tree), strict=True)
    return model.to(resolve_device(device))


def to_jax_conditional_params(model: conditional.ConditionalDenoiser, values=None) -> dict:
    """``{"embed", "unet"}`` of a ConditionalDenoiser, numpy leaves;
    ``values`` as for ``to_jax_params`` (``embed`` is the first parameter)."""
    embed = model.embed if values is None else values[0]
    return {"embed": _np(embed),
            "unet": to_jax_params(model.unet, None if values is None else values[1:])}


def from_jax_conditional_params(cfg, tree, device="cuda", out_channels=None):
    """A ConditionalDenoiser on ``device`` holding the JAX
    ``init_conditional_unet`` tree ``tree``; the class count and embedding
    width come from ``tree["embed"]``."""
    num_classes, embed_dim = np.shape(tree["embed"])
    model = conditional.ConditionalDenoiser(cfg, num_classes, embed_dim,
                                            out_channels=out_channels)
    model.load_state_dict(_jax_state(tree), strict=True)
    return model.to(resolve_device(device))


def to_jax_discriminator_params(model: d_lib.Discriminator, values=None) -> dict:
    """The JAX discriminator pytree of ``model`` (``init_discriminator``'s
    names), numpy leaves; ``values`` as for ``to_jax_params``."""
    by_id = {id(p): v for p, v in zip(model.parameters(), values)} if values is not None else {}

    def leaf(p):
        return _np(by_id.get(id(p), p))

    convs = []
    for layer in model.convs:
        entry = {"kernel": leaf(layer.kernel), "bias": leaf(layer.bias)}
        if hasattr(layer, "norm"):
            entry["norm"] = {"gamma": leaf(layer.norm.gamma), "beta": leaf(layer.norm.beta)}
        convs.append(entry)
    tree = {"convs": convs, "head": {"kernel": leaf(model.head.kernel),
                                     "bias": leaf(model.head.bias)}}
    if hasattr(model, "class_embed"):
        tree["class_embed"] = leaf(model.class_embed)
    return tree


def from_jax_discriminator_params(cfg, tree, device="cuda") -> d_lib.Discriminator:
    """A Discriminator on ``device`` holding the JAX pytree ``tree``."""
    num_classes = np.shape(tree["class_embed"])[0] if "class_embed" in tree else 0
    in_channels = np.shape(tree["convs"][0]["kernel"])[2] if tree["convs"] else 3
    model = d_lib.Discriminator(cfg, in_channels, num_classes)
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


def _param_list(model, tree, dtype=None) -> list:
    """A JAX param-shaped tree as one tensor per ``model.parameters()``, on
    the model's device."""
    flat = _jax_state(tree)
    device = next(model.parameters()).device
    return [flat[name].to(device=device, dtype=dtype or torch.float32)
            for name, _ in model.named_parameters()]


class _Layout(NamedTuple):
    """How one optimizer's flat parameter list maps onto the JAX tree its
    optax state holds (one param tree, or a dict of them)."""

    is_tree: Callable  # node -> bool
    to_list: Callable  # (tree, dtype) -> list of tensors
    to_tree: Callable  # list of tensors -> numpy tree
    device: torch.device


def _model_layout(model) -> _Layout:
    """One denoiser (conditional or not) or discriminator."""
    if isinstance(model, d_lib.Discriminator):
        return _Layout(lambda node: isinstance(node, dict) and "convs" in node,
                       lambda tree, dtype: _param_list(model, tree, dtype),
                       lambda values: to_jax_discriminator_params(model, values),
                       next(model.parameters()).device)
    return _Layout(lambda node: isinstance(node, dict) and ("octaves" in node or "unet" in node),
                   lambda tree, dtype: _param_list(model, tree, dtype),
                   lambda values: to_jax_params(model, values),
                   next(model.parameters()).device)


def _dict_layout(models: dict, to_jax) -> _Layout:
    """``{key: module}``: the optimizer's list is the modules' parameters
    concatenated in the dict's order."""
    keys = list(models)
    sizes = [len(list(models[k].parameters())) for k in keys]

    def to_list(tree, dtype):
        return [t for k in keys for t in _param_list(models[k], tree[k], dtype)]

    def to_tree(values):
        out, i = {}, 0
        for k, n in zip(keys, sizes):
            out[k] = to_jax(models[k], values[i:i + n])
            i += n
        return out

    return _Layout(lambda node: isinstance(node, dict) and set(node) == set(keys), to_list,
                   to_tree, next(models[keys[0]].parameters()).device)


def _opt_from_jax(layout: _Layout, node, moment_dtype):
    from ..train import trainer

    if layout.is_tree(node):
        return layout.to_list(node, None)
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
                fields[field] = layout.to_list(value, moment_dtype)
            elif field == "skip_state":
                fields[field] = tuple(value)
            else:
                fields[field] = _opt_from_jax(layout, value, moment_dtype)
        return cls(**fields)
    if isinstance(node, (tuple, list)):
        return type(node)(_opt_from_jax(layout, v, moment_dtype) for v in node)
    return torch.from_numpy(np.array(node)).to(layout.device)


def _opt_to_jax(layout: _Layout, node):
    if isinstance(node, list):
        return layout.to_tree(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(np.asarray(v, np.int32) if isinstance(v, int) else
                            _opt_to_jax(layout, v) for v in node))
    if isinstance(node, tuple):
        return tuple(_opt_to_jax(layout, v) for v in node)
    return _np(node)


def _moment_dtype(cfg):
    """bfloat16 moments for the Keras-form Adam under ``moment_dtype``."""
    if cfg.moment_dtype == "bfloat16" and cfg.optimizer in ("adam_tf", "adam_fused"):
        return torch.bfloat16
    return None


def from_jax_train_state(cfg, state, device="cuda"):
    """The port's ``TrainState`` from a JAX one with numpy leaves: params,
    optimizer state (optax's NamedTuples by name and field; moments in
    ``cfg.moment_dtype`` for the Keras-form Adam), EMA and loss-scale
    state."""
    from ..train import trainer

    model = from_jax_params(cfg, state.params, device)
    opt_state = _opt_from_jax(_model_layout(model), state.opt_state, _moment_dtype(cfg))
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
        "opt_state": _opt_to_jax(_model_layout(model), state.opt_state),
        "ema_params": to_jax_params(model, state.ema_params)
        if state.ema_params is not None else None,
        "scale_state": scale,
    }


# -------------------------------------------------------------- GAN state


def _gan_layouts(state):
    return (_dict_layout({"ab": state.g_ab, "ba": state.g_ba}, to_jax_params),
            _dict_layout({"a": state.d_a, "b": state.d_b}, to_jax_discriminator_params))


def from_jax_gan_state(cfg, state, device="cuda"):
    """The port's ``GANState`` from a JAX one with numpy leaves: the four
    nets, both optimizer states and the generator EMAs."""
    from ..train import gan

    def g(tree):
        return from_jax_params(cfg, tree, device, out_channels=3)

    def d(tree):
        return from_jax_discriminator_params(cfg, tree, device)

    out = gan.GANState(int(np.asarray(state.step)), g(state.g_ab), g(state.g_ba),
                       d(state.d_a), d(state.d_b), None, None,
                       None if state.ema_g_ab is None else g(state.ema_g_ab).requires_grad_(False),
                       None if state.ema_g_ba is None else g(state.ema_g_ba).requires_grad_(False))
    g_layout, d_layout = _gan_layouts(out)
    moments = _moment_dtype(cfg)
    return out._replace(g_opt=_opt_from_jax(g_layout, state.g_opt, moments),
                        d_opt=_opt_from_jax(d_layout, state.d_opt, moments))


def to_jax_gan_state(state) -> dict:
    """The inverse of ``from_jax_gan_state``: the JAX ``GANState``'s fields
    as a dict of numpy trees, optimizer states as the port's NamedTuples."""
    g_layout, d_layout = _gan_layouts(state)
    return {
        "step": np.asarray(state.step, np.int32),
        "g_ab": to_jax_params(state.g_ab),
        "g_ba": to_jax_params(state.g_ba),
        "d_a": to_jax_discriminator_params(state.d_a),
        "d_b": to_jax_discriminator_params(state.d_b),
        "g_opt": _opt_to_jax(g_layout, state.g_opt),
        "d_opt": _opt_to_jax(d_layout, state.d_opt),
        "ema_g_ab": None if state.ema_g_ab is None else to_jax_params(state.ema_g_ab),
        "ema_g_ba": None if state.ema_g_ba is None else to_jax_params(state.ema_g_ba),
    }


# --------------------------------------------------- conditional GAN state


def from_jax_conditional_gan_state(cfg, state, device="cuda"):
    """The port's ``ConditionalGANState`` from a JAX one with numpy leaves:
    G, D, both optimizer states and G's EMA."""
    from ..train import conditional_gan as cgan

    g = from_jax_conditional_params(cfg, state.generator, device)
    d = from_jax_discriminator_params(cfg, state.discriminator, device)
    ema = state.ema_generator
    if ema is not None:
        ema = from_jax_conditional_params(cfg, ema, device).requires_grad_(False)
    moments = _moment_dtype(cfg)
    return cgan.ConditionalGANState(
        int(np.asarray(state.step)), g, d,
        _opt_from_jax(_model_layout(g), state.g_opt, moments),
        _opt_from_jax(_model_layout(d), state.d_opt, moments), ema)


def to_jax_conditional_gan_state(state) -> dict:
    """The inverse of ``from_jax_conditional_gan_state``: the JAX
    ``ConditionalGANState``'s fields as a dict of numpy trees, optimizer
    states as the port's NamedTuples."""
    return {
        "step": np.asarray(state.step, np.int32),
        "generator": to_jax_conditional_params(state.generator),
        "discriminator": to_jax_discriminator_params(state.discriminator),
        "g_opt": _opt_to_jax(_model_layout(state.generator), state.g_opt),
        "d_opt": _opt_to_jax(_model_layout(state.discriminator), state.d_opt),
        "ema_generator": None if state.ema_generator is None
        else to_jax_conditional_params(state.ema_generator),
    }
