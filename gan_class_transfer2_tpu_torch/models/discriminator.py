"""Discriminator for GAN-mode class transfer — counterpart of
gan_class_transfer2_tpu/models/discriminator.py.

A strided-conv encoder of ``d_octaves`` (or ``octaves``) k4/s2 down convs
with ``min(base·2^i, max_size)`` filters (``base = d_pixel_size or
pixel_size``), each without its ReLU, then the norm (every layer but the
first, CycleGAN's convention), then ``leaky_relu(0.2)``; a 1×1 dense head
gives PatchGAN per-patch logits or, without ``patch_discriminator``, one
mean-pooled logit per image; with ``num_classes > 0`` a projection term
``<embed_y, feat>`` is added. The down convs go to the hand-written B4
kernel where its gate admits the shape (ops/conv.py ``down_conv``), on a
rank's output channels under tensor parallelism (``parallel/tensor``).

``Discriminator`` holds the parameters under the JAX pytree's names
(``convs.1.norm.gamma`` ↔ ``params["convs"][1]["norm"]["gamma"]``), float32;
``discriminator_apply`` casts them to ``cfg.compute_dtype`` and returns
float32 logits.

``d_layout="patchgan70"`` is the published CycleGAN's 70×70 PatchGAN (arXiv
1703.10593; the authors' ``NLayerDiscriminator``, ``n_layers`` =
``d_octaves``): the same k4/s2 convs of ``min(base·2^i, max_size)`` filters
(B4's route), then ``convs.<d_octaves>``, a k4/s1 conv of the next width,
and ``head``, a k4/s1 conv to one channel, both with zero pad 1; an instance
norm without γ or β (B3 with no affine) on every conv but the first and the
head, ``leaky_relu(0.2)`` after every conv but the head. At 256² and ndf 64
it holds 2,764,737 parameters (C64, C128, C256, C512, head) and gives 30×30
patch logits. Kernels N(0, 0.02), zero biases (the authors'
``init_weights``); no class projection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv as conv_ops
from ..ops import init as init_ops
from ..ops import norm as norm_ops
from ..parallel import tensor
from .api import resolve_device
from .unet import DTYPES, Conv


def d_octaves(cfg) -> int:
    return cfg.d_octaves or cfg.octaves


def d_filters(cfg, i: int) -> int:
    base = cfg.d_pixel_size or cfg.pixel_size
    return min(base * 2**i, cfg.max_size)


class Discriminator(nn.Module):
    """Parameters of ``init_discriminator`` (zeros until
    ``reset_parameters``)."""

    def __init__(self, cfg, in_channels: int = 3, num_classes: int = 0):
        super().__init__()
        self.layout = cfg.d_layout
        self.convs = nn.ModuleList()
        c = in_channels
        patch70 = self.layout == "patchgan70"
        if patch70 and num_classes > 0:
            raise ValueError("d_layout='patchgan70' has no class projection (num_classes == 0)")
        for i in range(d_octaves(cfg) + patch70):
            f = d_filters(cfg, i)
            layer = Conv((4, 4, c, f))
            if cfg.d_norm != "none" and i > 0 and not patch70:
                layer.norm = norm_ops.init_norm(f)
            self.convs.append(layer)
            c = f
        self.head = Conv((4, 4, c, 1) if patch70 else (c, 1))
        if num_classes > 0:
            self.class_embed = nn.Parameter(torch.zeros(num_classes, c))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Glorot-uniform kernels and class embedding, zero biases, unit
        norms, drawn in ``init_discriminator``'s order from ``generator`` (a
        CPU generator; the draws are copied to the parameters' device). The
        70×70 PatchGAN's: N(0, 0.02) kernels, zero biases, in
        ``parameters()`` order."""
        if self.layout == "patchgan70":
            return init_ops.normal_reset(self, generator)
        for layer in self.convs:
            kh, kw, i, o = layer.kernel.shape
            layer.kernel.copy_(init_ops.conv_kernel(generator, kh, kw, i, o))
            layer.bias.zero_()
            if hasattr(layer, "norm"):
                layer.norm.reset_parameters()
        self.head.kernel.copy_(init_ops.dense_kernel(generator, *self.head.kernel.shape))
        self.head.bias.zero_()
        if hasattr(self, "class_embed"):
            n, c = self.class_embed.shape
            self.class_embed.copy_(init_ops.glorot_uniform(generator, (n, c), n, c))
        return self


def init_discriminator(cfg, generator: torch.Generator, device="cuda", in_channels: int = 3,
                       num_classes: int = 0) -> Discriminator:
    """A Glorot-initialised Discriminator on ``device`` (the card unless the
    caller asks for the CPU; without a card ``cuda`` raises)."""
    dev = resolve_device(device)
    return Discriminator(cfg, in_channels, num_classes).reset_parameters(generator).to(dev)


def discriminator_apply(cfg, model: Discriminator, x, class_idx=None):
    """x: (B, H, W, C) → float32 logits (B, h', w', 1) if
    ``patch_discriminator`` else (B, 1)."""
    dtype = DTYPES[cfg.compute_dtype]
    if model.layout == "patchgan70":
        return _patchgan70_apply(cfg, model, x.to(dtype), dtype)
    h = x.to(dtype)
    for layer in model.convs:
        h = tensor.layer_apply(
            layer, dtype, lambda x, k, b: conv_ops.down_conv(x, k, b, relu=False), h)
        if hasattr(layer, "norm"):
            h = norm_ops.apply_norm(cfg.d_norm, h, layer.norm)
        h = F.leaky_relu(h, 0.2)
    logits = conv_ops.dense(h, model.head.kernel.to(dtype), model.head.bias.to(dtype))
    if not cfg.patch_discriminator:
        logits = logits.mean(dim=(1, 2))  # (B, 1)
        feat = h.mean(dim=(1, 2))
    else:
        feat = h
    if class_idx is not None and hasattr(model, "class_embed"):
        embed = model.class_embed[class_idx].to(feat.dtype)  # (B, C)
        if cfg.patch_discriminator:
            proj = torch.einsum("bhwc,bc->bhw", feat, embed)[..., None]
        else:
            proj = torch.sum(feat * embed, dim=-1, keepdim=True)
        logits = logits + proj
    return logits.float()


def _patchgan70_apply(cfg, model, h, dtype):
    """The 70×70 PatchGAN's forward: the k4/s2 convs by ``down_conv`` (SAME
    is pad 1 on the even inputs ``validate`` asks for, so B4 takes the
    shapes its gate admits), the k4/s1 conv and head by ``conv2d_padded``."""
    last = len(model.convs) - 1

    def down(x, k, b):
        return conv_ops.down_conv(x, k, b, relu=False)

    def flat(x, k, b):
        return conv_ops.conv2d_padded(x, k, b, stride=1, pad=1)

    for i, layer in enumerate(model.convs):
        h = tensor.layer_apply(layer, dtype, flat if i == last else down, h)
        if i > 0:
            h = norm_ops.instance_norm(h, None, None)
        h = F.leaky_relu(h, 0.2)
    return tensor.layer_apply(model.head, dtype, flat, h).float()


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
