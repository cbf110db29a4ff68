"""Plain float32 models: the denoiser U-Net of relgukxilef/GAN-Class-Transfer2
(train.py:175-215), the cycle GAN's PatchGAN discriminator and instance norm.

Written from the published description in ``torch.nn.functional`` on NCHW
tensors, with no kernel, cache or batching of the program under test, and
importing nothing of it. Weights are a dict ``name -> tensor`` under the
port's parameter names (``octaves.0.down.kernel``), kernels HWIO as the
published Keras layers store them (transposed convs in dataflow
orientation: I is the layer's input channels), so one seeded dict is
handed to both sides.

``Ops`` holds how a conv's operands are rounded: ``None`` for the float32
reference, or a function applied to each conv's input and kernel (the
control of ``lowp.py``). A ``Recorder`` passed as ``rec`` is told the shape
of every conv and norm, which the roofline counts read.

Departures from the published model: only ``skip_mode="concat"`` and a head
without ``per_step_output`` are written (the benchmark's configurations).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

EPS = 1e-5


class Recorder(list):
    """Collects ``(op, shape...)`` tuples of the calls a pass makes."""

    def add(self, *item):
        self.append(tuple(item))


def _q(ops, x):
    return x if ops is None else ops(x)


def conv_down(x, kernel, bias, ops=None, rec=None):
    """4×4/s2 TF-SAME conv (pad 1 on even inputs) + bias: NCHW in and out."""
    if rec is not None:
        rec.add("down_conv", tuple(x.shape), tuple(kernel.shape))
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError("reference down conv needs even spatial dims")
    w = kernel.permute(3, 2, 0, 1)
    y = F.conv2d(_q(ops, x), _q(ops, w), stride=2, padding=1)
    return y + bias[None, :, None, None]


def conv_up(x, kernel, bias, ops=None, rec=None):
    """4×4/s2 TF-SAME transposed conv + bias (output = input · 2)."""
    if rec is not None:
        rec.add("up_conv", tuple(x.shape), tuple(kernel.shape))
    w = kernel.permute(2, 3, 0, 1)
    y = F.conv_transpose2d(_q(ops, x), _q(ops, w), stride=2, padding=1)
    return y + bias[None, :, None, None]


def conv3(x, kernel, bias, ops=None, rec=None):
    """3×3/s1 SAME conv + bias + ReLU (a Block layer)."""
    if rec is not None:
        rec.add("conv3", tuple(x.shape), tuple(kernel.shape))
    w = kernel.permute(3, 2, 0, 1)
    return torch.relu(F.conv2d(_q(ops, x), _q(ops, w), padding=1) + bias[None, :, None, None])


def dense(x, kernel, bias, ops=None, rec=None):
    """1×1 dense over channels: (B, C, H, W) → (B, O, H, W)."""
    if rec is not None:
        rec.add("dense", tuple(x.shape), tuple(kernel.shape))
    y = torch.einsum("bchw,co->bohw", _q(ops, x), _q(ops, kernel))
    return y + bias[None, :, None, None]


def instance_norm(x, gamma, beta, rec=None):
    """Per (sample, channel) over (H, W): biased variance, rsqrt(v + 1e-5)."""
    if rec is not None:
        rec.add("instance_norm", tuple(x.shape))
    m = x.mean(dim=(2, 3), keepdim=True)
    v = torch.square(x - m).mean(dim=(2, 3), keepdim=True)
    return (x - m) * torch.rsqrt(v + EPS) * gamma[None, :, None, None] + beta[None, :, None, None]


# ------------------------------------------------------------------ shapes


def _filters(cfg, i):
    return min(cfg.pixel_size * 2**i, cfg.max_size)


def _up_filters(cfg, i):
    return min(cfg.pixel_size * 2**i // 2, cfg.max_size)


def denoiser_shapes(cfg, out_channels=3, normed=False, in_channels=3):
    """``name -> shape`` of the U-Net's parameters (reference train.py:175-215
    with ``block_depth`` 3×3 convs a Block and concat skips)."""
    if cfg.skip_mode != "concat" or cfg.per_step_output:
        raise NotImplementedError("the reference writes concat skips and a plain head only")
    shapes = OrderedDict()

    def block(prefix, c, f):
        for n in range(cfg.block_depth):
            shapes[f"{prefix}.{n}.kernel"] = (3, 3, c, f)
            shapes[f"{prefix}.{n}.bias"] = (f,)
            c = f
        return c

    c = block("pre_block", in_channels, cfg.pixel_size)
    skips = []
    for i in range(cfg.octaves):
        f = _filters(cfg, i)
        skips.append(c)
        shapes[f"octaves.{i}.down.kernel"] = (4, 4, c, f)
        shapes[f"octaves.{i}.down.bias"] = (f,)
        if normed:
            shapes[f"octaves.{i}.down_norm.gamma"] = (f,)
            shapes[f"octaves.{i}.down_norm.beta"] = (f,)
        c = block(f"octaves.{i}.block_in", f, f)
    c = block("middle", c, min(cfg.pixel_size * 2**cfg.octaves, cfg.max_size))
    for i in reversed(range(cfg.octaves)):
        c = block(f"octaves.{i}.block_out", c, _filters(cfg, i))
        u = _up_filters(cfg, i)
        shapes[f"octaves.{i}.up.kernel"] = (4, 4, c, u)
        shapes[f"octaves.{i}.up.bias"] = (u,)
        if normed:
            shapes[f"octaves.{i}.up_norm.gamma"] = (u,)
            shapes[f"octaves.{i}.up_norm.beta"] = (u,)
        c = u + skips[i]
    c = block("post_block", c, cfg.pixel_size)
    shapes["head.kernel"] = (c, out_channels)
    shapes["head.bias"] = (out_channels,)
    return shapes


def discriminator_shapes(cfg, in_channels=3):
    """``name -> shape`` of the PatchGAN discriminator: ``d_octaves`` k4/s2
    convs of ``min(base·2^i, max_size)`` filters, a norm on every conv but
    the first, a 1×1 head."""
    shapes = OrderedDict()
    base = cfg.d_pixel_size or cfg.pixel_size
    c = in_channels
    for i in range(cfg.d_octaves or cfg.octaves):
        f = min(base * 2**i, cfg.max_size)
        shapes[f"convs.{i}.kernel"] = (4, 4, c, f)
        shapes[f"convs.{i}.bias"] = (f,)
        if cfg.d_norm != "none" and i > 0:
            shapes[f"convs.{i}.norm.gamma"] = (f,)
            shapes[f"convs.{i}.norm.beta"] = (f,)
        c = f
    shapes["head.kernel"] = (c, 1)
    shapes["head.bias"] = (1,)
    return shapes


def glorot_limit(name, shape):
    """Glorot-uniform limit of a kernel (the sum of fans is the same for a
    conv and a transposed conv); None for a bias, γ or β."""
    if not name.endswith("kernel"):
        return None
    if len(shape) == 4:
        kh, kw, i, o = shape
        return math.sqrt(6.0 / (kh * kw * (i + o)))
    return math.sqrt(6.0 / (shape[0] + shape[1]))


def init_weights(shapes, generator, device, dtype=torch.float32):
    """Seeded weights in one draw on ``device``: glorot-uniform kernels, zero
    biases and β, unit γ. ``generator`` lives on ``device``."""
    total = sum(math.prod(s) for n, s in shapes.items() if glorot_limit(n, s) is not None)
    flat = torch.rand(total, generator=generator, device=device, dtype=torch.float32)
    out, at = OrderedDict(), 0
    for name, shape in shapes.items():
        limit = glorot_limit(name, shape)
        if limit is not None:
            n = math.prod(shape)
            out[name] = (flat[at:at + n].view(shape) * (2 * limit) - limit).to(dtype)
            at += n
        elif name.endswith("gamma"):
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


# ---------------------------------------------------------------- forwards


def denoiser(cfg, w, x, ops=None, rec=None, norm=False):
    """The U-Net on NCHW ``x``; ``norm``: instance norm after each k4/s2 conv
    (the GAN generator), the conv then without its ReLU."""

    def block(prefix, h):
        for n in range(cfg.block_depth):
            h = conv3(h, w[f"{prefix}.{n}.kernel"], w[f"{prefix}.{n}.bias"], ops, rec)
        return h

    def normed(h, prefix):
        if norm:
            h = instance_norm(h, w[f"{prefix}.gamma"], w[f"{prefix}.beta"], rec)
        return torch.relu(h)

    def level(i, h):
        inp = h
        h = conv_down(h, w[f"octaves.{i}.down.kernel"], w[f"octaves.{i}.down.bias"], ops, rec)
        h = block(f"octaves.{i}.block_in", normed(h, f"octaves.{i}.down_norm"))
        h = level(i + 1, h) if i + 1 < cfg.octaves else block("middle", h)
        h = block(f"octaves.{i}.block_out", h)
        h = conv_up(h, w[f"octaves.{i}.up.kernel"], w[f"octaves.{i}.up.bias"], ops, rec)
        return torch.cat([normed(h, f"octaves.{i}.up_norm"), inp], 1)

    h = block("pre_block", x)
    h = level(0, h) if cfg.octaves else block("middle", h)
    h = block("post_block", h)
    return dense(h, w["head.kernel"], w["head.bias"], ops, rec)


def discriminator(cfg, w, x, ops=None, rec=None):
    """PatchGAN logits (B, 1, h', w') of NCHW ``x``."""
    h = x
    for i in range(cfg.d_octaves or cfg.octaves):
        h = conv_down(h, w[f"convs.{i}.kernel"], w[f"convs.{i}.bias"], ops, rec)
        if f"convs.{i}.norm.gamma" in w:
            h = instance_norm(h, w[f"convs.{i}.norm.gamma"], w[f"convs.{i}.norm.beta"], rec)
        h = F.leaky_relu(h, 0.2)
    return dense(h, w["head.kernel"], w["head.bias"], ops, rec)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)
