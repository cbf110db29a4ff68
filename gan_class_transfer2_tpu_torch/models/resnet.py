"""The published CycleGAN's ResNet generator (Zhu et al., arXiv 1703.10593;
the authors' ``ResnetGenerator`` in pytorch-CycleGAN-and-pix2pix
``models/networks.py``, no dropout), with ``cfg.pixel_size`` = ngf,
``cfg.octaves`` = its down and up convs and ``cfg.resnet_blocks`` residual
blocks; widths ``f_i = min(pixel_size·2^i, max_size)``. At ngf 64, two
octaves and nine blocks (c7s1-64, d128, d256, R256 ×9, u128, u64, c7s1-3)
it holds 11,378,179 parameters:

  * ``stem``: 7×7/s1 conv behind a reflection pad of 3, 3 → f_0;
  * ``downs.i``: 3×3/s2 conv, zero pad 1, f_i → f_{i+1};
  * ``blocks.j``: ``x + norm(conv_b(relu(norm(conv_a(x)))))``, each conv
    3×3/s1 behind a reflection pad of 1, at the trunk's width f_octaves;
  * ``ups.i``: 3×3/s2 transposed conv, pad 1, output pad 1, f_{i+1} → f_i;
  * ``head``: 7×7/s1 conv behind a reflection pad of 3, f_0 → 3, then tanh.

Every conv but the head is followed by an instance norm without γ or β (the
authors' ``InstanceNorm2d(affine=False)``: B3 with no affine, ops/norm.py)
and, but after ``conv_b``, a ReLU; every conv has a bias, as the authors'
convs do ahead of an instance norm (``use_bias``). Parameters are float32
under the port's naming, kernels
HWIO (the transposed convs' in dataflow orientation, I = input channels),
cast to ``cfg.compute_dtype`` at apply; ``reset_parameters`` draws them
N(0, 0.02) with zero biases (the authors' ``init_weights``). The nine blocks
of each forward run inside the span ``resnet.trunk``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops import init as init_ops
from ..ops import norm as norm_ops
from ..parallel import tensor
from ..utils import profiler
from .unet import DTYPES, Conv, ieee_fp32


class ResBlock(nn.Module):
    """One residual block's two 3×3 convs, ``conv_a`` and ``conv_b``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_a = Conv((3, 3, c, c))
        self.conv_b = Conv((3, 3, c, c))


class ResnetGenerator(nn.Module):
    """Parameters of the ResNet generator (zeros until ``reset_parameters``)."""

    def __init__(self, cfg, in_channels: int = 3, out_channels: int = 3):
        super().__init__()
        f = [cfg.octave_filters(i) for i in range(cfg.octaves + 1)]
        self.stem = Conv((7, 7, in_channels, f[0]))
        self.downs = nn.ModuleList(Conv((3, 3, f[i], f[i + 1])) for i in range(cfg.octaves))
        self.blocks = nn.ModuleList(ResBlock(f[-1]) for _ in range(cfg.resnet_blocks))
        self.ups = nn.ModuleList(Conv((3, 3, f[i + 1], f[i]))
                                 for i in reversed(range(cfg.octaves)))
        self.head = Conv((7, 7, f[0], out_channels))

    def reset_parameters(self, generator: torch.Generator):
        """N(0, 0.02) kernels and zero biases, drawn from ``generator`` (a CPU
        generator; the draws are copied to the parameters' device) in
        ``parameters()`` order."""
        return init_ops.normal_reset(self, generator)


def _conv(layer, dtype, h, **kw):
    return tensor.layer_apply(layer, dtype,
                              lambda x, k, b: conv_ops.conv2d_padded(x, k, b, **kw), h)


def _norm_relu(h):
    return torch.relu(norm_ops.instance_norm(h, None, None))


def resnet_apply(cfg, model: ResnetGenerator, x):
    """Forward pass: ``x`` (B, H, W, 3) in [−1, 1) → (B, H, W, 3) in (−1, 1),
    in ``cfg.compute_dtype``. H and W divide by 2^octaves."""
    dtype = DTYPES[cfg.compute_dtype]
    with ieee_fp32(dtype, x.device):
        h = _norm_relu(_conv(model.stem, dtype, x.to(dtype), pad=3, reflect=True))
        for layer in model.downs:
            h = _norm_relu(_conv(layer, dtype, h, stride=2, pad=1))
        with profiler.annotate("resnet.trunk"):
            for block in model.blocks:
                r = _norm_relu(_conv(block.conv_a, dtype, h, pad=1, reflect=True))
                h = h + norm_ops.instance_norm(
                    _conv(block.conv_b, dtype, r, pad=1, reflect=True), None, None)
        for layer in model.ups:
            h = _norm_relu(tensor.layer_apply(layer, dtype, conv_ops.conv2d_transpose_padded, h))
        return torch.tanh(_conv(model.head, dtype, h, pad=3, reflect=True))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
