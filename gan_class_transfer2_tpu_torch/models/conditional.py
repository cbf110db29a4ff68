"""Per-class conditioning — counterpart of
gan_class_transfer2_tpu/models/conditional.py (BASELINE config 5).

A learned class embedding (C, E) is gathered per sample, broadcast over
H×W and concatenated after the image channels; the U-Net's first conv then
mixes it everywhere. Only the ``pre_block`` 3×3 conv (or, at
``block_depth`` 0, the first down conv, whose C = 3 + E the B4 gate
refuses) sees the extra channels, so the hand-written kernels see the
shapes of the unconditional model.

``ConditionalDenoiser`` holds ``embed`` and ``unet`` under the JAX
pytree's names (``embed`` ↔ ``params["embed"]``, ``unet.octaves.0.down.kernel``
↔ ``params["unet"]["octaves"][0]["down"]["kernel"]``). The discriminator's
projection conditioning lives in models/discriminator.py.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import init as init_ops
from . import unet


class ConditionalDenoiser(nn.Module):
    """Parameters of ``init_conditional_unet`` (zeros until
    ``reset_parameters``): ``embed`` (num_classes, embed_dim) and ``unet``,
    a ``unet.Denoiser`` with ``in_channels + embed_dim`` input channels."""

    def __init__(self, cfg, num_classes: int, embed_dim: int = 8, in_channels: int = 3,
                 out_channels: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(num_classes, embed_dim))
        self.unet = unet.Denoiser(cfg, in_channels + embed_dim, out_channels)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Glorot-uniform embedding (fan_in = C, fan_out = E), then the
        U-Net's own initialisation, drawn in that order from ``generator``
        (a CPU generator; the draws are copied to the parameters' device)."""
        c, e = self.embed.shape
        self.embed.copy_(init_ops.glorot_uniform(generator, (c, e), c, e))
        self.unet.reset_parameters(generator)
        return self

    def forward(self, x, class_idx, t=None):
        return conditional_unet_apply(self.cfg, self, x, class_idx, t)


def conditional_unet_apply(cfg, model: ConditionalDenoiser, x, class_idx, t=None):
    """x: (B, H, W, C); class_idx: (B,) integer classes on x's device.
    The embedding is cast to x's dtype before the U-Net casts both to the
    compute dtype, as JAX casts it (conditional.py:48-50)."""
    b, h, w, _ = x.shape
    embed = model.embed[class_idx.long()]  # (B, E)
    embed = embed[:, None, None, :].expand(b, h, w, embed.shape[-1]).to(x.dtype)
    return unet.unet_apply(cfg, model.unet, torch.cat([x, embed], dim=-1), t)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
