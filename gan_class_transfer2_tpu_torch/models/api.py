"""Denoiser entry points — counterpart of gan_class_transfer2_tpu/models/api.py,
for the unconditional model (the class-conditional one is not ported yet;
``Config.validate`` refuses ``num_classes > 0``)."""

from __future__ import annotations

import torch

from . import unet


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU. Asking for ``cuda`` without a card raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' / --device cpu to run on the CPU)"
        )
    return dev


def init_denoiser(cfg, generator: torch.Generator | None = None, device="cuda",
                  in_channels: int = 3, out_channels=None) -> unet.Denoiser:
    """A Glorot-initialised Denoiser on ``device``; the draws come from
    ``generator`` (a CPU generator seeded with ``cfg.seed`` by default)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = unet.Denoiser(cfg, in_channels, out_channels)
    return model.reset_parameters(generator).to(dev)


def apply_denoiser(cfg, model: unet.Denoiser, x, t=None):
    return unet.unet_apply(cfg, model, x, t)
