"""Denoiser entry points — counterpart of gan_class_transfer2_tpu/models/api.py:
the unconditional U-Net (the reference model) or, with ``cfg.num_classes >
0``, the class-conditional one (models/conditional.py, BASELINE config 5),
chosen by ``init_denoiser`` from the config and by ``apply_denoiser`` from
the module's type."""

from __future__ import annotations

import torch

from . import conditional, unet


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


def build_denoiser(cfg, in_channels: int = 3, out_channels=None):
    """The denoiser module ``cfg`` describes, zero-filled on the CPU."""
    if cfg.num_classes > 0:
        return conditional.ConditionalDenoiser(cfg, cfg.num_classes, cfg.class_embed_dim,
                                               in_channels, out_channels)
    return unet.Denoiser(cfg, in_channels, out_channels)


def init_denoiser(cfg, generator: torch.Generator | None = None, device="cuda",
                  in_channels: int = 3, out_channels=None):
    """A Glorot-initialised denoiser on ``device``; the draws come from
    ``generator`` (a CPU generator seeded with ``cfg.seed`` by default)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = build_denoiser(cfg, in_channels, out_channels)
    return model.reset_parameters(generator).to(dev)


def apply_denoiser(cfg, model, x, t=None, class_idx=None):
    """The forward of either model; a conditional one without ``class_idx``
    takes class 0 for every sample (api.py:25-30)."""
    if isinstance(model, conditional.ConditionalDenoiser):
        if class_idx is None:
            class_idx = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
        return conditional.conditional_unet_apply(cfg, model, x, class_idx, t)
    return unet.unet_apply(cfg, model, x, t)
