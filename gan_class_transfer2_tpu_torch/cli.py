"""Command-line interface of the port — counterpart of the ``sample``,
``edit`` and ``bench`` commands of gan_class_transfer2_tpu/cli.py, with the
same flag names for the Config fields they read:

    python -m gan_class_transfer2_tpu_torch.cli sample --weights w.npz --out samples/
    python -m gan_class_transfer2_tpu_torch.cli edit --input photo.png --weights w.npz
    python -m gan_class_transfer2_tpu_torch.cli bench --batch-size 16 --bench-steps 10

``bench`` trains ``--bench-steps`` steps (after 3 untimed ones) on a
synthetic batch resident on the device and prints one JSON line with the
JAX package's keys (img/s, step ms, MFU).

``--device`` is ``cuda`` (the default) or ``cpu``; ``cuda`` without a card
raises. ``--weights`` is a flat Keras-order ``.npz`` as the JAX CLI's
``export-weights`` writes it; without it the command warns and runs on
randomly initialised weights drawn from ``--seed``. Orbax checkpoints are
not read yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .config import Config

# the Config fields that sample, edit and bench read
_FIELDS = (
    "size", "pixel_size", "max_size", "block_depth", "octaves", "skip_mode",
    "per_step_output", "steps", "schedule", "parameterization",
    "bits_per_pixel", "sample_stride", "compute_dtype", "conv_impl",
    "concat_elision", "seed",
    # training
    "batch_size", "optimizer", "moment_dtype", "learning_rate", "warm_up",
    "lr_schedule", "inverse_time_decay_steps", "adam_eps", "momentum", "nesterov",
    "weight_decay", "ema_decay", "grad_clip_norm", "grad_accum", "loss",
    "prediction_weighting", "loss_scale", "dynamic_loss_scale",
    "loss_scale_growth_interval", "fused_diffusion", "steps_per_epoch", "epochs",
)


def _add_config_args(p: argparse.ArgumentParser):
    defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    for name in _FIELDS:
        flag = "--" + name.replace("_", "-")
        default = defaults[name]
        if isinstance(default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None, metavar="BOOL")
        elif isinstance(default, int):
            p.add_argument(flag, type=int, default=None)
        elif isinstance(default, float):
            p.add_argument(flag, type=float, default=None)
        else:
            p.add_argument(flag, type=str, default=None)


def config_from_args(args) -> Config:
    """Explicit flags > --config JSON > dataclass defaults."""
    overrides = {n: getattr(args, n) for n in _FIELDS if getattr(args, n) is not None}
    if args.config:
        with open(args.config) as fh:
            return Config.from_json(fh.read()).replace(**overrides).validate()
    return Config(**overrides).validate()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_class_transfer2_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in ("sample", "edit", "bench"):
        p = sub.add_parser(cmd)
        p.add_argument("--config", type=str, default=None, help="config JSON")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        _add_config_args(p)
        if cmd == "bench":
            p.add_argument("--bench-steps", type=int, default=30)
            continue
        p.add_argument("--weights", type=str, default=None, metavar="FILE.npz",
                       help="flat Keras-order weights (JAX CLI export-weights)")
        if cmd == "sample":
            p.add_argument("--out", type=str, default="samples")
            p.add_argument("--num", type=int, default=6)
        else:
            p.add_argument("--input", type=str, required=True, help="image path")
            p.add_argument("--out", type=str, default="edited")
            p.add_argument("--edits", type=str, nargs="*",
                           default=["pixelate", "shift", "quantise"])
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.command == "sample":
        return _sample(cfg, args)
    if args.command == "bench":
        from .utils.benchmark import run_benchmark

        print(run_benchmark(cfg, steps=args.bench_steps, device=args.device).to_json())
        return 0
    return _edit(cfg, args)


def _load_model(cfg: Config, weights, device):
    from .models import api as model_api
    from .models import unet
    from .utils import weights as weights_lib

    device = model_api.resolve_device(device)
    if weights:
        model = unet.Denoiser(cfg)
        weights_lib.import_flat_weights(model, weights_lib.load_flat_npz(weights))
        return model.to(device)
    print("warning: no --weights given; using randomly initialised weights",
          file=sys.stderr)
    return model_api.init_denoiser(cfg, device=device)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(cfg: Config, args) -> int:
    from .sample import sampler
    from .utils import png

    model = _load_model(cfg, args.weights, args.device)
    device = next(model.parameters()).device
    rng = np.random.default_rng(cfg.seed)  # the JAX CLI's init batch, exactly
    batch = torch.from_numpy(
        rng.normal(size=(args.num, cfg.size, cfg.size, 3)).astype(np.float32)
    ).to(device)
    _synchronize(device)
    t0 = time.perf_counter()
    images = sampler.sample(cfg, model, batch, snapshots=False).images
    _synchronize(device)
    ms = (time.perf_counter() - t0) * 1000 / args.num
    images = images.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    for i, img in enumerate(images):
        png.write_png(os.path.join(args.out, f"sample_{i}.png"), png.to_uint8(img))
    print(f"wrote {len(images)} samples to {args.out} "
          f"({ms:.3f} ms per image on {device.type})")
    return 0


def decode_image(path, size: int) -> np.ndarray:
    """An image file as float32 (size, size, 3) in [-1, 1): RGB, center crop
    when larger (the user edits the picture they see), refused when smaller."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    h, w = arr.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {arr.shape} smaller than crop {size}")
    i, j = (h - size) // 2, (w - size) // 2
    return arr[i : i + size, j : j + size].astype(np.float32) / 128.0 - 1.0


def _edit(cfg: Config, args) -> int:
    from .sample import sampler
    from .utils import png

    model = _load_model(cfg, args.weights, args.device)
    device = next(model.parameters()).device
    image = torch.from_numpy(decode_image(args.input, cfg.size))[None].to(device)
    results = sampler.edit_image(cfg, model, image, tuple(args.edits))
    os.makedirs(args.out, exist_ok=True)
    for name, out in results.items():
        png.write_png(os.path.join(args.out, f"{name}.png"), png.to_uint8(out[0].cpu()))
    print(f"wrote {len(results)} edits to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
