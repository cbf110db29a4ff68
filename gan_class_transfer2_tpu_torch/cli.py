"""Command-line interface of the port — counterpart of the ``sample``,
``edit``, ``bench`` and ``profile`` commands of gan_class_transfer2_tpu/cli.py,
with the same flag names for the Config fields they read:

    python -m gan_class_transfer2_tpu_torch.cli sample --weights w.npz --out samples/
    python -m gan_class_transfer2_tpu_torch.cli edit --input photo.png --weights w.npz
    python -m gan_class_transfer2_tpu_torch.cli bench --batch-size 16 --bench-steps 10
    python -m gan_class_transfer2_tpu_torch.cli profile --model gan \
        --g-norm instance --d-norm instance --conv-impl pallas --batch-size 16

``bench`` trains ``--bench-steps`` steps (after 3 untimed ones) on a
synthetic batch resident on the device and prints one JSON line with the
JAX package's keys (img/s, step ms, MFU). ``profile`` runs two warm training
steps of the diffusion model or the cycle-GAN, then ``--profile-steps``
steps under ``torch.profiler``, and prints one JSON row per CUDA kernel and
a summary line with the JAX package's keys.

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

# the Config fields that sample, edit, bench and profile read
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
    # GAN mode
    "gan_loss", "adversarial_weight", "cycle_weight", "identity_weight",
    "reconstruction_weight", "d_learning_rate", "d_pixel_size", "d_octaves",
    "patch_discriminator", "d_norm", "g_norm", "r1_weight", "diffaug",
    "cycle_weight_final", "identity_weight_final", "loss_anneal_steps",
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
    for cmd in ("sample", "edit", "bench", "profile"):
        p = sub.add_parser(cmd)
        p.add_argument("--config", type=str, default=None, help="config JSON")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        _add_config_args(p)
        if cmd == "bench":
            p.add_argument("--bench-steps", type=int, default=30)
            continue
        if cmd == "profile":
            p.add_argument("--model", type=str, default="diffusion",
                           choices=("diffusion", "gan", "cgan"),
                           help="which training step to trace")
            p.add_argument("--profile-steps", type=int, default=3)
            p.add_argument("--top", type=int, default=25,
                           help="kernel rows to print from the trace")
            p.add_argument("--trace-dir", type=str, default=None,
                           help="where trace.json lands (default: a fresh temp dir)")
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
    if args.command == "profile":
        return _profile(cfg, args)
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


def _profile(cfg: Config, args) -> int:
    """Trace N training steps and print the CUDA kernel breakdown (the JAX
    CLI's ``_profile``, cli.py:854-934). Each step draws fresh
    ``[-1, 1)`` batches from ``np.random.default_rng(cfg.seed)`` on the host,
    so every timed step includes their draw and host-to-device copy, as the
    JAX command's does."""
    import json
    import tempfile

    from .models.api import resolve_device
    from .utils import profiler

    device = resolve_device(args.device)
    rng = np.random.default_rng(cfg.seed)

    def batch():
        x = rng.uniform(-1, 1, (cfg.batch_size, cfg.size, cfg.size, 3)).astype(np.float32)
        return torch.from_numpy(x).to(device)

    generator = torch.Generator(device=device).manual_seed(1)
    if args.model == "diffusion":
        from .train import trainer

        state = trainer.init_state(cfg, device=device)
        step = trainer.make_train_step(cfg)

        def run(s):
            s, loss = step(s, batch(), generator)
            return s, {"loss": loss}
    elif args.model == "gan":
        from .train import gan

        state = gan.init_gan_state(cfg, device=device)
        step = gan.make_gan_train_step(cfg)

        def run(s):
            return step(s, batch(), batch(), generator)
    else:
        raise NotImplementedError(
            "profile --model cgan: the conditional GAN (models/conditional.py, "
            "train/conditional_gan.py) is not ported to PyTorch yet")

    def sync(metrics):
        return float(next(iter(metrics.values())))

    for _ in range(2):  # warm steps, outside the trace
        state, metrics = run(state)
        sync(metrics)
    n = max(args.profile_steps, 1)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="gct2_torch_profile_")
    timer = profiler.StepTimer()
    with profiler.trace(trace_dir) as prof:
        timer.start()
        for _ in range(n):
            state, metrics = run(state)
        timer.lap(sync(metrics))
    rows = profiler.device_ops(prof, top=args.top)
    for r in rows:
        r["ms_per_step"] = r.pop("ms") / n
        print(json.dumps(r))
    wall = timer.times[0] / n
    busy = profiler.device_busy_ms(prof) / n if device.type == "cuda" else None
    print(json.dumps({
        "command": "profile", "model": args.model, "steps": n,
        "wall_ms_per_step": wall * 1000,
        "images_per_sec": cfg.batch_size / wall,
        "trace_dir": trace_dir,
        "device_rows": len(rows),
        "note": ("wall time includes each step's host batch draw and copy, and the "
                 "profiler's overhead" if rows else
                 "no CUDA kernels traced (CPU run); trace.json kept at trace_dir"),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "device_busy_ms_per_step": busy,
        "final": {k: float(v) for k, v in metrics.items()},
    }))
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
