"""Command-line interface of the port — counterpart of the ``train``,
``gan-train``, ``sample``, ``edit``, ``export-weights``, ``eval``,
``build-cache``, ``bench`` and ``profile`` commands of
gan_class_transfer2_tpu/cli.py, with the same flag names for the Config
fields they read:

    python -m gan_class_transfer2_tpu_torch.cli train --dataset-pattern 'data/*.png' \
        --batch-size 16 --checkpoint-dir ckpt --log-dir logs
    python -m gan_class_transfer2_tpu_torch.cli gan-train --classes 'a/*.png' 'b/*.png' \
        --g-norm instance --d-norm instance --conv-impl pallas
    python -m gan_class_transfer2_tpu_torch.cli sample --checkpoint-dir ckpt --out samples/
    python -m gan_class_transfer2_tpu_torch.cli edit --input photo.png --checkpoint-dir ckpt
    python -m gan_class_transfer2_tpu_torch.cli export-weights --checkpoint-dir ckpt --out w.npz
    python -m gan_class_transfer2_tpu_torch.cli eval --checkpoint-dir ckpt --fid-samples 64
    python -m gan_class_transfer2_tpu_torch.cli build-cache --dataset-pattern 'data/*.png' \
        --out data.gct2cache
    python -m gan_class_transfer2_tpu_torch.cli bench --batch-size 16 --bench-steps 10
    python -m gan_class_transfer2_tpu_torch.cli profile --model gan \
        --g-norm instance --d-norm instance --conv-impl pallas --batch-size 16

``train`` and ``gan-train`` run ``train/loop.Runner`` and
``train/gan_loop.GANRunner``: files in, checkpoints and TensorBoard events
out, resuming from ``--checkpoint-dir`` when it holds a checkpoint;
``--resilient N`` restarts from the last checkpoint after a failed step.
One process on one card: ``--coordinator``, ``--num-processes`` and
``--process-id`` are refused. ``bench`` trains ``--bench-steps`` steps
(after 3 untimed ones) on a synthetic batch resident on the device and
prints one JSON line with the JAX package's keys (img/s, step ms, MFU).
``profile`` runs two warm training steps of the diffusion model or the
cycle-GAN, then ``--profile-steps`` steps under ``torch.profiler``, and
prints one JSON row per CUDA kernel and a summary line.

``eval`` scores the latest checkpoint in ``--checkpoint-dir`` without
training (``--model diffusion``: FID/KID of ``fid_samples`` samples against
the held-out files; ``--model gan``: the transfer FID/KID pairs) through the
runners' own held-out split, and prints one JSON line with the JAX
command's keys. ``build-cache`` packs the dataset into the native loader's
uint8 cache file (``data/cache.py``).

``sample``, ``edit``, ``export-weights`` and ``eval`` read the latest checkpoint in
``--checkpoint-dir`` (its EMA params when it has them) and inherit the
``config.json`` saved there, as the JAX CLI does; ``sample`` and ``edit``
also take ``--weights``, a flat Keras-order ``.npz`` as ``export-weights``
writes it. With neither they warn and run on randomly initialised weights
drawn from ``--seed``.

``--device`` is ``cuda`` (the default) or ``cpu``; ``cuda`` without a card
raises.
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

# the Config fields that the commands read
_FIELDS = (
    "size", "pixel_size", "max_size", "block_depth", "octaves", "skip_mode",
    "per_step_output", "steps", "schedule", "parameterization", "test_step",
    "bits_per_pixel", "sample_stride", "compute_dtype", "conv_impl",
    "concat_elision", "remat", "seed",
    # data
    "dataset_pattern", "example_image_path", "classes", "shuffle_buffer", "cache",
    "native_loader", "data_workers", "data_hbm",
    # training
    "batch_size", "optimizer", "moment_dtype", "learning_rate", "warm_up",
    "lr_schedule", "inverse_time_decay_steps", "adam_eps", "momentum", "nesterov",
    "weight_decay", "ema_decay", "grad_clip_norm", "grad_accum", "loss",
    "prediction_weighting", "loss_scale", "dynamic_loss_scale",
    "loss_scale_growth_interval", "fused_diffusion", "steps_per_epoch", "epochs",
    "host_sync_every", "mesh_data",
    # GAN mode
    "gan_loss", "adversarial_weight", "cycle_weight", "identity_weight",
    "reconstruction_weight", "d_learning_rate", "d_pixel_size", "d_octaves",
    "patch_discriminator", "d_norm", "g_norm", "r1_weight", "diffaug",
    "cycle_weight_final", "identity_weight_final", "loss_anneal_steps",
    # io
    "log_dir", "checkpoint_dir", "checkpoint_every", "checkpoint_keep",
    "checkpoint_async", "keep_best", "log_images_every", "fid_samples", "fid_extractor",
)
# the commands that read a checkpoint, and so inherit its config.json
_READS_CHECKPOINT = ("sample", "edit", "export-weights", "eval")


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
        elif name == "classes":
            p.add_argument(flag, type=str, nargs="*", default=None)
        else:
            p.add_argument(flag, type=str, default=None)


def config_from_args(args, checkpoint_config: bool = False) -> Config:
    """Explicit flags > --config JSON > (with ``checkpoint_config``, for the
    commands that read a checkpoint) the config.json that training saved in
    the checkpoint dir > dataclass defaults. A restore rebuilds the state
    the checkpoint was written with (its optimizer, moments, EMA), so the
    saved config is the right base for the flags the user left out."""
    overrides = {n: getattr(args, n) for n in _FIELDS if getattr(args, n, None) is not None}
    if "classes" in overrides:
        overrides["classes"] = tuple(overrides["classes"])
    base = None
    if getattr(args, "config", None):
        with open(args.config) as fh:
            base = Config.from_json(fh.read())
    elif checkpoint_config:
        from .utils.checkpoint import load_config

        ckpt_dir = overrides.get("checkpoint_dir", Config.checkpoint_dir)
        if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "config.json")):
            # restore from the dir the config was found in, not the path
            # the training run wrote it under
            base = load_config(ckpt_dir).replace(checkpoint_dir=ckpt_dir)
    if base is not None:
        return base.replace(**overrides).validate()
    return Config(**overrides).validate()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_class_transfer2_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in ("train", "gan-train", "sample", "edit", "export-weights", "eval",
                "build-cache", "bench", "profile"):
        p = sub.add_parser(cmd)
        p.add_argument("--config", type=str, default=None, help="config JSON")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        _add_config_args(p)
        if cmd in ("train", "gan-train"):
            p.add_argument("--resilient", type=int, default=0, metavar="N",
                           help="restart up to N times from the last checkpoint on a "
                                "step failure (requires --checkpoint-dir)")
            # multi-host launch flags of the JAX CLI, refused below
            p.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT")
            p.add_argument("--num-processes", type=int, default=None)
            p.add_argument("--process-id", type=int, default=None)
        elif cmd == "bench":
            p.add_argument("--bench-steps", type=int, default=30)
        elif cmd == "profile":
            p.add_argument("--model", type=str, default="diffusion",
                           choices=("diffusion", "gan", "cgan"),
                           help="which training step to trace")
            p.add_argument("--profile-steps", type=int, default=3)
            p.add_argument("--top", type=int, default=25,
                           help="kernel rows to print from the trace")
            p.add_argument("--trace-dir", type=str, default=None,
                           help="where trace.json lands (default: a fresh temp dir)")
        elif cmd == "eval":
            p.add_argument("--model", type=str, default="diffusion",
                           choices=("diffusion", "gan", "cgan"),
                           help="which runner's quality metric to score (held-out FID "
                                "for diffusion, transfer-FID pairs for gan)")
        elif cmd == "build-cache":
            p.add_argument("--out", type=str, required=True, help="cache file path")
            p.add_argument("--store", type=int, default=0,
                           help="stored image side (default: size + size/8)")
        elif cmd == "export-weights":
            p.add_argument("--out", type=str, default="weights.npz",
                           help="npz of the flat weights in Keras build order")
        else:
            p.add_argument("--weights", type=str, default=None, metavar="FILE.npz",
                           help="flat Keras-order weights (export-weights); without it "
                                "the latest checkpoint in --checkpoint-dir")
            if cmd == "sample":
                p.add_argument("--out", type=str, default="samples")
                p.add_argument("--num", type=int, default=6)
            else:
                p.add_argument("--input", type=str, required=True, help="image path")
                p.add_argument("--out", type=str, default="edited")
                p.add_argument("--edits", type=str, nargs="*",
                               default=["pixelate", "shift", "quantise"])
    args = parser.parse_args(argv)
    if any(getattr(args, f, None) is not None
           for f in ("coordinator", "num_processes", "process_id")):
        raise NotImplementedError(
            "--coordinator/--num-processes/--process-id: multi-host training "
            "(parallel/multihost.py) is not ported to PyTorch yet; the port trains in one "
            "process on one card")
    cfg = config_from_args(args, checkpoint_config=args.command in _READS_CHECKPOINT
                           and not getattr(args, "weights", None))
    if args.command in ("train", "gan-train"):
        return _train(cfg, args)
    if args.command == "sample":
        return _sample(cfg, args)
    if args.command == "edit":
        return _edit(cfg, args)
    if args.command == "export-weights":
        return _export_weights(cfg, args)
    if args.command == "eval":
        return _eval(cfg, args)
    if args.command == "build-cache":
        from .data import native_loader

        store = args.store or cfg.size + cfg.size // 8
        n = native_loader.build_cache(cfg.dataset_pattern, store, args.out)
        print(f"wrote {n} records ({store}x{store}x3 uint8) to {args.out}")
        return 0
    if args.command == "bench":
        from .utils.benchmark import run_benchmark

        print(run_benchmark(cfg, steps=args.bench_steps, device=args.device).to_json())
        return 0
    return _profile(cfg, args)


def _train(cfg: Config, args) -> int:
    if args.command == "train":
        from .train.loop import Runner

        runner = Runner(cfg, device=args.device)
    else:
        from .train.gan_loop import GANRunner

        runner = GANRunner(cfg, device=args.device)
    try:
        if args.resilient > 0:
            runner.fit_resilient(max_restarts=args.resilient)
        else:
            runner.fit()
    finally:
        runner.close()
    return 0


def _load_model(cfg: Config, weights, device):
    """The denoiser ``sample`` and ``edit`` run: from ``--weights``, else
    the latest checkpoint's EMA params (its params without an EMA), else
    random weights from ``--seed`` with a warning."""
    from .models import api as model_api
    from .models import unet
    from .utils import checkpoint as ckpt_lib
    from .utils import weights as weights_lib

    device = model_api.resolve_device(device)
    if weights:
        model = unet.Denoiser(cfg)
        weights_lib.import_flat_weights(model, weights_lib.load_flat_npz(weights))
        return model.to(device)
    if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None:
        return _restored_model(cfg, device)[0]
    print(f"warning: no --weights given and no checkpoint in {cfg.checkpoint_dir!r}; "
          "using randomly initialised weights", file=sys.stderr)
    return model_api.init_denoiser(cfg, device=device)


def _restored_model(cfg: Config, device):
    """(denoiser, step) of the latest checkpoint in ``cfg.checkpoint_dir``:
    the train state is rebuilt from the config, restored, and its EMA
    params taken when present (JAX cli.py:951-960)."""
    from .train import trainer
    from .utils import checkpoint as ckpt_lib

    state = ckpt_lib.restore(cfg.checkpoint_dir, trainer.init_state(cfg, device=device))
    return trainer.eval_model(state), state.step


def _export_weights(cfg: Config, args) -> int:
    """The flat Keras-order npz of the latest checkpoint's weights (EMA when
    kept), as the JAX CLI's ``export-weights`` writes it."""
    from .models.api import resolve_device
    from .utils import checkpoint as ckpt_lib
    from .utils import weights as weights_lib

    if not (cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None):
        raise SystemExit(f"no checkpoint found in {cfg.checkpoint_dir!r} "
                         "(export needs trained weights)")
    model, step = _restored_model(cfg, resolve_device(args.device))
    flat = weights_lib.export_flat_weights(model)
    weights_lib.save_flat_npz(args.out, flat)
    print(f"wrote {len(flat)} weights (step {step}, Keras build order) to {args.out}")
    return 0


def _eval(cfg: Config, args) -> int:
    """Score a checkpoint's quality metric without training (the JAX CLI's
    ``_eval``, cli.py:773-851): one JSON line. The runners log into a
    temporary directory, removed afterwards."""
    import json
    import shutil
    import tempfile

    from .utils import checkpoint as ckpt_lib

    if cfg.fid_samples <= 0:
        raise SystemExit("eval requires fid_samples > 0")
    if args.model == "cgan":
        raise NotImplementedError(
            "eval --model cgan: the conditional GAN (models/conditional.py, "
            "train/conditional_gan_loop.py) is not ported to PyTorch yet")
    if not (cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None):
        print(f"warning: no checkpoint found in {cfg.checkpoint_dir!r}; "
              "scoring randomly initialised weights", file=sys.stderr)
    out = {"command": "eval", "model": args.model, "fid_extractor": cfg.fid_extractor}
    scratch = tempfile.mkdtemp(prefix="gct2_eval_logs_")
    try:
        if args.model == "diffusion":
            from .train.loop import Runner

            runner = Runner(cfg, log_dir=scratch, device=args.device)
            try:
                out["step"] = int(runner.state.step)
                scores = runner.quality_scores()
                # None = degenerate eval set (< 2 images): nulls, not a crash
                out["fid"] = None if scores is None else float(scores["fid"])
                out["kid"] = None if scores is None else float(scores["kid"])
            finally:
                runner.close()
        else:
            from .train.gan_loop import GANRunner

            runner = GANRunner(cfg, log_dir=scratch, device=args.device)
            try:
                out["step"] = int(runner.state.step)
                for d in ("ab", "ba"):
                    scores = runner.transfer_scores(d)
                    if scores is not None:
                        out[f"transfer_fid_{d}"] = float(scores["fid"])
                        out[f"transfer_kid_{d}"] = float(scores["kid"])
            finally:
                runner.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(out))
    return 0


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
    """An image file as float32 (size, size, 3) in [-1, 1): RGB, the center
    crop when larger (the user edits the picture they see), no flip, refused
    when smaller; PNGs need no Pillow."""
    from .data import pipeline

    return pipeline.decode_image(path, size, np.random.default_rng(0), crop=True, flip=False,
                                 center=True)


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
