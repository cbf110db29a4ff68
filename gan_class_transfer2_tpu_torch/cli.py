"""Command-line interface of the port — counterpart of the ``train``,
``gan-train``, ``cgan-train``, ``sample``, ``edit``, ``export-weights``,
``export-model``, ``distill``, ``eval``, ``build-cache``, ``bench``,
``profile`` and ``serve`` commands of gan_class_transfer2_tpu/cli.py, with
the same flag names for the Config fields they read:

    python -m gan_class_transfer2_tpu_torch.cli train --dataset-pattern 'data/*.png' \
        --batch-size 16 --checkpoint-dir ckpt --log-dir logs
    python -m gan_class_transfer2_tpu_torch.cli gan-train --classes 'a/*.png' 'b/*.png' \
        --g-norm instance --d-norm instance --conv-impl pallas
    python -m gan_class_transfer2_tpu_torch.cli train --classes 'a/*.png' 'b/*.png' 'c/*.png' \
        --num-classes 3 --checkpoint-dir cckpt
    python -m gan_class_transfer2_tpu_torch.cli cgan-train --classes 'a/*.png' 'b/*.png' \
        'c/*.png' --g-norm instance --d-norm instance --checkpoint-dir cgckpt
    python -m gan_class_transfer2_tpu_torch.cli sample --checkpoint-dir ckpt --out samples/
    python -m gan_class_transfer2_tpu_torch.cli sample --checkpoint-dir cckpt --class-idx 2
    python -m gan_class_transfer2_tpu_torch.cli edit --input photo.png --checkpoint-dir ckpt
    python -m gan_class_transfer2_tpu_torch.cli export-weights --checkpoint-dir ckpt --out w.npz
    python -m gan_class_transfer2_tpu_torch.cli distill --checkpoint-dir ckpt --out student \
        --target-stride 2 --distill-steps 2000
    python -m gan_class_transfer2_tpu_torch.cli export-model --checkpoint-dir ckpt --out bundle/
    python -m gan_class_transfer2_tpu_torch.cli sample --bundle bundle/ --out samples/
    python -m gan_class_transfer2_tpu_torch.cli eval --checkpoint-dir ckpt --fid-samples 64
    python -m gan_class_transfer2_tpu_torch.cli build-cache --dataset-pattern 'data/*.png' \
        --out data.gct2cache
    python -m gan_class_transfer2_tpu_torch.cli bench --batch-size 16 --bench-steps 10
    python -m gan_class_transfer2_tpu_torch.cli profile --model gan \
        --g-norm instance --d-norm instance --conv-impl pallas --batch-size 16
    python -m gan_class_transfer2_tpu_torch.cli serve --checkpoint-dir ckpt --port 8080 \
        --model diffusion --frontend threaded
    python -m gan_class_transfer2_tpu_torch.cli serve --bundle bundle/ --port 8080

``train``, ``gan-train`` and ``cgan-train`` run ``train/loop.Runner``,
``train/gan_loop.GANRunner`` and
``train/conditional_gan_loop.ConditionalGANRunner``: files in, checkpoints
and TensorBoard events
out, resuming from ``--checkpoint-dir`` when it holds a checkpoint;
``--resilient N`` restarts from the last checkpoint after a failed step.
``--coordinator HOST:PORT --num-processes N --process-id K`` makes the
process rank K of an N-process data-parallel job (``train``, ``gan-train``,
``cgan-train`` and ``distill``; ``parallel/multihost.py``:
gloo on the CPU and for ranks that share a card, nccl when each has its
own); start one such process per rank, e.g. on one host

    for k in 0 1; do python -m gan_class_transfer2_tpu_torch.cli train \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id $k \
        --batch-size 16 --checkpoint-dir ckpt & done; wait

``--batch-size`` is the global batch; each rank reads its share of the
files and its rows of the batch, only rank 0 writes, and ``--zero1 true``
slices the optimizer state over the ranks. ``bench`` trains ``--bench-steps`` steps
(after 3 untimed ones) on a synthetic batch resident on the device and
prints one JSON line with the JAX package's keys (img/s, step ms, MFU).
``train`` with ``--num-classes`` > 0 trains the class-conditional denoiser on
round-robin labeled batches of ``--classes``; ``sample`` and ``edit`` take
``--class-idx`` on such a checkpoint. ``profile`` runs two warm training
steps of the diffusion model, the cycle-GAN or the conditional GAN, then
``--profile-steps`` steps under ``torch.profiler``, and
prints one JSON row per CUDA kernel and a summary line.

``eval`` scores the latest checkpoint in ``--checkpoint-dir`` without
training (``--model diffusion``: FID/KID of ``fid_samples`` samples against
the held-out files; ``--model gan``: the transfer FID/KID pairs; ``--model
cgan``: every ordered class pair's) through the
runners' own held-out split, and prints one JSON line with the JAX
command's keys. ``build-cache`` packs the dataset into the native loader's
uint8 cache file (``data/cache.py``).

``serve`` answers HTTP requests (``serve/server.py``: /sample, /denoise,
/edit, /transfer, /reload, /metrics) from the latest checkpoint in
``--checkpoint-dir``, a diffusion model (``--model diffusion``, conditional or
not), a cycle-GAN (``--model gan``) or a conditional GAN (``--model cgan``,
``/transfer?to=K``), through the threaded or the asyncio frontend
(``--frontend threaded|aio``); ``serve --bundle`` serves a compiled bundle
instead (``/sample``, ``/denoise``, ``/transfer`` from its programs; the
config and weights come from the artifact, explicit flags override its
serving knobs).

``distill`` trains a student of the latest checkpoint's EMA that samples at
twice the stride per round (``train/distill.py``) and writes it as a
checkpoint to ``--out``, whose ``config.json`` carries the new
``sample_stride``. ``export-model`` writes a bundle of the latest checkpoint
(``utils/bundle.py``: ``torch.export`` programs with the weights inside);
``sample --bundle`` samples from one, with no checkpoint and no model build.

``sample``, ``edit``, ``export-weights``, ``export-model``, ``distill``,
``eval`` and ``serve`` read the latest checkpoint in ``--checkpoint-dir``
(its EMA params when it has them) and inherit the
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
    "per_step_output", "steps", "num_classes", "class_embed_dim", "schedule",
    "parameterization", "test_step",
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
    "host_sync_every", "mesh_data", "zero1",
    # GAN mode
    "gan_loss", "adversarial_weight", "cycle_weight", "identity_weight",
    "reconstruction_weight", "d_learning_rate", "d_pixel_size", "d_octaves",
    "patch_discriminator", "d_norm", "g_norm", "r1_weight", "diffaug",
    "cycle_weight_final", "identity_weight_final", "loss_anneal_steps",
    # io
    "log_dir", "checkpoint_dir", "checkpoint_every", "checkpoint_keep",
    "checkpoint_async", "keep_best", "log_images_every", "fid_samples", "fid_extractor",
    # serving
    "serve_max_queue", "serve_batch_wait_ms", "serve_max_streams",
)
# the commands that read a checkpoint, and so inherit its config.json
_READS_CHECKPOINT = ("sample", "edit", "export-weights", "export-model", "eval", "distill",
                     "serve")


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


def _explicit_overrides(args) -> dict:
    """The Config fields the user set on the command line."""
    overrides = {n: getattr(args, n) for n in _FIELDS if getattr(args, n, None) is not None}
    if "classes" in overrides:
        overrides["classes"] = tuple(overrides["classes"])
    return overrides


def config_from_args(args, checkpoint_config: bool = False) -> Config:
    """Explicit flags > --config JSON > (with ``checkpoint_config``, for the
    commands that read a checkpoint) the config.json that training saved in
    the checkpoint dir > dataclass defaults. A restore rebuilds the state
    the checkpoint was written with (its optimizer, moments, EMA), so the
    saved config is the right base for the flags the user left out."""
    overrides = _explicit_overrides(args)
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
    for cmd in ("train", "gan-train", "cgan-train", "sample", "edit", "export-weights",
                "export-model", "distill", "eval", "build-cache", "bench", "profile", "serve"):
        p = sub.add_parser(cmd)
        p.add_argument("--config", type=str, default=None, help="config JSON")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        _add_config_args(p)
        if cmd in ("train", "gan-train", "cgan-train", "distill"):
            # the JAX CLI's multi-host launch flags (parallel/multihost.py)
            p.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                           help="rank 0's address: join a multi-process data-parallel job")
            p.add_argument("--num-processes", type=int, default=None,
                           help="the job's processes (ranks), each on one device")
            p.add_argument("--process-id", type=int, default=None,
                           help="this process's rank in [0, --num-processes)")
        if cmd in ("train", "gan-train", "cgan-train"):
            p.add_argument("--resilient", type=int, default=0, metavar="N",
                           help="restart up to N times from the last checkpoint on a "
                                "step failure (requires --checkpoint-dir)")
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
                                "for diffusion, transfer-FID pairs for gan/cgan)")
        elif cmd == "serve":
            p.add_argument("--host", type=str, default="127.0.0.1")
            p.add_argument("--port", type=int, default=8080)
            p.add_argument("--model", type=str, default="diffusion",
                           choices=("diffusion", "gan", "cgan"))
            p.add_argument("--frontend", type=str, default="threaded",
                           choices=("threaded", "aio"),
                           help="threaded = http.server thread-per-connection; aio = "
                                "asyncio event loop (same endpoints and batching)")
            p.add_argument("--bundle", type=str, default=None, metavar="DIR",
                           help="serve a compiled model bundle (export-model) instead of a "
                                "checkpoint: config + weights come from the artifact; "
                                "sample/denoise/transfer per its programs (edit/stream/"
                                "reload stay checkpoint-only)")
        elif cmd == "build-cache":
            p.add_argument("--out", type=str, required=True, help="cache file path")
            p.add_argument("--store", type=int, default=0,
                           help="stored image side (default: size + size/8)")
        elif cmd == "export-weights":
            p.add_argument("--out", type=str, default="weights.npz",
                           help="npz of the flat weights in Keras build order")
        elif cmd == "export-model":
            p.add_argument("--out", type=str, required=True,
                           help="output bundle directory (manifest.json + one torch.export "
                                "program per inference surface)")
            p.add_argument("--model", type=str, default="diffusion",
                           choices=("diffusion", "gan", "cgan"),
                           help="which checkpoint kind to export")
            p.add_argument("--programs", type=str, nargs="*", default=None,
                           help="subset of programs to export (default: all — diffusion: "
                                "denoise/sample/invert/preview; gan: transfer_ab/transfer_ba; "
                                "cgan: transfer)")
            p.add_argument("--export-platforms", type=str, default="cuda,cpu",
                           help="comma-separated devices the bundle may run on")
        elif cmd == "distill":
            p.add_argument("--out", type=str, required=True,
                           help="directory for the distilled student checkpoint (its "
                                "config.json carries the doubled sample_stride)")
            p.add_argument("--target-stride", type=int, default=None,
                           help="final sample_stride (teacher stride · 2^k); default: one "
                                "halving round, 2 · the teacher's stride")
            p.add_argument("--distill-steps", type=int, default=2000,
                           help="optimizer steps per halving round")
        else:
            p.add_argument("--weights", type=str, default=None, metavar="FILE.npz",
                           help="flat Keras-order weights (export-weights); without it "
                                "the latest checkpoint in --checkpoint-dir")
            if cmd == "sample":
                p.add_argument("--out", type=str, default="samples")
                p.add_argument("--num", type=int, default=6)
                p.add_argument("--class-idx", type=int, default=None,
                               help="class to sample from (conditional checkpoints, "
                                    "default 0)")
                p.add_argument("--bundle", type=str, default=None, metavar="DIR",
                               help="sample from a compiled model bundle (export-model) "
                                    "instead of a checkpoint: no model build")
            else:
                p.add_argument("--input", type=str, required=True, help="image path")
                p.add_argument("--class-idx", type=int, default=None,
                               help="class of the input image (conditional checkpoints)")
                p.add_argument("--out", type=str, default="edited")
                p.add_argument("--edits", type=str, nargs="*",
                               default=["pixelate", "shift", "quantise"])
    args = parser.parse_args(argv)
    cfg = config_from_args(args, checkpoint_config=args.command in _READS_CHECKPOINT
                           and not getattr(args, "weights", None))
    if args.command in ("train", "gan-train", "cgan-train"):
        return _train(cfg, args)
    if args.command == "sample":
        return _sample(cfg, args)
    if args.command == "edit":
        return _edit(cfg, args)
    if args.command == "export-weights":
        return _export_weights(cfg, args)
    if args.command == "export-model":
        return _export_model(cfg, args)
    if args.command == "distill":
        return _distill(cfg, args)
    if args.command == "eval":
        return _eval(cfg, args)
    if args.command == "build-cache":
        from .data import native_loader

        store = args.store or cfg.size + cfg.size // 8
        n = native_loader.build_cache(cfg.dataset_pattern, store, args.out)
        print(f"wrote {n} records ({store}x{store}x3 uint8) to {args.out}")
        return 0
    if args.command == "serve":
        return _serve(cfg, args)
    if args.command == "bench":
        from .utils.benchmark import run_benchmark

        print(run_benchmark(cfg, steps=args.bench_steps, device=args.device).to_json())
        return 0
    return _profile(cfg, args)


def _serve(cfg: Config, args) -> int:
    from .serve import server

    if args.bundle:
        # serving knobs (shedding caps, sample_stride, seed …) stay settable;
        # the model's shape is sealed in the artifact
        server.serve_from_bundle(args.bundle, host=args.host, port=args.port,
                                 frontend=args.frontend, overrides=_explicit_overrides(args),
                                 device=args.device)
        return 0
    server.serve_from_checkpoint(cfg, host=args.host, port=args.port, model=args.model,
                                 frontend=args.frontend, device=args.device)
    return 0


def _join_process_group(args) -> bool:
    """Join the job's process group when ``--coordinator`` names one (before
    anything touches a device); True when this call joined it. A group the
    caller already runs in is left to the caller, and must be the one the
    flags name (its world size and this process's rank), or the job would
    not be the one asked for. Without ``--coordinator``, more than one
    process or a rank other than 0 is refused: every process would train
    alone, each its own model, without saying so."""
    import torch.distributed as dist

    from .parallel import multihost

    if args.coordinator:
        if dist.is_available() and dist.is_initialized():
            have = (multihost.process_count(), multihost.process_index())
            if have != (args.num_processes, args.process_id):
                raise ValueError(
                    f"--num-processes {args.num_processes} --process-id {args.process_id}: "
                    f"this process already runs as rank {have[1]} of a group of {have[0]}")
            return False
        multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                             device=args.device)
        return True
    if (args.num_processes or 1) != 1 or (args.process_id or 0) != 0:
        raise ValueError("--num-processes/--process-id require --coordinator HOST:PORT "
                         "(without it each process would train alone)")
    return False


def _train(cfg: Config, args) -> int:
    from .parallel import multihost

    joined = _join_process_group(args)
    try:
        return _fit(cfg, args)
    finally:
        if joined:
            multihost.shutdown()


def _fit(cfg: Config, args) -> int:
    if args.command == "train":
        from .train.loop import Runner

        runner = Runner(cfg, device=args.device)
    elif args.command == "gan-train":
        from .train.gan_loop import GANRunner

        runner = GANRunner(cfg, device=args.device)
    else:
        from .train.conditional_gan_loop import ConditionalGANRunner

        runner = ConditionalGANRunner(cfg, device=args.device)
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
        if cfg.num_classes > 0:
            raise SystemExit("--weights holds the unconditional model's flat Keras-order "
                             "weights; read a conditional model from --checkpoint-dir")
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
    from .utils import weights as weights_lib

    _require_checkpoint(cfg, "export needs trained weights")
    if cfg.num_classes > 0:
        raise SystemExit("export-weights writes the unconditional model's flat Keras order; "
                         "a conditional checkpoint has no such form")
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
        elif args.model == "gan":
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
        else:
            from .train.conditional_gan_loop import ConditionalGANRunner

            runner = ConditionalGANRunner(cfg, log_dir=scratch, device=args.device)
            try:
                out["step"] = int(runner.state.step)
                n = runner.cfg.num_classes
                for src, tgt in ((s, t) for s in range(n) for t in range(n) if s != t):
                    scores = runner.transfer_scores(src, tgt)
                    if scores is not None:
                        out[f"transfer_fid_{src}_to_{tgt}"] = float(scores["fid"])
                        out[f"transfer_kid_{src}_to_{tgt}"] = float(scores["kid"])
            finally:
                runner.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(out))
    return 0


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _class_vector(cfg: Config, class_idx, num: int, device):
    """``--class-idx`` as a (num,) class vector, checked as the JAX CLI
    checks it (cli.py:635-645); None when not given."""
    if class_idx is None:
        return None
    if cfg.num_classes <= 0:
        raise SystemExit("--class-idx requires a conditional checkpoint (num_classes > 0)")
    if not 0 <= class_idx < cfg.num_classes:
        raise SystemExit(f"--class-idx must be in [0, {cfg.num_classes})")
    return torch.full((num,), class_idx, dtype=torch.int32, device=device)


def _write_sample_pngs(images, out_dir: str) -> None:
    """One encoder for both sample paths (bundle and checkpoint): their
    byte-for-byte agreement is a tested contract."""
    from .utils import png

    os.makedirs(out_dir, exist_ok=True)
    for i, img in enumerate(images):
        png.write_png(os.path.join(out_dir, f"sample_{i}.png"), png.to_uint8(img))


def _sample_from_bundle(args) -> int:
    """Sample from a compiled bundle (JAX cli.py:558-595): the config (size,
    classes, stride) and the weights live in the artifact; ``--seed`` draws
    the init batch as the checkpoint path does."""
    from .utils import bundle as bundle_lib

    bundle = bundle_lib.load_bundle(args.bundle, args.device)
    m = bundle.manifest
    if "sample" not in m["programs"]:
        raise SystemExit(f"bundle {args.bundle!r} has no 'sample' program "
                         f"(model={m['model']}, programs={bundle.programs})")
    bcfg = m["config"]
    seed = args.seed if args.seed is not None else bcfg.get("seed", 0)
    size = bcfg["size"]
    rng = np.random.default_rng(seed)
    batch = torch.from_numpy(rng.normal(size=(args.num, size, size, 3)).astype(np.float32))
    call_args = [batch]
    if len(m["programs"]["sample"]["inputs"]) > 1:  # conditional
        num_classes = bcfg.get("num_classes", 0)
        cls = args.class_idx if args.class_idx is not None else 0
        if not 0 <= cls < num_classes:
            raise SystemExit(f"--class-idx must be in [0, {num_classes})")
        call_args.append(torch.full((args.num,), cls, dtype=torch.int32))
    elif args.class_idx is not None:
        raise SystemExit("--class-idx: bundle is unconditional")
    bundle.load("sample")  # the program's read, outside the timing
    _synchronize(bundle.device)
    t0 = time.perf_counter()
    images = bundle.call("sample", *call_args)
    _synchronize(bundle.device)
    ms = (time.perf_counter() - t0) * 1000 / args.num
    images = images.cpu().numpy()
    _write_sample_pngs(images, args.out)
    print(f"wrote {len(images)} samples to {args.out} (bundle step {m['step']}, "
          f"{ms:.3f} ms per image on {bundle.device.type})")
    return 0


def _sample(cfg: Config, args) -> int:
    from .sample import sampler

    if args.bundle:
        return _sample_from_bundle(args)
    model = _load_model(cfg, args.weights, args.device)
    device = next(model.parameters()).device
    class_idx = _class_vector(cfg, args.class_idx, args.num, device)
    rng = np.random.default_rng(cfg.seed)  # the JAX CLI's init batch, exactly
    batch = torch.from_numpy(
        rng.normal(size=(args.num, cfg.size, cfg.size, 3)).astype(np.float32)
    ).to(device)
    _synchronize(device)
    t0 = time.perf_counter()
    images = sampler.sample(cfg, model, batch, class_idx, snapshots=False).images
    _synchronize(device)
    ms = (time.perf_counter() - t0) * 1000 / args.num
    images = images.cpu().numpy()
    _write_sample_pngs(images, args.out)
    print(f"wrote {len(images)} samples to {args.out} "
          f"({ms:.3f} ms per image on {device.type})")
    return 0


def _require_checkpoint(cfg: Config, why: str):
    from .utils import checkpoint as ckpt_lib

    if not (cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None):
        raise SystemExit(f"no checkpoint found in {cfg.checkpoint_dir!r} ({why})")


def _export_model(cfg: Config, args) -> int:
    """The latest checkpoint as a compiled model bundle (utils/bundle.py;
    JAX cli.py:504-543), traced on ``--device``."""
    from .models.api import resolve_device
    from .utils import bundle as bundle_lib
    from .utils import checkpoint as ckpt_lib

    _require_checkpoint(cfg, "export needs trained weights")
    device = resolve_device(args.device)
    if args.model == "diffusion":
        from .train import trainer

        state = trainer.init_state(cfg, device=device)
    elif args.model == "gan":
        from .train import gan

        state = gan.init_gan_state(cfg, device=device)
    else:
        from .train import conditional_gan as cgan

        state = cgan.init_conditional_gan_state(cfg, device=device)
    state = ckpt_lib.restore(cfg.checkpoint_dir, state)
    platforms = tuple(p.strip() for p in args.export_platforms.split(",") if p.strip())
    manifest = bundle_lib.export_bundle(cfg, state, args.out, model=args.model,
                                        programs=args.programs, platforms=platforms, log=print)
    names = ", ".join(sorted(manifest["programs"]))
    print(f"wrote bundle to {args.out}: programs [{names}] "
          f"(step {manifest['step']}, platforms {manifest['platforms']})")
    return 0


def _log_distill_grids(cfg: Config, teacher, student, stride: int, writer):
    """The same 6 noise draws sampled by the teacher at its stride and by the
    student at the distilled stride (JAX cli.py:632-652; the draws from
    ``np.random.default_rng(cfg.seed + 7)``: jax.random cannot be
    reproduced)."""
    from .sample import sampler

    device = next(teacher.parameters()).device
    init = torch.from_numpy(np.random.default_rng(cfg.seed + 7).normal(
        size=(6, cfg.size, cfg.size, 3)).astype(np.float32)).to(device)
    t_imgs = sampler.sample(cfg, teacher, init, snapshots=False).images
    s_imgs = sampler.sample(cfg.replace(sample_stride=stride), student, init,
                            snapshots=False).images
    writer.image("distill/teacher_samples", t_imgs.cpu().numpy() * 0.5 + 0.5, stride, 6)
    writer.image("distill/student_samples", s_imgs.cpu().numpy() * 0.5 + 0.5, stride, 6)


def _distill(cfg: Config, args) -> int:
    """Progressive sampler distillation (train/distill.py; JAX
    cli.py:655-770): halve the sampler's denoiser calls per round and write
    a drop-in student checkpoint whose config.json carries the final
    sample_stride. The teacher is the latest checkpoint's EMA (its params
    without one); the fid_samples held-out files stay out of the batches;
    a conditional checkpoint distills on labeled round-robin batches.

    With ``--coordinator`` the process is a rank of a data-parallel job, as
    for ``train`` (JAX distills over its mesh as it trains,
    cli.py:727-748): each rank reads its share of the files and its rows
    of every global batch, the step averages over the ranks, and only the
    coordinator writes the student and the TensorBoard grids. An
    indivisible batch is refused by the datasets, as JAX's multi-host
    pipeline refuses it."""
    from .parallel import multihost

    _require_checkpoint(cfg, "distillation needs a trained teacher")
    joined = _join_process_group(args)
    try:
        return _distill_ranks(cfg, args)
    finally:
        if joined:
            multihost.shutdown()


def _distill_ranks(cfg: Config, args) -> int:
    from .data import pipeline
    from .models.api import resolve_device
    from .parallel import mesh as mesh_lib
    from .parallel import multihost
    from .train import distill as distill_lib
    from .train import trainer
    from .utils import checkpoint as ckpt_lib
    from .utils import tensorboard as tb

    mesh = mesh_lib.make_mesh(cfg, device=resolve_device(args.device))
    device = mesh.device
    coordinator = multihost.is_coordinator()
    state = ckpt_lib.restore(cfg.checkpoint_dir, trainer.init_state(cfg, device=device))
    teacher = trainer.eval_model(state)
    target = args.target_stride or 2 * max(cfg.sample_stride, 1)
    files_per_class = None
    if cfg.fid_samples > 0:
        try:
            files_per_class = [
                pipeline.held_out_split(p, cfg.fid_samples, seed=cfg.seed + i)[0]
                for i, p in enumerate(cfg.class_patterns())
            ]
        except FileNotFoundError:
            files_per_class = None  # make_datasets raises with the pattern
    dsets = pipeline.make_datasets(cfg, files_per_class=files_per_class, device=device)
    writer = (tb.SummaryWriter(tb.reference_log_dir(cfg.log_dir)) if coordinator
              else tb.NullWriter())
    try:
        dataset = pipeline.LabeledDataset(dsets) if cfg.num_classes > 0 else dsets[0]
        # alike on every rank: the draws are the global batch's
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 101)
        student, stride = distill_lib.progressive_distill(
            cfg, teacher, pipeline.DeviceIterator(dataset, device), target,
            args.distill_steps, generator,
            on_loss=lambda s, i, loss: writer.scalar(f"distill_loss/stride_{s}", loss, i),
            mesh=mesh)
        if coordinator:
            _log_distill_grids(cfg, teacher, student, stride, writer)
    finally:
        writer.close()
        for d in dsets:
            if hasattr(d, "close"):
                d.close()

    student_cfg = cfg.replace(sample_stride=stride, checkpoint_dir=args.out)
    if not coordinator:
        return 0
    with torch.no_grad():
        for p, s in zip(state.model.parameters(), student.parameters()):
            p.copy_(s)
    ema = None
    if state.ema_params is not None:
        ema = [p.detach().clone() for p in student.parameters()]
    path = ckpt_lib.save(args.out, state._replace(ema_params=ema), student_cfg)
    print(f"wrote distilled student (sample_stride={stride}, "
          f"{len(distill_lib.student_grid(student_cfg, stride))} sampler steps vs the "
          f"teacher's {len(distill_lib.student_grid(cfg, max(cfg.sample_stride, 1)))}) "
          f"to {path}")
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
        from .train import conditional_gan as cgan

        state = cgan.init_conditional_gan_state(cfg, device=device)
        step = cgan.make_conditional_gan_train_step(cfg)
        labels = torch.zeros((cfg.batch_size,), dtype=torch.int32, device=device)

        def run(s):  # every source class 0, as the JAX command profiles it
            return step(s, {"image": batch(), "label": labels}, generator)

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
    class_idx = _class_vector(cfg, args.class_idx, 1, device)
    image = torch.from_numpy(decode_image(args.input, cfg.size))[None].to(device)
    results = sampler.edit_image(cfg, model, image, tuple(args.edits), class_idx=class_idx)
    os.makedirs(args.out, exist_ok=True)
    for name, out in results.items():
        png.write_png(os.path.join(args.out, f"{name}.png"), png.to_uint8(out[0].cpu()))
    print(f"wrote {len(results)} edits to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
