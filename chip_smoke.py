#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gan_class_transfer2_tpu_torch) on one
NVIDIA card. Run it from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. build  — compile every csrc/*.cu of the port with nvcc for sm_90a;
  2. kernels — hold B4 against its plain PyTorch version on the card at the
     four full-width k4/s2 down convs at batch 4 (the sampler) and 16
     (training, the GAN), float32 and bfloat16: two launches on the same
     inputs must be bit-identical; print the plan's split of K, and time
     kernel, plain version and one library call (cuDNN) on the same inputs
     beside the bound;
  3. sample — the user's entry point, ``cli.main(["sample", ...])``, at the
     default model width (256², 6 octaves, 41.7 M params, T = 200, stride 50)
     with ``--conv-impl pallas``, in float32 and bfloat16: the kernel's launch
     count must be 4 per denoiser call, and the images must match the same
     weights and init batch run with ``--conv-impl lax``; then the sampler's
     steady-state ms per image (pallas and lax in turns) and a torch.profiler
     breakdown of one sample call by CUDA kernel;
  4. edit   — ``sampler.edit_image`` (invert → edit noise → decode) on one
     synthetic 256² image through the kernel;
  5. reference — a tiny config sampled on the card and on the CPU (the CPU
     path is the one the tests hold against the JAX package) must agree, and
     3 train steps of a tiny config with fused diffusion (B1) and fused Adam
     (B2) on must give the card's and the CPU's losses alike (both draw the
     same Philox noise);
  6. train kernels — B1 (fused forward diffusion, batch 16 × 256²×3, its
     scales gathered from the (T + 1, 2) table by t; bit-identical repeats;
     timed back to back, on the device with L2 warm and cold, and the
     wrapper's host time) and B2
     (fused Adam over every leaf of the 41.7 M-param model, float32 and
     bfloat16 moments) against their plain versions, timed beside their
     bound and, for B2, torch.optim.Adam(fused=True); B4 at the four
     down-conv shapes at batch 16, float32 and bfloat16: its forward and its
     gradients dx, dK, db (cuDNN around the kernel) against the plain
     version's autograd, and the backward timed;
  7. train — the user's entry point, ``cli.main(["bench", ...])``, training
     the default model at batch 16 for 3 + 10 steps in float32 and bfloat16,
     through the kernels (``--conv-impl pallas --optimizer adam_fused
     --fused-diffusion true``) and through cuDNN and the optax-form Adam
     (``--conv-impl lax --optimizer adam_tf --fused-diffusion false``): exact
     launch counts per step, finite losses, and a torch.profiler breakdown of
     one step of each;
  7b. train-hbm — the same training fed from a uint8 pool in device memory
     (128 images of 288², ``data/device_augment.HBMDataset(raw=True)``),
     which the step crops, flips and normalises itself: 3 + 10 steps at
     batch 16 on the kernel path, float32 and bfloat16, exact launch counts,
     img/s beside ``[train]``'s, the augment's device time in one profiled
     step; a ``raw=False`` draw against ``apply_augment``; 3 tiny uint8
     steps on the card and on the CPU, losses alike;
  8. train-agree — one injected full-width step from the same weights, t and
     ε through the kernel path and the plain path: losses and updates agree;
  8a. loader — the native C++ loader on the card's machine: the codec probe
     (png.h, jpeglib.h, zlib.h, the libraries, Pillow), the library built
     with g++ (a failed build fails the run, nothing falls back), its decode
     against utils/png on the 64 class PNGs and on 64 288² PNGs written with
     Paeth and Average rows, and decode img/s at batch 16 for
     NativeImageDataset with 2 and 8 workers and the Python ImageDataset
     with 2 threads, beside [train]'s float32 img/s;
  8b. train-cli — the user's ``cli.main(["train", ...])`` on 64 synthetic
     288² PNGs written by the port's writer and streamed from disk through
     the native loader (the dataset must be NativeImageDataset), with
     ``--fid-samples 16``: the default model, float32, batch 16, 2 epochs × 4
     steps on the kernel path, a checkpoint each epoch and one log_sample
     with its FID/KID; exact B1/B2/B4 launches, finite losses, img/s, every
     reference tag and fid/kid in the event file;
  8c. train-resume — the same from the uint8 pool (``--data-hbm 288``) with
     an EMA: 2 epochs in one call against ``--epochs 1`` then ``--epochs 2``
     on one checkpoint dir (exactly 4 steps restored): epoch-1 losses within
     1e-5 relative; ``cli sample --checkpoint-dir`` equals the restored EMA
     sampled in process (within one uint8 level); one checkpoint save timed;
  8d. cache — ``cli build-cache`` of the Paeth PNGs at store 288, then a
     Runner fed AugmentedCachedDataset for 4 steps at the default width,
     float32, batch 16: exact B1/B2/B4 launches, a finite loss, img/s;
  9. gan-kernel — B3 (instance norm) against its plain version at the seven
     distinct shapes of the cycle-GAN step at batch 16 (each with its plan's
     cluster size) and at a large mean (3·N(0, 1) + 100), float32 and
     bfloat16: forward, and dx, dγ, dβ of its autograd Function against
     autograd through the plain version; kernel, plain version,
     F.instance_norm and the backward timed beside the byte bound. B4 with
     ``relu=False`` (every GAN down conv) at its four shapes at batch 16;
  10. gan — the user's entry point, ``cli.main(["profile", "--model", "gan",
     ...])``, at the default width (two default U-Net generators, two
     default discriminators, 256², batch 16 per class) with instance norms
     and ``--conv-impl pallas``, float32 and bfloat16, 2 + 3 steps: exact B3
     and B4 launch counts (derived from the config), finite losses, the
     trace's top kernels, busy and idle; the step timed without the
     profiler; ``gan.transfer`` at batch 4;
  11. gan-agree — one full-width float32 GAN step under sgd from the same
     state and batches through the kernels and through cuDNN with the
     plain instance norm: losses and each net's update agree;
  12. gan-reference — a tiny GAN whose discriminators reach B4, 3 steps on
     the card and on the CPU: the losses agree;
  13. gan-train-cli — the user's ``cli.main(["gan-train", ...])`` on the two
     class folders of PNGs (circles, crosses) at the default width with
     instance norms and B4, float32, batch 16 per class, 4 steps, one
     checkpoint and one log_sample: exact B3/B4 launches, finite losses;
  14. eval — ``cli.main(["eval", ...])`` on [train-cli]'s checkpoint
     (--model diffusion: 16 samples at stride 50, exact B4 launches) and on
     [gan-train-cli]'s (--model gan, 16 held-out images a class: exact B3/B4
     launches): finite scores; the extractor's features on the card against
     the CPU; run_sampler_benchmark at batch 16, float32 and bfloat16.

The last two lines of its output are a JSON line of per-kernel results and
``{"ok": true, "device": {...}}``; before them the card's name and power
limit. Without a card, or without the port beside it, it exits non-zero and
prints no result.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: fp32 without tensor cores; bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 512), (16, 512, 512))  # (H=W, C, O)
BATCH = 4
# kernel vs plain version, relative to max|y|: float32 differs by summation
# order over 16·C ≤ 8192 terms (~1e-6 seen); bfloat16 by one output rounding
# (2^-8 ≈ 4e-3 of the value) on top of that
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# B4's gradients (cuDNN's dgrad and wgrad around the kernel) vs autograd
# through the plain version, relative to the largest gradient: IEEE float32
# convs in other summation orders; in bfloat16 the plain gradient is float32
# rounded once, cuDNN's bf16 dgrad rounds partial sums over 4·O terms too
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 4e-2}
# pallas vs lax images, in uint8 levels (1 level = 2/255 of the [-1, 1)
# range): float32 paths agree to ~1e-5, so only a rounding flip at a level
# boundary; bfloat16 paths round differently inside 4 of the 6 down convs
# (~4e-3 relative each), and 4 denoiser calls carry that to the image
IMAGE_LEVELS = {"float32": 1, "bfloat16": 6}
TRAIN_BATCH = 16
BENCH_STEPS, BENCH_WARMUP = 10, 3  # run_benchmark's warmup default
KERNEL_PATH = ["--conv-impl", "pallas", "--optimizer", "adam_fused", "--fused-diffusion", "true"]
PLAIN_PATH = ["--conv-impl", "lax", "--optimizer", "adam_tf", "--fused-diffusion", "false"]
# B1 kernel vs plain: the same Philox words; ε may differ by the rounding of
# log and cos (|ε| < 6, a few float32 ulps); on an H100 they agree bit for bit
DIFFUSE_ATOL = 4e-6
# B1's operations per element, for its bound: Philox4x32-10 is, per half
# block (one element), 5 rounds of two 32×32→64 products (one IMAD.WIDE each)
# and two 3-input XORs (LOP3), with the key schedule shared by a thread's
# blocks; the SASS of csrc/diffuse.cu holds 181 more integer instructions than
# its probe without the rounds for a thread's 8 elements (tools/
# kernel_plan_sweep.py b1): 23 an element. Box–Muller (2 conversions, 6
# mul/add), the IEEE logf, sqrtf and cosf fast paths (~16, ~7, ~16) and the 3
# of x·ss + ε·sn: about 48 float instructions, what this build runs (fewer
# would only lower the term). An H100 SM quarter dispatches one warp
# instruction a clock and its INT32 pipe takes one every two: the least time
# is the larger of the integer instructions at INT32_RATE and all of them at
# DISPATCH_RATE (132 SMs × 64 or 128 lanes × 1.98 GHz; DISPATCH_RATE is the
# instruction rate of the 67 TFLOP/s of FMA). At 71 instructions that is
# ~89% of the byte term, so the bytes set the bound.
DIFFUSE_INT_PER_ELEMENT = 23
DIFFUSE_FLOAT_PER_ELEMENT = 48
INT32_RATE = 132 * 64 * 1.98e9
DISPATCH_RATE = 132 * 128 * 1.98e9
HBM_POOL = (128, 288, 288)  # [train-hbm]: uint8 images (N, H, W) in device memory, 31.9 MB
ADAM_FLOPS_PER_ELEMENT = 12  # 2 mul + add (m), 3 mul + add (v), sqrt, add, mul, div, sub
GAN_FLAGS = ["--g-norm", "instance", "--d-norm", "instance", "--conv-impl", "pallas"]
CLI_FILES = (32, 288)  # [train-cli]: PNGs per class (circles, crosses) and their side
CLI_STEPS = 4  # steps an epoch in [train-cli], [train-resume] and [gan-train-cli]
EVAL_SAMPLES = 16  # fid_samples of [train-cli] and [eval]: held-out files and samples
PAETH_FILES = (64, 288)  # [loader]/[cache]: PNGs written with Paeth and Average rows
# the reference's TensorBoard tags (train.py:356-361, 489-496) and the epoch scalars
REF_TAGS = ("denoised/image", "example loss", "step_1/image/0", "step_0.25/image/0",
            "step_0.5/image/0", "step_0.75/image/0", "fake/image/0", "loss", "images_per_sec")
GAN_WARM, GAN_PROFILE_STEPS, GAN_TIMED_STEPS = 2, 3, 5  # cli profile's two warm steps
# B3 vs plain, relative to max|y|: float32 differs by the order of the
# statistics' sums (Welford/Chan against two passes, ~1e-7 of a value);
# bfloat16 by one output rounding (2^-8 ≈ 4e-3 of the value)
IN_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# B3's Function (backward in torch ops) vs autograd through the plain
# version, relative to the largest gradient: float32 reductions in other
# orders; in bfloat16 the plain version's dγ and dβ pass through γ and β
# rounded to bf16, and dx is rounded to bf16 on both sides
IN_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 4e-2}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match, reps=20, before=None):
    """Device time of one call of fn, over its CUDA kernels whose name
    contains ``match`` (torch.profiler); ``before`` runs ahead of each call,
    outside the count (an L2 scrub)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if match in e.key) / reps / 1e3


def host_ms(fn, reps=50):
    """Host time of one call of fn: back-to-back calls timed before the
    final synchronise, so the launch queue absorbs the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def phase_build():
    from gan_class_transfer2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(reports)} source(s) compiled in {secs:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(torch, F, fdc):
    """Kernel vs plain version at the four full-width shapes, at batch 4
    (the sampler) and 16 (training and the GAN): error, the plan's split of
    K, bit-identical repeats, and times beside the bound and cuDNN. Returns
    one summary per dtype (sums over the shapes of one denoiser call at
    batch 4)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for batch in (BATCH, TRAIN_BATCH):
            s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops_ms=0.0,
                     bytes_ms=0.0, max_abs_err=0.0)
            for (hw, c, o) in SHAPES:
                # weight and bias already in x's dtype, as the models pass them
                # (and as the cuDNN call below gets them)
                x = torch.randn((batch, hw, hw, c), generator=gen, device="cuda").to(dtype)
                k = (torch.randn((4, 4, c, o), generator=gen, device="cuda")
                     / (16 * c) ** 0.5).to(dtype)
                b = (torch.randn((o,), generator=gen, device="cuda") * 0.1).to(dtype)
                plan = fdc.plan(batch, hw, hw, c, o, dtype)
                with torch.inference_mode():
                    before = fdc.down_conv_fused.launches
                    y = fdc.down_conv_fused(x, k, b)
                    again = fdc.down_conv_fused(x, k, b)
                    ref = fdc.down_conv_plain(x, k, b)
                    torch.cuda.synchronize()
                    fdc.down_conv_fused.launches = before  # comparison launches do not count
                    if not torch.equal(y, again):
                        fail(f"kernel {dtype_name} {x.shape}->{o}: two launches on the same "
                             f"inputs differ")
                    err = (y.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    if not err <= KERNEL_RTOL[dtype_name] * scale:
                        fail(f"kernel {dtype_name} {x.shape}->{o}: max|err| {err} > "
                             f"{KERNEL_RTOL[dtype_name]} x max|y| {scale}")
                    # one library call computing the same function: cuDNN on the
                    # same NHWC memory (a channels_last NCHW view), bias folded in
                    x_lib = x.permute(0, 3, 1, 2)
                    w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    b_lib = b
                    ms = cuda_ms(lambda: fdc.down_conv_fused(x, k, b))
                    plain_ms = cuda_ms(lambda: fdc.down_conv_plain(x, k, b))
                    lib_ms = cuda_ms(lambda: torch.relu_(
                        F.conv2d(x_lib, w_lib, b_lib, stride=2, padding=1)))
                    fdc.down_conv_fused.launches = before
                h2 = hw // 2
                flops = 2 * batch * h2 * h2 * o * 16 * c
                nbytes = x.element_size() * (x.numel() + k.numel() + b.numel() + y.numel())
                flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                bound = max(flops_ms, bytes_ms)
                print(f"[kernel] {dtype_name} x{tuple(x.shape)} -> {o}: max|err| {err:.3e} "
                      f"(max|y| {scale:.3f}), repeat bit-identical; plan {plan.blocks} blocks "
                      f"({plan.tiles_m}x{plan.tiles_n} tiles, split {plan.split}); kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({'operations' if flops_ms >= bytes_ms else 'bytes'}); "
                      f"{flops / ms / 1e9:.1f} TFLOP/s = {bound / ms:.1%} of bound")
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["library_ms"] += lib_ms
                s["bound_ms"] += bound
                s["flops_ms"] += flops_ms
                s["bytes_ms"] += bytes_ms
                s["max_abs_err"] = max(s["max_abs_err"], err)
                del x, y, again, ref, x_lib, w_lib
            print(f"[kernel] {dtype_name} batch {batch}, four shapes: kernel {s['ms']:.4f} ms, "
                  f"plain {s['plain_ms']:.4f} ms, cuDNN {s['library_ms']:.4f} ms, bound "
                  f"{s['bound_ms']:.4f} ms = {s['bound_ms'] / s['ms']:.1%} of bound")
            if batch == BATCH:
                summary[dtype_name] = s
            else:
                summary[dtype_name]["max_abs_err"] = max(summary[dtype_name]["max_abs_err"],
                                                         s["max_abs_err"])
        torch.cuda.empty_cache()
    return summary


def phase_sample(fdc, cli, sampler, png, weights_npz, tmp):
    """The slice through the CLI, per dtype: pallas (counted) and lax, same
    weights and init batch. Returns per-dtype launches and ms per image."""
    from gan_class_transfer2_tpu_torch.config import Config

    cfg = Config(sample_stride=50).validate()
    calls = len(sampler.sample_timesteps(cfg))
    out = {}
    for dtype in ("float32", "bfloat16"):
        images = {}
        for impl in ("pallas", "lax"):
            dest = os.path.join(tmp, f"{dtype}-{impl}")
            fdc.down_conv_fused.launches = 0
            rc = cli.main(["sample", "--device", "cuda", "--conv-impl", impl,
                           "--compute-dtype", dtype, "--num", str(BATCH),
                           "--sample-stride", "50", "--weights", weights_npz,
                           "--out", dest])
            launches = fdc.down_conv_fused.launches
            if rc != 0:
                fail(f"cli sample {dtype}/{impl} returned {rc}")
            want = 4 * calls if impl == "pallas" else 0
            if launches != want:
                fail(f"{dtype}/{impl}: {launches} kernel launches, expected {want} "
                     f"(4 per denoiser call x {calls} calls)")
            if impl == "pallas":
                out[dtype] = {"launches": launches}
            imgs = [png.read_png(os.path.join(dest, f"sample_{i}.png")) for i in range(BATCH)]
            if any(im.shape != (cfg.size, cfg.size, 3) for im in imgs):
                fail(f"{dtype}/{impl}: PNG shapes {[im.shape for im in imgs]}")
            images[impl] = np.stack(imgs).astype(np.int64)
        levels = int(np.abs(images["pallas"] - images["lax"]).max())
        print(f"[sample] {dtype}: {out[dtype]['launches']} launches over {calls} denoiser "
              f"calls; pallas vs lax PNGs differ by at most {levels} uint8 levels "
              f"(tolerance {IMAGE_LEVELS[dtype]})")
        if levels > IMAGE_LEVELS[dtype]:
            fail(f"{dtype}: pallas and lax images differ by {levels} levels")
        out[dtype]["png_levels"] = levels
    return out, cfg


def phase_timing(torch, fdc, sampler, weights, weights_npz, cfg):
    """Steady-state ms per image of the sampler (model loaded, batch on the
    card), pallas and lax in turns, and their float difference."""
    from gan_class_transfer2_tpu_torch.models import unet

    model = weights.import_flat_weights(unet.Denoiser(cfg), weights.load_flat_npz(weights_npz))
    model = model.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    init = torch.randn((BATCH, cfg.size, cfg.size, 3), generator=gen, device="cuda")
    for dtype in ("float32", "bfloat16"):
        runs = {"pallas": [], "lax": []}
        final = {}
        for impl in ("pallas", "lax", "lax", "pallas", "pallas", "lax"):
            c = cfg.replace(conv_impl=impl, compute_dtype=dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final[impl] = sampler.sample(c, model, init, snapshots=False).images
            torch.cuda.synchronize()
            runs[impl].append((time.perf_counter() - t0) * 1e3 / BATCH)
        if not all(torch.isfinite(v).all() for v in final.values()):
            fail(f"{dtype}: non-finite sample")
        diff = (final["pallas"] - final["lax"]).abs().max().item()
        med = {k: sorted(v)[1] for k, v in runs.items()}
        print(f"[timing] {dtype}: ms per image (median of 3, stride 50, batch {BATCH}) "
              f"pallas {med['pallas']:.3f}, lax {med['lax']:.3f}; runs {runs}; "
              f"max|pallas - lax| {diff:.3e}")
    phase_profile(torch, sampler, model, cfg, init)
    fdc.down_conv_fused.launches = 0
    return model


def phase_profile(torch, sampler, model, cfg, init):
    """Where a sample's device time goes: torch.profiler over one sample
    call per (dtype, impl), CUDA kernels only, the top six by self time.
    The profiler's own overhead inflates the wall time it sees."""
    from torch.profiler import ProfilerActivity, profile

    from gan_class_transfer2_tpu_torch.utils import profiler

    for dtype in ("float32", "bfloat16"):
        for impl in ("pallas", "lax"):
            c = cfg.replace(conv_impl=impl, compute_dtype=dtype)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sampler.sample(c, model, init, snapshots=False)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = profiler.device_busy_ms(prof)
            print(f"[profile] {dtype}/{impl}: one sample call (batch {BATCH}, "
                  f"{len(sampler.sample_timesteps(c))} denoiser calls): kernels busy "
                  f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler")
            for r in profiler.device_ops(prof, top=6):
                print(f"[profile]   {r['ms']:8.3f} ms x{r['calls']:<4d} {r['op'][:100]}")


def phase_edit(torch, fdc, sampler, model, cfg):
    c = cfg.replace(conv_impl="pallas")
    ramp = torch.linspace(-1, 1, c.size, device="cuda")
    image = torch.stack([ramp[None, :].expand(c.size, c.size),
                         ramp[:, None].expand(c.size, c.size),
                         (ramp[None, :] * ramp[:, None])], -1)[None]
    fdc.down_conv_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler.edit_image(c, model, image)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fdc.down_conv_fused.launches
    calls = c.steps + len(sampler.sample_timesteps(c))  # invert, then decode
    if launches != 4 * calls:
        fail(f"edit: {launches} launches, expected {4 * calls}")
    if set(out) != {"reconstruction", "pixelate", "shift", "quantise"}:
        fail(f"edit: outputs {sorted(out)}")
    for name, v in out.items():
        if v.shape != image.shape or not torch.isfinite(v).all():
            fail(f"edit: {name} has shape {tuple(v.shape)} or non-finite values")
    print(f"[edit] invert ({c.steps} calls) + decode of 4 candidates "
          f"({len(sampler.sample_timesteps(c))} calls) in {secs:.3f} s, {launches} launches")
    return launches


def phase_reference(torch, api, sampler):
    """Tiny config: the card's sample equals the CPU path's (atol 1e-4, the
    sampler tests' bound against the JAX package)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    worst = 0.0
    for impl in ("pallas", "lax"):
        cfg = tiny_test_config(conv_impl=impl)
        model = api.init_denoiser(cfg, device="cpu")
        init = torch.randn((2, cfg.size, cfg.size, 3), generator=torch.Generator().manual_seed(2))
        cpu = sampler.sample(cfg, model, init).images
        gpu = sampler.sample(cfg, model.to("cuda"), init.to("cuda")).images.cpu()
        worst = max(worst, (cpu - gpu).abs().max().item())
    print(f"[reference] tiny config, card vs CPU: max|diff| {worst:.3e}")
    if not worst <= 1e-4:
        fail(f"tiny sample on the card differs from the CPU path by {worst}")

    # 3 train steps, B1 and B2 on: the CPU takes their plain versions, the
    # card their kernels; both draw t and the B1 seed from one CPU generator
    # stream, so both see the same noise. Losses within 1e-4 relative: IEEE
    # float32 convs in other summation orders, ε within DIFFUSE_ATOL.
    from gan_class_transfer2_tpu_torch.ops import adam_kernel, fused_diffusion
    from gan_class_transfer2_tpu_torch.train import trainer

    cfg = tiny_test_config(fused_diffusion=True, optimizer="adam_fused", lr_schedule="constant",
                           learning_rate=1e-3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, cfg.size, cfg.size, 3))
                         .astype(np.float32))
    losses = {}
    for dev in ("cpu", "cuda"):
        state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
        step, gen = trainer.make_train_step(cfg), torch.Generator().manual_seed(5)
        b1, b2 = fused_diffusion.diffuse_fused.launches, adam_kernel.adam_fused.launches
        losses[dev] = []
        for _ in range(3):
            state, loss = step(state, x.to(dev), gen)
            losses[dev].append(float(loss))
        launched = (fused_diffusion.diffuse_fused.launches - b1,
                    adam_kernel.adam_fused.launches - b2)
        fused_diffusion.diffuse_fused.launches, adam_kernel.adam_fused.launches = b1, b2
        if launched != ((0, 0) if dev == "cpu" else (3, 3)):
            fail(f"reference train on {dev}: B1/B2 launches {launched}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[reference] tiny train, B1+B2 on, 3 steps: losses card {losses['cuda']} "
          f"CPU {losses['cpu']}; max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny training on the card differs from the CPU by {rel} relative")


def b4_per_call(fdc, cfg, batch):
    """Down convs of one denoiser call that the B4 gate admits (4 at the
    default width: 128²→…→16² inputs with C ≥ 128; the stem has C = 3)."""
    n, c = 0, cfg.pixel_size if cfg.block_depth else 3
    for i in range(cfg.octaves):
        f, hw = cfg.octave_filters(i), cfg.size >> i
        n += fdc.supported((batch, hw, hw, c), (4, 4, c, f))
        c = f
    return n


def _bytes_ms(nbytes):
    return nbytes / PEAK_BYTES * 1e3


def _row(name, source, replaces, launches, err, ms, plain_ms, flops, nbytes, library_ms):
    flops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    bytes_ms = _bytes_ms(nbytes)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def phase_train_kernels(torch, F, fdc, fd, adam_kernel, api, cfg):
    """B1 and B2 against their plain versions at the training slice's
    shapes, timed; B4's forward and gradients against the plain version at
    batch 16, its backward timed. Returns ({name: row without launches},
    {dtype: B4's forward max|err| at batch 16})."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    # ---- B1: batch 16 × 256²×3 float32, its scales gathered from the table
    n = cfg.size * cfg.size * 3
    x = torch.rand((TRAIN_BATCH, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (TRAIN_BATCH,), generator=gen, device="cuda",
                      dtype=torch.int32)
    table = fd.scale_table(cfg.steps, cfg.schedule, "cuda")
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    before = fd.diffuse_fused.launches
    y = fd.diffuse_fused(x, t, table, seed)
    ref = fd.diffuse_plain(x, t, table, seed)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    if not err <= DIFFUSE_ATOL:
        fail(f"diffuse kernel vs plain: max|err| {err} > {DIFFUSE_ATOL}")
    if not torch.equal(fd.diffuse_fused(x, t, table, seed), y):
        fail("diffuse kernel: two launches on the same inputs differ")
    ss = table[t.long(), 0]
    only_ss = torch.stack([table[:, 0], torch.zeros_like(table[:, 0])], 1)
    if not torch.equal(fd.diffuse_fused(x, t, only_ss, seed), x * ss[:, None]):
        fail("diffuse kernel with sn = 0 is not x·ss")
    noise = torch.tensor([[0.0, 1.0]], device="cuda")
    eps = fd.diffuse_fused(x, torch.zeros_like(t), noise, seed)
    mean, std = eps.double().mean().item(), eps.double().std().item()
    if not (abs(mean) < 5 / eps.numel() ** 0.5 and abs(std - 1) < 5 / (2 * eps.numel()) ** 0.5):
        fail(f"diffuse kernel noise has mean {mean}, std {std}")
    call = lambda: fd.diffuse_fused(x, t, table, seed)  # noqa: E731
    ms = cuda_ms(call, reps=50)
    scrub = torch.empty(16 * 2**20, device="cuda")  # 64 MB written between launches: L2 cold
    dev_ms = device_ms(call, "diffuse")
    cold_ms = device_ms(call, "diffuse", before=lambda: scrub.fill_(1.0))
    wrapper_ms = host_ms(call)
    plain_ms = cuda_ms(lambda: fd.diffuse_plain(x, t, table, seed), reps=5)
    fd.diffuse_fused.launches = before
    elems = x.numel()
    bytes_ms = _bytes_ms(8 * elems)
    ops = DIFFUSE_INT_PER_ELEMENT * elems, DIFFUSE_FLOAT_PER_ELEMENT * elems
    ops_ms = max(ops[0] / INT32_RATE, (ops[0] + ops[1]) / DISPATCH_RATE) * 1e3
    bound = max(bytes_ms, ops_ms)
    rows["diffuse_f32"] = {
        "name": "diffuse_f32", "route": "cuda",
        "source": "gan_class_transfer2_tpu_torch/csrc/diffuse.cu",
        "replaces": "gan_class_transfer2_tpu/ops/kernels.py:44", "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        "device_ms": dev_ms, "device_cold_ms": cold_ms, "host_ms": wrapper_ms}
    print(f"[train-kernel] B1 diffuse x{tuple(x.shape)}: max|err| {err:.3e} (bound "
          f"{DIFFUSE_ATOL}), repeat bit-identical; noise mean {mean:.2e} std {std:.5f}; kernel "
          f"{ms:.4f} ms back to back (host-included), device {dev_ms:.4f} ms L2 warm, "
          f"{cold_ms:.4f} ms cold, the wrapper's host {wrapper_ms:.4f} ms a call; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({rows['diffuse_f32']['bound_by']}: bytes "
          f"{bytes_ms:.4f}, operations {ops_ms:.4f}) = {bound / cold_ms:.1%} of the cold device "
          f"time; no one-call library yardstick")
    del x, y, ref, eps, scrub

    # ---- B2: every leaf of the default model, float32 and bfloat16 moments
    model = api.init_denoiser(cfg, device="cuda")
    params = [p.detach() for p in model.parameters()]
    n_params = sum(p.numel() for p in params)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in params]
    step = torch.tensor([1e-4], device="cuda")
    b1, b2, eps = 0.9, 0.999, cfg.adam_eps
    for mdt, name in ((torch.float32, "adam_f32m"), (torch.bfloat16, "adam_bf16m")):
        m = [(g * 3).to(mdt) for g in grads]
        v = [(g * g).to(mdt) for g in grads]
        p2 = [p.clone() for p in params]
        ref = [[t.clone() for t in ts] for ts in (p2, m, v)]
        before = adam_kernel.adam_fused.launches
        adam_kernel.adam_fused(p2, m, v, grads, step, eps)
        adam_kernel.adam_plain(*ref, grads, step, eps)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(p2 + m + v, ref[0] + ref[1] + ref[2]))
        if err != 0:
            fail(f"{name}: kernel and plain version differ by {err} (they must agree bit for bit)")
        ms = cuda_ms(lambda: adam_kernel.adam_fused(p2, m, v, grads, step, eps))
        plain_ms = cuda_ms(lambda: adam_kernel.adam_plain(p2, m, v, grads, step, eps), reps=3)
        adam_kernel.adam_fused.launches = before
        lib_ms = None
        if mdt == torch.float32:
            # the same update from torch.optim.Adam: eps rescaled by √(1−β₂ᵗ) at t = 1
            lib_params = [torch.nn.Parameter(p.clone()) for p in params]
            for lp, g in zip(lib_params, grads):
                lp.grad = g
            opt = torch.optim.Adam(lib_params, lr=1e-4, betas=(b1, b2),
                                   eps=eps / (1 - b2) ** 0.5, fused=True)
            lib_ms = cuda_ms(opt.step)
            del lib_params, opt
        nbytes = n_params * (3 * 4 + 4 * m[0].element_size())  # g, p, m, v in; p, m, v out
        rows[name] = _row(name, "gan_class_transfer2_tpu_torch/csrc/adam.cu",
                          "gan_class_transfer2_tpu/ops/adam_kernel.py:38", 0, err, ms, plain_ms,
                          ADAM_FLOPS_PER_ELEMENT * n_params, nbytes, lib_ms)
        print(f"[train-kernel] B2 {name}: {len(params)} leaves, {n_params} params, "
              f"{adam_kernel.launches_per_step(len(params))} launch(es); bit-exact vs plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms "
              f"({rows[name]['bound_by']}, {nbytes / 1e9:.3f} GB), torch.optim.Adam(fused) "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
        del m, v, p2, ref
    del model, params, grads

    # ---- B4 forward and backward (cuDNN's dgrad and wgrad around the
    # kernel) at batch 16, the training path's shapes
    b4_err = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        b4_err[dtype_name], worst, flips, tot = b4_batch16(torch, fdc, gen, dtype_name, dtype,
                                                           relu=True)
        print(f"[train-kernel] B4 {dtype_name}, batch {TRAIN_BATCH}, four shapes: max error "
              f"relative to the largest value: y {worst['y']:.2e} (bound "
              f"{KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK {worst['dK']:.2e}, db "
              f"{worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]}); {flips} ReLU mask flip(s); "
              f"backward: cuDNN dx+dK+db {tot['ms']:.4f} ms, plain autograd "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (operations)")
    return rows, b4_err


def b4_batch16(torch, fdc, gen, dtype_name, dtype, relu, timed=True):
    """B4 at the four down-conv shapes at batch 16: its forward against the
    plain version (KERNEL_RTOL of max|y|) and dx, dK, db (cuDNN around the
    kernel) against the plain version's autograd (GRAD_RTOL of the largest
    gradient); with ``timed``, the backward timed against the plain one.
    Returns (max|err| of y, worst relative errors, ReLU mask flips, times)."""
    from gan_class_transfer2_tpu_torch.models import unet

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    worst = {"y": 0.0, "dx": 0.0, "dK": 0.0, "db": 0.0}
    flips, max_err = 0, 0.0
    with unet.ieee_fp32(torch.float32, torch.device("cuda")):
        for (hw, c, o) in SHAPES:
            xs = torch.randn((TRAIN_BATCH, hw, hw, c), generator=gen, device="cuda").to(dtype)
            k = (torch.randn((4, 4, c, o), generator=gen, device="cuda") / (16 * c) ** 0.5)
            b = torch.randn((o,), generator=gen, device="cuda") * 0.1
            xs.requires_grad_()
            k, b = k.to(dtype).requires_grad_(), b.to(dtype).requires_grad_()
            g = torch.randn((TRAIN_BATCH, hw // 2, hw // 2, o), generator=gen,
                            device="cuda").to(dtype)
            before = fdc.down_conv_fused.launches
            y = fdc.down_conv_fused(xs, k, b, relu)
            yp = fdc.down_conv_plain(xs, k, b, relu)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            if not err <= KERNEL_RTOL[dtype_name] * scale:
                fail(f"B4 (relu={relu}) forward {dtype_name} x{tuple(xs.shape)}->{o}: max|err| "
                     f"{err} > {KERNEL_RTOL[dtype_name]} x max|y| {scale}")
            if not relu and not (y < 0).any():
                fail(f"B4 (relu=False) {dtype_name} x{tuple(xs.shape)}: no negative output")
            max_err = max(max_err, err)
            worst["y"] = max(worst["y"], err / scale)
            # an output whose pre-activation lies within rounding of 0
            # may pass one ReLU and not the other; g is 0 there for both
            same = (y > 0) == (yp > 0) if relu else torch.ones_like(y, dtype=torch.bool)
            flips += int((~same).sum().item())
            gm = torch.where(same, g, torch.zeros_like(g))
            got = torch.autograd.grad(y, (xs, k, b), gm, retain_graph=True)
            want = torch.autograd.grad(yp, (xs, k, b), gm, retain_graph=True)
            for gname, a, w in zip(("dx", "dK", "db"), got, want):
                gerr = (a.float() - w.float()).abs().max().item()
                gscale = w.float().abs().max().item()
                if not gerr <= GRAD_RTOL[dtype_name] * gscale:
                    fail(f"B4 (relu={relu}) {gname} {dtype_name} x{tuple(xs.shape)}->{o}: "
                         f"max|err| {gerr} > {GRAD_RTOL[dtype_name]} x max|{gname}| {gscale}")
                worst[gname] = max(worst[gname], gerr / gscale)
            if timed:
                tot["ms"] += cuda_ms(lambda: torch.autograd.grad(y, (xs, k, b), g,
                                                                 retain_graph=True))
                tot["plain_ms"] += cuda_ms(lambda: torch.autograd.grad(yp, (xs, k, b), g,
                                                                       retain_graph=True))
                flops = 2 * 2 * TRAIN_BATCH * (hw // 2) ** 2 * o * 16 * c  # dx and dK
                nbytes = xs.element_size() * (2 * xs.numel() + 2 * k.numel() + y.numel())
                tot["bound_ms"] += max(flops / PEAK_FLOPS[dtype_name] * 1e3, _bytes_ms(nbytes))
            fdc.down_conv_fused.launches = before  # comparison launches do not count
            del xs, k, b, g, gm, y, yp, got, want
    return max_err, worst, flips, tot


def _cli_json(cli, args):
    """One CLI run with its standard output captured; returns the JSON
    lines it printed. Fails the smoke on a non-zero return or no output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        fail(f"cli {' '.join(args)} returned {rc}")
    return lines


def phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg):
    """The training slice through ``cli bench`` at the default width, per
    dtype × path; exact launch counts; a profile of one step of each.
    Returns the kernel path's launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import profiler

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    steps = BENCH_STEPS + BENCH_WARMUP
    launches = {"diffuse_f32": 0, "adam_f32m": 0, "adam_bf16m": 0,
                "down_conv_k4s2_f32": 0, "down_conv_k4s2_bf16": 0}
    results = {}
    for dtype in ("float32", "bfloat16"):
        moments = "bfloat16" if dtype == "bfloat16" else "float32"
        for path, flags in (("kernels", KERNEL_PATH), ("plain", PLAIN_PATH)):
            width = [f"--{k.replace('_', '-')}={getattr(cfg, k)}"
                     for k in ("size", "pixel_size", "max_size", "octaves", "steps")]
            args = ["bench", "--device", "cuda", *width, "--batch-size", str(TRAIN_BATCH),
                    "--bench-steps", str(BENCH_STEPS), "--compute-dtype", dtype,
                    "--moment-dtype", moments, *flags]
            fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
            adam_kernel.adam_fused.launches = 0
            res = _cli_json(cli, args)[-1]
            print(f"[train] {json.dumps(res)}")
            got = (fd.diffuse_fused.launches, adam_kernel.adam_fused.launches,
                   fdc.down_conv_fused.launches)
            per_step = (0, 0, 0)
            if path == "kernels":
                per_step = (1, adam_kernel.launches_per_step(n_leaves),
                            b4_per_call(fdc, cfg, TRAIN_BATCH))
            want = tuple(steps * k for k in per_step)
            if got != want:
                fail(f"train {dtype}/{path}: launches B1/B2/B4 {got}, expected {want} "
                     f"({per_step} per step x {steps} steps)")
            if not np.isfinite(res["final_loss"]):
                fail(f"train {dtype}/{path}: loss {res['final_loss']}")
            if path == "kernels":
                launches["diffuse_f32"] += got[0]
                launches["adam_bf16m" if moments == "bfloat16" else "adam_f32m"] += got[1]
                launches["down_conv_k4s2_" + ("bf16" if dtype == "bfloat16" else "f32")] += got[2]
            results[(dtype, path)] = res
            print(f"[train] {dtype}/{path}: launches B1/B2/B4 {got} over {steps} steps; "
                  f"{res['images_per_sec']} img/s, {res['step_ms']} ms/step, "
                  f"loss {res['final_loss']:.5f}")

    # one profiled step of each (after two warm steps), outside the counted runs
    for (dtype, path), res in results.items():
        flags = dict(zip(KERNEL_PATH[::2], KERNEL_PATH[1::2]) if path == "kernels"
                     else zip(PLAIN_PATH[::2], PLAIN_PATH[1::2]))
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype,
                        moment_dtype="bfloat16" if dtype == "bfloat16" else "float32",
                        conv_impl=flags["--conv-impl"], optimizer=flags["--optimizer"],
                        fused_diffusion=flags["--fused-diffusion"] == "true").validate()
        state = trainer.init_state(c, device="cuda")
        step = trainer.make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        xb = torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen, device="cuda") * 2 - 1
        for _ in range(2):
            state, _ = step(state, xb, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, loss = step(state, xb, gen)
            torch.cuda.synchronize()
        rows = profiler.device_ops(prof, top=None)
        busy = profiler.device_busy_ms(prof)
        print(f"[train-profile] {dtype}/{path}: one step at batch {TRAIN_BATCH}: kernels busy "
              f"{busy:.3f} ms of {res['step_ms']:.3f} ms per step (bench, no profiler): idle "
              f"share {max(0.0, 1 - busy / res['step_ms']):.1%}; {len(rows)} kernel names")
        for r in rows[:8]:
            print(f"[train-profile]   {r['ms']:8.3f} ms x{r['calls']:<4d} {r['op'][:100]}")
        del state, step, xb
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0
    return launches, results


def phase_train_hbm(torch, fdc, fd, adam_kernel, trainer, cfg, synthetic):
    """The training slice fed as users feed it from a pool in device memory:
    a uint8 pool made from the seed on the card (HBM_POOL, 31.9 MB) behind
    ``HBMDataset(raw=True)``, whose batches ``train_step`` crops, flips and
    normalises itself; the default model at batch 16 on the kernel path
    (B1, B2, B4), float32 and bfloat16, 3 + 10 steps: exact launch counts,
    finite losses, img/s beside ``[train]``'s synthetic batch; one profiled
    step with the augment's device time; a ``raw=False`` draw against
    ``apply_augment`` on the same draws; and a tiny config's 3 uint8 steps on
    the card and on the CPU (losses within 1e-4 relative, as
    ``[reference]``). Returns the launches by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.data import device_augment as aug
    from gan_class_transfer2_tpu_torch.data.pipeline import EpochIndexStream
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import profiler

    n_img, h, w = HBM_POOL
    pool = torch.randint(0, 256, (n_img, h, w, 3), dtype=torch.uint8, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(21))
    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, cfg, TRAIN_BATCH))
    steps = BENCH_WARMUP + BENCH_STEPS
    launches = {"diffuse_f32": 0, "adam_f32m": 0, "adam_bf16m": 0,
                "down_conv_k4s2_f32": 0, "down_conv_k4s2_bf16": 0}
    for dtype in ("float32", "bfloat16"):
        moments = "bfloat16" if dtype == "bfloat16" else "float32"
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype, moment_dtype=moments,
                        conv_impl="pallas", optimizer="adam_fused",
                        fused_diffusion=True).validate()
        data = iter(aug.HBMDataset(pool, c.size, TRAIN_BATCH, seed=0, raw=True, device="cuda"))
        state = trainer.init_state(c, device="cuda")
        step = trainer.make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
        adam_kernel.adam_fused.launches = 0
        for i in range(steps):
            if i == BENCH_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, loss = step(state, next(data), gen)
        loss = float(loss)
        secs = time.perf_counter() - t0
        got = (fd.diffuse_fused.launches, adam_kernel.adam_fused.launches,
               fdc.down_conv_fused.launches)
        want = tuple(steps * k for k in per_step)
        if got != want:
            fail(f"train-hbm {dtype}: launches B1/B2/B4 {got}, expected {want}")
        if not np.isfinite(loss):
            fail(f"train-hbm {dtype}: loss {loss}")
        launches["diffuse_f32"] += got[0]
        launches["adam_bf16m" if moments == "bfloat16" else "adam_f32m"] += got[1]
        launches["down_conv_k4s2_" + ("bf16" if dtype == "bfloat16" else "f32")] += got[2]
        ips = TRAIN_BATCH * BENCH_STEPS / secs
        print(f"[train-hbm] {dtype}: uint8 pool {tuple(pool.shape)} on the card, batch "
              f"{TRAIN_BATCH}: launches B1/B2/B4 {got} over {steps} steps; {ips:.3f} img/s, "
              f"{secs / BENCH_STEPS * 1e3:.3f} ms/step ([train] on a synthetic batch: "
              f"{synthetic[(dtype, 'kernels')]['images_per_sec']} img/s); loss {loss:.5f}")

        # one profiled step, its augment in a named range; then the augment
        # of one batch alone
        batch = next(data)
        augment = trainer.augment_if_uint8

        def named(*args):
            with record_function("augment_if_uint8"):
                return augment(*args)

        trainer.augment_if_uint8 = named  # fold_and_augment looks it up at each call
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, loss = step(state, batch, gen)
                torch.cuda.synchronize()
        finally:
            trainer.augment_if_uint8 = augment
        busy = profiler.device_busy_ms(prof)
        # the kernels launched inside the CPU-side range (the GPU-side
        # annotation of the same name spans the host-paced gaps between them)
        in_step = sum(e.device_time_total for e in prof.events()
                      if e.name == "augment_if_uint8" and e.device_type == DeviceType.CPU) / 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            augment(c, batch, gen)
            torch.cuda.synchronize()
        alone = sum(e.device_time_total for e in prof.key_averages()
                    if not e.key.startswith(("cuda", "Activity"))) / 1e3
        print(f"[train-hbm] {dtype}: one profiled step: kernels busy {busy:.3f} ms, of which the "
              f"augment (draws, gather, normalise) {in_step:.4f} ms ({in_step / busy:.2%}); the "
              f"augment alone {alone:.4f} ms of device time")
        del state, step, data, batch
        torch.cuda.empty_cache()
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0

    # a raw=False draw is apply_augment of the same rows and draws
    ds = aug.HBMDataset(pool, cfg.size, TRAIN_BATCH, seed=4, device="cuda")
    idx = EpochIndexStream(n_img, TRAIN_BATCH, seed=4).next_indices()
    got = next(iter(ds))
    off, flip = aug.draw_augment(TRAIN_BATCH, h, w, cfg.size,
                                 torch.Generator(device="cuda").manual_seed(aug._key(4, 0)))
    want = aug.apply_augment(pool[torch.from_numpy(idx).cuda()], off, flip, cfg.size)
    if not torch.equal(got, want):
        fail("HBMDataset(raw=False) differs from apply_augment on the same draws")
    print(f"[train-hbm] HBMDataset(raw=False) batch {tuple(got.shape)} equals apply_augment on "
          f"the same rows and draws")

    # a tiny config, 3 uint8 steps on the card and on the CPU, B1 and B2 on;
    # one CPU generator stream makes both draw the same crops, t and noise
    tiny = tiny_test_config(fused_diffusion=True, optimizer="adam_fused", lr_schedule="constant",
                            learning_rate=1e-3)
    small = np.random.default_rng(22).integers(0, 256, (6, 20, 22, 3), dtype=np.uint8)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = trainer.init_state(tiny, torch.Generator().manual_seed(0), device=dev)
        step, gen = trainer.make_train_step(tiny), torch.Generator().manual_seed(5)
        data = iter(aug.HBMDataset(small, tiny.size, 2, seed=1, raw=True, device=dev))
        b1, b2 = fd.diffuse_fused.launches, adam_kernel.adam_fused.launches
        losses[dev] = []
        for _ in range(3):
            state, loss = step(state, next(data), gen)
            losses[dev].append(float(loss))
        launched = (fd.diffuse_fused.launches - b1, adam_kernel.adam_fused.launches - b2)
        fd.diffuse_fused.launches, adam_kernel.adam_fused.launches = b1, b2
        if launched != ((0, 0) if dev == "cpu" else (3, 3)):
            fail(f"train-hbm tiny on {dev}: B1/B2 launches {launched}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[train-hbm] tiny uint8 train, 3 steps: losses card {losses['cuda']} CPU "
          f"{losses['cpu']}; max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny uint8 training on the card differs from the CPU by {rel} relative")
    del pool, ds
    torch.cuda.empty_cache()
    return launches


def phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg):
    """One injected step at full width from the same weights, t and ε:
    kernel path (B4 fwd+bwd, B2) against plain path (cuDNN, optax-form
    Adam), float32, constant LR 1e-3 so that the update (≈ ±lr per element
    on Adam's first step) stands far above a float32 ulp of the weights.
    Bounds: loss within 1e-5 relative (IEEE float32 convs, other orders);
    updates within 1e-3·lr for all but 1e-4 of the elements (an element
    whose gradient is ~0 may flip its update's sign between two correct
    orders of summation)."""
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).cuda()
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, TRAIN_BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).cuda()
    lr = 1e-3
    init = api.init_denoiser(cfg, device="cpu")
    p0 = [p.detach().cuda() for p in init.parameters()]
    out = {}
    for path, impl, opt in (("kernels", "pallas", "adam_fused"), ("plain", "lax", "adam_tf")):
        c = cfg.replace(batch_size=TRAIN_BATCH, conv_impl=impl, optimizer=opt,
                        lr_schedule="constant", learning_rate=lr).validate()
        model = copy.deepcopy(init).cuda()
        opt_state = trainer.make_optimizer(c).init(list(model.parameters()))
        state = trainer.TrainState(0, model, opt_state, None, None)
        b4, b2 = fdc.down_conv_fused.launches, adam_kernel.adam_fused.launches
        state, loss = trainer.make_injected_train_step(c)(state, x, t, eps)
        torch.cuda.synchronize()
        launched = (fdc.down_conv_fused.launches - b4, adam_kernel.adam_fused.launches - b2)
        fdc.down_conv_fused.launches, adam_kernel.adam_fused.launches = b4, b2
        if launched != ((b4_per_call(fdc, cfg, TRAIN_BATCH), 1) if path == "kernels" else (0, 0)):
            fail(f"train-agree {path}: B4/B2 launches {launched}")
        out[path] = (float(loss), [(p.detach() - q) for p, q in zip(model.parameters(), p0)])
        del state, model
    (lk, dk), (lp, dp) = out["kernels"], out["plain"]
    rel = abs(lk - lp) / abs(lp)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(dk, dp)])
    frac = (diff > 1e-3 * lr).double().mean().item()
    mean_update = torch.cat([a.abs().flatten() for a in dp]).mean().item()
    print(f"[train-agree] one injected step, {cfg.size}², batch {TRAIN_BATCH}, fp32: loss kernels "
          f"{lk:.7f} plain {lp:.7f} (rel {rel:.2e}, bound 1e-5); updates: mean |Δp| "
          f"{mean_update:.3e} (lr {lr}), max|Δk − Δp| {diff.max().item():.3e}, share of "
          f"elements beyond 1e-3·lr {frac:.2e} (bound 1e-4) of {diff.numel()}")
    if not rel <= 1e-5 or not frac <= 1e-4:
        fail(f"kernel and plain training paths disagree: loss rel {rel}, share {frac}")


# ----------------------------------------------- the train commands (files in)


def write_class_pngs(tmp):
    """CLI_FILES[0] circles in ``tmp/a`` and as many crosses in ``tmp/b``,
    CLI_FILES[1]² PNGs from ``data/synthetic.py``, written with the port's
    own PNG writer. Returns the two globs."""
    from gan_class_transfer2_tpu_torch.data import synthetic

    n, side = CLI_FILES
    t0 = time.perf_counter()
    synthetic.save_as_pngs(synthetic.circles(n, side, seed=0), os.path.join(tmp, "a"))
    synthetic.save_as_pngs(synthetic.crosses(n, side, seed=0), os.path.join(tmp, "b"))
    print(f"[train-cli] wrote {2 * n} synthetic {side}² PNGs (circles, crosses) in "
          f"{time.perf_counter() - t0:.2f} s")
    return os.path.join(tmp, "a", "*.png"), os.path.join(tmp, "b", "*.png")


def _width(cfg, names=("size", "pixel_size", "max_size", "octaves", "steps")):
    return [f"--{k.replace('_', '-')}={getattr(cfg, k)}" for k in names]


def _train_cli(cfg, tmp, log, ckpt, *extra):
    """``cli train`` at the default width on the kernel path, float32,
    batch 16, CLI_STEPS steps an epoch and a checkpoint at each epoch's end
    (the newest one kept), from every PNG under ``tmp``."""
    return ["train", "--device", "cuda", *_width(cfg), *KERNEL_PATH, "--compute-dtype",
            "float32", "--batch-size", str(TRAIN_BATCH), "--steps-per-epoch", str(CLI_STEPS),
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1",
            "--sample-stride", "50", "--dataset-pattern", os.path.join(tmp, "*", "*.png"),
            "--log-dir", os.path.join(tmp, log), "--checkpoint-dir", os.path.join(tmp, ckpt),
            *extra]


def _events(log_dir):
    """{tag: [(epoch, value), ...]} of the one event file a run wrote under
    ``log_dir`` (the reference's <day>/<time> layout), read back with the
    port's own reader."""
    import glob

    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    files = glob.glob(os.path.join(log_dir, "*", "*", "events.out.tfevents.*"))
    if len(files) != 1:
        fail(f"{log_dir}: {len(files)} event files, expected 1")
    out = {}
    for step, tag, _, value in tb.read_events(files[0]):
        out.setdefault(tag, []).append((step, value))
    return out


def _run_cli(cli, counters, args):
    """``cli.main(args)`` with every counter in ``counters`` (kernel
    wrappers) set to 0 just before; returns (their launches, seconds)."""
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args)
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {' '.join(args[:1])} returned {rc}")
    return tuple(c.launches for c in counters), secs


def phase_train_cli(torch, cli, fdc, fd, adam_kernel, sampler, cfg, tmp):
    """The user's training command, ``cli.main(["train", ...])``, streaming
    the PNG files from disk through the native C++ loader (the default
    ``--native-loader true``, ``--data-hbm 0 --data-workers 2``) with
    ``--fid-samples EVAL_SAMPLES``: the default model, float32, batch 16, 2
    epochs × CLI_STEPS steps on the kernel path, a checkpoint each epoch and
    one ``log_sample`` (at stride 50). The dataset must be the
    ``NativeImageDataset``. Exact B1/B2/B4 launches (the train steps, and B4
    in log_sample's denoiser calls: the preview, T invert steps, the
    stride-50 sample, and the FID/KID sample of EVAL_SAMPLES), finite losses,
    every reference tag and ``fid``/``kid`` in the event file, the last
    checkpoint. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.data import native_loader, pipeline
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    steps = 2 * CLI_STEPS
    sample_calls = len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    calls = 1 + cfg.steps + sample_calls
    b4 = b4_per_call(fdc, cfg, TRAIN_BATCH)
    b4_fid = sample_calls * b4_per_call(fdc, cfg, EVAL_SAMPLES)
    want = (steps, steps * adam_kernel.launches_per_step(n_leaves), (steps + calls) * b4 + b4_fid)
    args = _train_cli(cfg, tmp, "logs-cli", "ckpt-cli", "--epochs", "2", "--data-hbm", "0",
                      "--data-workers", "2", "--log-images-every", "2",
                      "--fid-samples", str(EVAL_SAMPLES))
    built = []
    make_datasets = pipeline.make_datasets

    def recording(*a, **kw):
        out = make_datasets(*a, **kw)
        built.extend(type(d).__name__ for d in out)
        return out

    pipeline.make_datasets = recording
    try:
        got, secs = _run_cli(cli, (fd.diffuse_fused, adam_kernel.adam_fused,
                                   fdc.down_conv_fused), args)
    finally:
        pipeline.make_datasets = make_datasets
    if built != [native_loader.NativeImageDataset.__name__]:
        fail(f"train-cli: the datasets were {built}, expected one NativeImageDataset")
    if got != want:
        fail(f"train-cli: launches B1/B2/B4 {got}, expected {want} ({steps} steps, "
             f"{calls} denoiser calls in one log_sample and {sample_calls} for its FID/KID "
             f"sample of {EVAL_SAMPLES})")
    ev = _events(os.path.join(tmp, "logs-cli"))
    missing = [t for t in (*REF_TAGS, "fid", "kid") if t not in ev]
    if missing:
        fail(f"train-cli: the event file lacks the tags {missing}")
    fid, kid = ev["fid"][0][1], ev["kid"][0][1]
    if not (np.isfinite(fid) and np.isfinite(kid)):
        fail(f"train-cli: fid {fid}, kid {kid}")
    losses, ips = dict(ev["loss"]), dict(ev["images_per_sec"])
    if sorted(losses) != [0, 1] or not all(np.isfinite(v) for v in losses.values()):
        fail(f"train-cli: epoch losses {losses}")
    if ckpt_lib.all_steps(os.path.join(tmp, "ckpt-cli")) != [steps]:
        fail(f"train-cli: checkpoints {ckpt_lib.all_steps(os.path.join(tmp, 'ckpt-cli'))}")
    for e in (0, 1):
        print(f"[train-cli] epoch {e}: loss {losses[e]:.7f}, {ips[e]:.3f} img/s "
              f"({TRAIN_BATCH * CLI_STEPS} images from PNG files{', after log_sample' if e == 0 else ''})")
    print(f"[train-cli] fp32 kernel path on the NativeImageDataset, {steps} steps + one "
          f"log_sample ({calls} denoiser calls + {sample_calls} for FID/KID of {EVAL_SAMPLES} "
          f"samples): launches B1/B2/B4 {got}; every reference tag logged; fid {fid:.6f}, kid "
          f"{kid:.6f} (random-init weights after {steps} steps, against {EVAL_SAMPLES} held-out "
          f"files); checkpoint step {steps}; wall {secs:.2f} s")
    return {"diffuse_f32": got[0], "adam_f32m": got[1], "down_conv_k4s2_f32": got[2]}


def phase_train_resume(torch, cli, fdc, fd, adam_kernel, trainer, sampler, png, cfg, tmp):
    """A resumed run against an unbroken one, from the HBM-resident pool
    (``--data-hbm 288``: the index stream and the augment replay exactly)
    with an EMA: run A trains 2 epochs in one call; run B trains
    ``--epochs 1``, then ``--epochs 2`` on the same checkpoint dir, which
    must restore and run exactly CLI_STEPS steps. B's epoch-1 loss must
    equal A's within 1e-5 relative (cuDNN's weight gradients may sum in
    another order). Then ``cli sample --checkpoint-dir`` of A's dir must
    write the images that A's restored EMA params give in this process
    (within one uint8 level, in at most 1e-3 of the values), and one save
    of that state is timed. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, cfg, TRAIN_BATCH))
    counters = (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused)
    common = ("--data-hbm", "288", "--log-images-every", "0", "--ema-decay", "0.999")
    total = [0, 0, 0]
    loss, secs = {}, {}
    for log, ckpt, epochs, n in (("logs-A", "ckpt-A", 2, 2), ("logs-B1", "ckpt-B", 1, 1),
                                 ("logs-B2", "ckpt-B", 2, 1)):
        got, secs[log] = _run_cli(cli, counters,
                                  _train_cli(cfg, tmp, log, ckpt, "--epochs", str(epochs), *common))
        want = tuple(n * CLI_STEPS * k for k in per_step)
        if got != want:
            fail(f"train-resume {log}: launches B1/B2/B4 {got}, expected {want} "
                 f"({n * CLI_STEPS} steps)")
        total = [t + g for t, g in zip(total, got)]
        loss[log] = dict(_events(os.path.join(tmp, log))["loss"])
    a, b = loss["logs-A"], {**loss["logs-B1"], **loss["logs-B2"]}
    if sorted(b) != [0, 1] or sorted(a) != [0, 1]:
        fail(f"train-resume: epochs logged A {sorted(a)}, B {sorted(b)}")
    rel = {e: abs(a[e] - b[e]) / abs(a[e]) for e in (0, 1)}
    print(f"[train-resume] data_hbm 288, EMA 0.999: A (one call) epoch losses {a[0]:.9f}, "
          f"{a[1]:.9f}; B (--epochs 1, then --epochs 2 restored at step {CLI_STEPS}: "
          f"{CLI_STEPS} steps) {b[0]:.9f}, {b[1]:.9f}; relative differences epoch 0 "
          f"{rel[0]:.3e}, epoch 1 {rel[1]:.3e} (bound 1e-5); wall A {secs['logs-A']:.2f} s, "
          f"B {secs['logs-B1']:.2f} + {secs['logs-B2']:.2f} s")
    if not rel[1] <= 1e-5:
        fail(f"train-resume: the resumed epoch-1 loss differs by {rel[1]} relative")

    ckpt = os.path.join(tmp, "ckpt-A")
    out = os.path.join(tmp, "samples-A")
    got, s_secs = _run_cli(cli, (fdc.down_conv_fused,), [
        "sample", "--device", "cuda", "--checkpoint-dir", ckpt, "--num", str(BATCH),
        "--out", out])
    total[2] += got[0]
    c = ckpt_lib.load_config(ckpt)
    state = ckpt_lib.restore(ckpt, trainer.init_state(c, device="cuda"))
    if state.ema_params is None or state.step != 2 * CLI_STEPS:
        fail(f"train-resume: A's checkpoint holds step {state.step}, EMA "
             f"{state.ema_params is not None}")
    init = torch.from_numpy(np.random.default_rng(c.seed).normal(
        size=(BATCH, c.size, c.size, 3)).astype(np.float32)).cuda()
    fdc.down_conv_fused.launches = 0
    images = sampler.sample(c, trainer.eval_model(state), init, snapshots=False).images
    fdc.down_conv_fused.launches = 0  # the in-process comparison does not count
    diff = np.stack([np.abs(png.read_png(os.path.join(out, f"sample_{i}.png")).astype(int)
                            - png.to_uint8(images[i].cpu().numpy()).astype(int))
                     for i in range(BATCH)])
    # the same weights and inputs; float32 sums may round differently between
    # two allocations (cuBLAS picks kernels by alignment), so a value on a
    # level boundary may flip by one level, as in [sample]
    print(f"[train-resume] cli sample --checkpoint-dir (step {state.step}, EMA params, "
          f"{got[0]} B4 launches, {s_secs:.2f} s) against A's restored EMA sampled in "
          f"process: max {diff.max()} uint8 levels apart (bound {IMAGE_LEVELS['float32']}), "
          f"{int((diff > 0).sum())} of {diff.size} values differ")
    if diff.max() > IMAGE_LEVELS["float32"] or (diff > 0).mean() > 1e-3:
        fail(f"train-resume: sample --checkpoint-dir differs by {diff.max()} levels in "
             f"{int((diff > 0).sum())} values")

    # the checkpoint layer: one save of this state (model, Adam moments, EMA)
    t0 = time.perf_counter()
    snap = ckpt_lib.host_complete(state)
    t1 = time.perf_counter()
    path = ckpt_lib.save(os.path.join(tmp, "ckpt-timed"), snap, c)
    t2 = time.perf_counter()
    size = os.path.getsize(os.path.join(path, ckpt_lib.STATE_FILE))
    print(f"[train-resume] one checkpoint of the default model's train state ({size / 1e6:.1f} "
          f"MB): copy to the host {(t1 - t0) * 1e3:.1f} ms, write {(t2 - t1) * 1e3:.1f} ms")
    del state, images, snap
    torch.cuda.empty_cache()
    return {"diffuse_f32": total[0], "adam_f32m": total[1], "down_conv_k4s2_f32": total[2]}


# ------------------------------------------ the native loader and the cache


def _paeth_png(img):
    """PNG bytes of (H, W, 3) uint8 whose even rows use the Paeth filter and
    odd rows the Average filter (the two a Python decoder runs byte by
    byte); filtering reads the raw bytes only, so numpy does it at once."""
    import struct
    import zlib

    from gan_class_transfer2_tpu_torch.utils import png

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    ftype = np.where(np.arange(h) % 2 == 0, 4, 3).astype(np.uint8)
    pred = np.where(ftype[:, None] == 4, paeth, (a + b) // 2)
    rows = np.concatenate([ftype[:, None], ((x - pred) % 256).astype(np.uint8)], 1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def write_paeth_pngs(directory):
    """PAETH_FILES[0] photo-like PNGs of PAETH_FILES[1]²: the synthetic
    circles with Gaussian noise (σ = 6 levels), Paeth and Average rows.
    Returns their glob."""
    from gan_class_transfer2_tpu_torch.data import synthetic
    from gan_class_transfer2_tpu_torch.utils import png

    n, side = PAETH_FILES
    os.makedirs(directory, exist_ok=True)
    imgs = png.to_uint8(synthetic.circles(n, side, seed=1)).astype(np.int16)
    imgs = np.clip(imgs + np.random.default_rng(0).normal(0, 6, imgs.shape), 0, 255)
    for i, img in enumerate(imgs.astype(np.uint8)):
        with open(os.path.join(directory, f"p_{i:04d}.png"), "wb") as fh:
            fh.write(_paeth_png(img))
    return os.path.join(directory, "*.png")


def phase_loader(globs, paeth_glob, step_ips):
    """The native C++ loader on the card's machine: the codec probe (the
    libpng, libjpeg and zlib headers and libraries, Pillow), the library
    built with the host's g++ (a failed build fails the phase), its
    decode against utils/png on every PNG of the smoke (the filter-0 class
    files and the Paeth/Average files), and decode img/s at batch 16 for
    NativeImageDataset with 2 and 8 workers and the Python ImageDataset
    with 2 threads, on the Paeth/Average files (288² → crops of 256²),
    beside what the float32 training step consumes (``step_ips``)."""
    import glob
    import importlib.util

    from gan_class_transfer2_tpu_torch.data import native_loader, pipeline
    from gan_class_transfer2_tpu_torch.utils import png

    for header in ("png.h", "jpeglib.h", "zlib.h"):
        # jpeglib.h needs stdio's FILE and size_t declared before it
        r = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input=f"#include <cstdio>\n#include <{header}>\n",
                           capture_output=True, text=True)
        print(f"[loader] probe: #include <{header}> {'found' if r.returncode == 0 else 'missing'}")
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    names = sorted({ln.split()[0] for ln in libs.splitlines()
                    if ln.strip().startswith(("libpng", "libjpeg", "libz."))})
    print(f"[loader] probe: ldconfig -p has {names}; Pillow importable: "
          f"{importlib.util.find_spec('PIL') is not None}")
    t0 = time.perf_counter()
    if not native_loader.available():
        fail(f"loader: the native loader did not build:\n{native_loader.build_error()}")
    print(f"[loader] dataloader.cc built with g++ and loaded in {time.perf_counter() - t0:.2f} s")

    files = sorted(glob.glob(globs[0]) + glob.glob(globs[1]))
    paeth = sorted(glob.glob(paeth_glob))
    t0 = time.perf_counter()
    for f in files + paeth:
        want = png.read_png(f).astype(np.float32) / 128.0 - 1.0
        if not np.array_equal(native_loader.decode_one(f, 0, augment=False), want):
            fail(f"loader: the native decode of {f} differs from utils/png")
    print(f"[loader] native decode equals utils/png on {len(files)} filter-0 PNGs and "
          f"{len(paeth)} Paeth/Average PNGs of {PAETH_FILES[1]}² ({time.perf_counter() - t0:.2f} s)")

    def rate(make, batches):
        """img/s from the dataset's creation to its ``batches``-th batch (a
        prefetch window filled ahead of the timing would inflate it)."""
        t0 = time.perf_counter()
        ds = make()
        it = iter(ds)
        for _ in range(batches):
            b = next(it)
        secs = time.perf_counter() - t0
        ds.close()
        if b.shape != (TRAIN_BATCH, 256, 256, 3):
            fail(f"loader: batch {b.shape}")
        return batches * TRAIN_BATCH / secs

    rates = {}
    for workers in (2, 8):
        rates[f"native, {workers} workers"] = rate(lambda: native_loader.NativeImageDataset(
            paeth, 256, TRAIN_BATCH, seed=0, num_workers=workers), 16)
    rates["python, 2 threads"] = rate(lambda: pipeline.ImageDataset(
        paeth, 256, TRAIN_BATCH, seed=0, num_workers=2), 4)
    for name, ips in rates.items():
        print(f"[loader] decode + crop + flip + normalise at batch {TRAIN_BATCH}, Paeth/Average "
              f"{PAETH_FILES[1]}² PNGs, {name}: {ips:.3f} img/s ({ips / step_ips:.2f}x the "
              f"{step_ips:.3f} img/s a float32 training step consumes)")
    return rates


def phase_cache(torch, cli, fdc, fd, adam_kernel, cfg, tmp, paeth_glob):
    """``cli build-cache`` of the Paeth/Average PNGs at store 288, then a
    Runner fed ``AugmentedCachedDataset`` (uint8 batches to the card, crop,
    flip and normalise there) for CLI_STEPS steps at the default width,
    float32, batch 16, on the kernel path: exact B1/B2/B4 launches, a finite
    loss, img/s. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.data import cache
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.train.loop import Runner
    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    path = os.path.join(tmp, "paeth.gct2cache")
    t0 = time.perf_counter()
    rc = cli.main(["build-cache", "--device", "cuda", "--dataset-pattern", paeth_glob,
                   "--store", str(PAETH_FILES[1]), "--out", path])
    build_s = time.perf_counter() - t0
    data, store = cache.read_cache(path)
    if rc != 0 or data.shape != (PAETH_FILES[0], store, store, 3) or store != PAETH_FILES[1]:
        fail(f"cache: build-cache returned {rc}, records {data.shape}")
    c = cfg.replace(conv_impl="pallas", optimizer="adam_fused", fused_diffusion=True,
                    compute_dtype="float32", batch_size=TRAIN_BATCH, checkpoint_dir=None,
                    log_images_every=0).validate()
    n_leaves = len(list(unet.Denoiser(c).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, c, TRAIN_BATCH))
    ds = cache.AugmentedCachedDataset(path, c.size, TRAIN_BATCH, seed=0, device="cuda")
    runner = Runner(c, dataset=ds, log_dir=os.path.join(tmp, "logs-cache"), device="cuda")
    counters = (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    runner.fit(epochs=1, steps_per_epoch=CLI_STEPS, log_samples=False)
    secs = time.perf_counter() - t0
    got = tuple(k.launches for k in counters)
    runner.close()
    want = tuple(CLI_STEPS * k for k in per_step)
    if got != want:
        fail(f"cache: launches B1/B2/B4 {got}, expected {want} ({CLI_STEPS} steps)")
    ev = {tag: value for _, tag, _, value in tb.read_events(runner.writer.path)}
    if not np.isfinite(ev.get("loss", np.nan)):
        fail(f"cache: loss {ev.get('loss')}")
    print(f"[cache] cli build-cache: {PAETH_FILES[0]} Paeth/Average PNGs -> {store}² uint8 "
          f"records ({os.path.getsize(path) / 1e6:.1f} MB) in {build_s:.2f} s; Runner on "
          f"AugmentedCachedDataset, fp32 kernel path, {CLI_STEPS} steps at batch "
          f"{TRAIN_BATCH}: launches B1/B2/B4 {got}, loss {ev['loss']:.7f}, "
          f"{ev['images_per_sec']:.3f} img/s (the first steps included), wall {secs:.2f} s")
    del runner, ds
    torch.cuda.empty_cache()
    return {"diffuse_f32": got[0], "adam_f32m": got[1], "down_conv_k4s2_f32": got[2]}


# ------------------------------------------------------------------ GAN


def gan_counts(fdc, cfg, batch):
    """What one cycle-GAN step of ``cfg`` launches, derived from the config
    as models/unet.py, models/discriminator.py and train/gan.py build it:
    ({(H=W, C): B3 launches per step}, B4 launches per step, (B3, B4) per
    generator forward). Norms follow every G down and up conv and every D
    conv but the first; B4 takes the down convs its gate admits."""
    from collections import Counter

    from gan_class_transfer2_tpu_torch.models import discriminator as d_lib

    g_norms, g_b4 = Counter(), b4_per_call(fdc, cfg, batch)
    for i in range(cfg.octaves):
        g_norms[(cfg.size >> (i + 1), cfg.octave_filters(i))] += 1  # down_norm
        g_norms[(cfg.size >> i, cfg.octave_up_filters(i))] += 1  # up_norm
    d_norms, d_b4, c = Counter(), 0, 3
    for i in range(d_lib.d_octaves(cfg)):
        f, hw = d_lib.d_filters(cfg, i), cfg.size >> i
        d_b4 += fdc.supported((batch, hw, hw, c), (4, 4, c, f))
        if i > 0:
            d_norms[(hw // 2, f)] += 1
        c = f
    # G forwards: two fakes, two cycle, two identity; D applies: two in the
    # G loss, four in the D loss (train/gan.py, gan.py:165-249)
    n_g = 2 + 2 * cfg.cycle_term_active + 2 * cfg.identity_term_active
    n_d = 6
    per_step = Counter({k: n_g * v for k, v in g_norms.items()})
    per_step.update({k: n_d * v for k, v in d_norms.items()})
    return dict(per_step), n_g * g_b4 + n_d * d_b4, (sum(g_norms.values()), g_b4)


def phase_gan_kernels(torch, F, fdc, norm, cfg):
    """B3 against its plain version at the GAN path's distinct shapes at
    batch 16, float32 and bfloat16: the forward and the Function's dx, dγ,
    dβ (its backward is torch ops) against autograd through the plain
    version; the kernel, the plain version, F.instance_norm and the
    backward timed beside the byte bound. Then B4 with ``relu=False`` (every
    GAN down conv) at its four shapes at batch 16. Returns {dtype: row
    without launches} with times summed over one step's launches."""
    per_step, _, _ = gan_counts(fdc, cfg, TRAIN_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bwd_ms=0.0, err=0.0)
        worst = {"y": 0.0, "dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
        for (hw, c), n in sorted(per_step.items(), reverse=True):
            x = (torch.randn((TRAIN_BATCH, hw, hw, c), generator=gen, device="cuda") * 3 + 2)
            x = x.to(dtype)
            g = 1 + 0.2 * torch.randn((c,), generator=gen, device="cuda")
            b = 0.2 * torch.randn((c,), generator=gen, device="cuda")
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            before = norm.instance_norm_fused.launches
            y = norm.instance_norm_fused(x, g, b)
            yp = norm.instance_norm_plain(x, g, b)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            if not err <= IN_RTOL[dtype_name] * scale:
                fail(f"B3 {dtype_name} x{tuple(x.shape)}: max|err| {err} > "
                     f"{IN_RTOL[dtype_name]} x max|y| {scale}")
            s["err"] = max(s["err"], err)
            worst["y"] = max(worst["y"], err / scale)
            leaves = [[t.clone().requires_grad_() for t in (x, g, b)] for _ in range(2)]
            out = norm.instance_norm(*leaves[0])
            ref = norm.instance_norm_plain(*leaves[1])
            got = torch.autograd.grad(out, leaves[0], dy, retain_graph=True)
            want = torch.autograd.grad(ref, leaves[1], dy)
            for gname, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
                gerr = (a.float() - w.float()).abs().max().item()
                gscale = w.float().abs().max().item()
                if not gerr <= IN_GRAD_RTOL[dtype_name] * gscale:
                    fail(f"B3 {gname} {dtype_name} x{tuple(x.shape)}: max|err| {gerr} > "
                         f"{IN_GRAD_RTOL[dtype_name]} x max|{gname}| {gscale}")
                worst[gname] = max(worst[gname], gerr / gscale)
            ms = cuda_ms(lambda: norm.instance_norm_fused(x, g, b))
            plain_ms = cuda_ms(lambda: norm.instance_norm_plain(x, g, b))
            # one library call of the same function: cuDNN/ATen instance norm
            # on the NCHW view of the same NHWC memory
            xl, gl, bl = x.permute(0, 3, 1, 2), g.to(dtype), b.to(dtype)
            lib_ms = cuda_ms(lambda: F.instance_norm(xl, weight=gl, bias=bl, eps=1e-5))
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves[0], dy, retain_graph=True))
            norm.instance_norm_fused.launches = before  # comparison launches do not count
            nbytes = 2 * x.numel() * x.element_size() + 2 * 4 * c  # x in, y out; γ, β
            bound = _bytes_ms(nbytes)
            plan = norm.plan(*x.shape)
            print(f"[gan-kernel] B3 {dtype_name} x{tuple(x.shape)} (x{n} a step): cluster "
                  f"{plan.cluster} ({plan.blocks} blocks, chunk {plan.chunk} px); max|err| "
                  f"{err:.3e} (max|y| {scale:.3f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.instance_norm {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes) = "
                  f"{bound / ms:.1%} of bound; backward (torch ops) {bwd_ms:.4f} ms, its bound "
                  f"{1.5 * bound:.4f} ms (bytes: x and dy read, dx written)")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound), ("bwd_ms", bwd_ms)):
                s[k] += n * v
            del x, y, yp, dy, leaves, out, ref, got, want, xl
        print(f"[gan-kernel] B3 {dtype_name}: {sum(per_step.values())} launches a step over "
              f"{len(per_step)} shapes; max error relative to the largest value: y "
              f"{worst['y']:.2e} (bound {IN_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dγ "
              f"{worst['dgamma']:.2e}, dβ {worst['dbeta']:.2e} (bound "
              f"{IN_GRAD_RTOL[dtype_name]}); a step's norms: kernel {s['ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, F.instance_norm {s['library_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms (bytes); backward (torch ops) {s['bwd_ms']:.4f} ms, its "
              f"bound {1.5 * s['bound_ms']:.4f} ms (bytes)")
        # a large mean, x = 3·N(0, 1) + 100: where a one-pass E[x²] − m² loses
        # the variance's digits; the kernel's Welford/Chan combine must not
        for shape in ((TRAIN_BATCH, 64, 64, 256), (TRAIN_BATCH, 256, 256, 64)):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 100).to(dtype)
            g = 1 + 0.2 * torch.randn((shape[3],), generator=gen, device="cuda")
            b = 0.2 * torch.randn((shape[3],), generator=gen, device="cuda")
            before = norm.instance_norm_fused.launches
            y = norm.instance_norm_fused(x, g, b)
            yp = norm.instance_norm_plain(x, g, b)
            norm.instance_norm_fused.launches = before
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            print(f"[gan-kernel] B3 {dtype_name} large mean x{shape} = 3·N(0,1) + 100: max|err| "
                  f"{err:.3e} (max|y| {scale:.3f}, bound {IN_RTOL[dtype_name]} x max|y|)")
            if not err <= IN_RTOL[dtype_name] * scale:
                fail(f"B3 {dtype_name} large mean x{shape}: max|err| {err} > "
                     f"{IN_RTOL[dtype_name]} x max|y| {scale}")
            s["err"] = max(s["err"], err)
            del x, y, yp
        name = f"instance_norm_{'f32' if dtype_name == 'float32' else 'bf16'}"
        rows[dtype_name] = {
            "name": name, "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "gan_class_transfer2_tpu/ops/norm.py:48", "launches": 0,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"]}
        torch.cuda.empty_cache()

    b4_err = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        b4_err[dtype_name], worst, _, _ = b4_batch16(torch, fdc, gen, dtype_name, dtype,
                                                     relu=False, timed=False)
        print(f"[gan-kernel] B4 relu=False {dtype_name}, batch {TRAIN_BATCH}, four shapes: max "
              f"error relative to the largest value: y {worst['y']:.2e} (bound "
              f"{KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK {worst['dK']:.2e}, db "
              f"{worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]})")
    return rows, b4_err


def phase_gan(torch, cli, fdc, norm, gan, cfg, tmp):
    """The GAN slice through its entry point, ``cli profile --model gan``,
    at the default width (both generators the default U-Net, both
    discriminators the default, batch 16 per class, instance norms on,
    ``--conv-impl pallas``), float32 and bfloat16: exact B3 and B4 launch
    counts, finite losses, and the trace's breakdown; then the same step
    timed without the profiler, and ``gan.transfer`` at batch 4. Returns
    {dtype: (B3 launches, B4 launches)} of the main-path runs."""
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, cfg, TRAIN_BATCH)
    b3_step = sum(per_step.values())
    steps = GAN_WARM + GAN_PROFILE_STEPS
    print(f"[gan] per step: {b3_step} B3 launches "
          f"({', '.join(f'{n}x{hw}²x{c}' for (hw, c), n in sorted(per_step.items()))}), "
          f"{b4_step} B4 launches; per generator forward {b3_fwd} B3, {b4_fwd} B4")
    width = [f"--{k.replace('_', '-')}={getattr(cfg, k)}"
             for k in ("size", "pixel_size", "max_size", "octaves")]
    launches = {}
    for dtype in ("float32", "bfloat16"):
        args = ["profile", "--device", "cuda", "--model", "gan", *width, "--batch-size",
                str(TRAIN_BATCH), "--compute-dtype", dtype, "--profile-steps",
                str(GAN_PROFILE_STEPS), "--trace-dir", os.path.join(tmp, f"gan-{dtype}"),
                *GAN_FLAGS]
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        *rows, out = _cli_json(cli, args)  # kernel rows, then the summary line
        got = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        want = (steps * b3_step, steps * b4_step)
        if got != want:
            fail(f"gan {dtype}: B3/B4 launches {got}, expected {want} "
                 f"({b3_step}/{b4_step} a step x {steps} steps)")
        launches[dtype] = got
        final = out["final"]
        if not (np.isfinite(final["g_loss"]) and np.isfinite(final["d_loss"])):
            fail(f"gan {dtype}: losses {final}")
        busy, wall = out["device_busy_ms_per_step"], out["wall_ms_per_step"]
        print(f"[gan] {dtype}: launches B3/B4 {got} over {steps} steps; under the profiler "
              f"{wall:.3f} ms a step, {out['images_per_sec']:.3f} img/s per class, device busy "
              f"{busy:.3f} ms a step (idle {max(0.0, 1 - busy / wall):.1%}); g_loss "
              f"{final['g_loss']:.5f}, d_loss {final['d_loss']:.5f}")
        for r in rows[:8]:
            print(f"[gan]   {r['ms_per_step']:9.3f} ms x{r['calls']:<5d} {r['op'][:100]}")

        # the same step without the profiler, batches already on the card
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype, g_norm="instance",
                        d_norm="instance", conv_impl="pallas").validate()
        state = gan.init_gan_state(c, device="cuda")
        step = gan.make_gan_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(3)
        a, b = (torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen, device="cuda") * 2 - 1
                for _ in range(2))
        times = []
        for i in range(GAN_WARM + GAN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, a, b, gen)
            float(m["g_loss"])
            if i >= GAN_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        med = sorted(times)[len(times) // 2]
        print(f"[gan] {dtype}: without the profiler {med:.3f} ms a step (median of "
              f"{len(times)}: {[round(t, 3) for t in times]}), "
              f"{TRAIN_BATCH / med * 1e3:.3f} img/s per class; idle share against the "
              f"profile's busy time {max(0.0, 1 - busy / med):.1%}")

        # transfer at batch 4: one generator forward
        x = a[:4].contiguous()
        with torch.inference_mode():
            for _ in range(2):
                gan.transfer(c, state, x)
            norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
            y = gan.transfer(c, state, x)
            one = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
            if one != (b3_fwd, b4_fwd) or y.shape != x.shape or not torch.isfinite(y).all():
                fail(f"gan.transfer {dtype}: launches {one} (expected {(b3_fwd, b4_fwd)}), "
                     f"shape {tuple(y.shape)}")
            ms = cuda_ms(lambda: gan.transfer(c, state, x), reps=10)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        print(f"[gan] {dtype}: gan.transfer at batch 4: {ms / 4:.4f} ms per image "
              f"({ms:.4f} ms a call), launches B3/B4 {one} a call")
        del state, step, a, b, x, y
        torch.cuda.empty_cache()
    return launches


def _instance_norm_f64(x, gamma, beta):
    """Instance norm in x's dtype (float64 for the reference step):
    two-pass statistics, no rounding to float32 anywhere."""
    m = x.mean(dim=(1, 2), keepdim=True)
    v = (x - m).square().mean(dim=(1, 2), keepdim=True)
    return (x - m) * (v + 1e-5).rsqrt() * gamma.to(x.dtype) + beta.to(x.dtype)


def phase_gan_agree(torch, fdc, norm, gan, cfg):
    """One full-width GAN step from the same initial state and batches,
    under ``optimizer="sgd"`` so that each update is −lr times the gradient,
    three ways: as the entry point runs it in float32 (B3, B4), through
    cuDNN with the plain instance norm in float32 (``conv_impl="lax"``,
    ``norm.instance_norm`` swapped for its plain version), and that plain
    path in float64 (the reference; the losses and D's logits stay float32
    as the step casts them). Both float32 paths sit at float32's own
    distance from the float64 update, ~1e-4 of G's largest update and
    ~1e-3 of D's (at this state D's gradient is a difference of nearly
    equal real and fake terms), and that distance moves between runs
    (cuDNN's weight gradients sum in a varying order), and differs between
    the two nets of a kind by up to 10× (a few elements carry it). Bounds:
    g_loss and d_loss of the two float32 paths within 1e-5 relative; for
    each kind of net (the two generators, the two discriminators), the
    kernel path's largest distance from the float64 update, in root mean
    square and at the largest element, at most 2× and 4× the plain float32
    path's largest over that kind, plus 1e-6; distances relative to each
    net's largest float64 update."""
    from gan_class_transfer2_tpu_torch.models import unet

    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    optimizer="sgd", lr_schedule="constant", learning_rate=1e-2).validate()
    r = np.random.default_rng(12)
    a, b = (torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, c.size, c.size, 3))
                             .astype(np.float32)).cuda() for _ in range(2))
    nets = ("g_ab", "g_ba", "d_a", "d_b")
    out = {}
    for path, impl in (("kernels", "pallas"), ("plain", "lax"), ("float64", "lax")):
        cp = c.replace(conv_impl=impl)
        state = gan.init_gan_state(cp, torch.Generator().manual_seed(0), device="cuda")
        xa, xb = a, b
        kernel_op, f32 = norm.instance_norm, unet.DTYPES["float32"]
        if path == "plain":  # apply_norm reads the module's instance_norm at each call
            norm.instance_norm = norm.instance_norm_plain
        if path == "float64":
            norm.instance_norm = _instance_norm_f64
            unet.DTYPES["float32"] = torch.float64  # the models' compute dtype
            for n in nets:
                getattr(state, n).double()
            state = state._replace(g_opt=gan.make_optimizer(cp).init(gan.g_params(state)),
                                   d_opt=gan._d_optimizer(cp).init(gan.d_params(state)))
            xa, xb = a.double(), b.double()
        before = {n: [p.detach().clone() for p in getattr(state, n).parameters()] for n in nets}
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        try:
            state, m = gan.make_gan_train_step(cp)(state, xa, xb, torch.Generator(device="cuda"))
            torch.cuda.synchronize()
        finally:
            norm.instance_norm, unet.DTYPES["float32"] = kernel_op, f32
        launched = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        per_step, b4_step, _ = gan_counts(fdc, cp, TRAIN_BATCH)
        want = (sum(per_step.values()), b4_step) if path == "kernels" else (0, 0)
        if launched != want:
            fail(f"gan-agree {path}: B3/B4 launches {launched}, expected {want}")
        deltas = {n: [(p.detach() - q).double() for p, q in
                      zip(getattr(state, n).parameters(), before[n])] for n in nets}
        out[path] = ({k: float(v) for k, v in m.items()}, deltas)
        del state, before
        torch.cuda.empty_cache()
    (mk, dk), (mp, dp), (m64, d64) = out["kernels"], out["plain"], out["float64"]
    rel = {k: abs(mk[k] - mp[k]) / abs(mp[k]) for k in ("g_loss", "d_loss")}

    def dist(x, y, n):
        """(rms, max) of x − y over net n, relative to its largest float64 update."""
        largest = max(t.abs().max().item() for t in d64[n])
        sq = sum((u - v).square().sum().item() for u, v in zip(x[n], y[n]))
        count = sum(u.numel() for u in x[n])
        top = max((u - v).abs().max().item() for u, v in zip(x[n], y[n]))
        return (sq / count) ** 0.5 / largest, top / largest

    ok = max(rel.values()) <= 1e-5
    report = []
    for kind in (("g_ab", "g_ba"), ("d_a", "d_b")):
        k = [dist(dk, d64, n) for n in kind]
        p = [dist(dp, d64, n) for n in kind]
        k_rms, k_max = max(x[0] for x in k), max(x[1] for x in k)
        p_rms, p_max = max(x[0] for x in p), max(x[1] for x in p)
        ok = ok and k_rms <= 2 * p_rms + 1e-6 and k_max <= 4 * p_max + 1e-6
        for n, (kr, km), (pr, pm) in zip(kind, k, p):
            report.append(f"{n} rms {kr:.2e} / {pr:.2e}, max {km:.2e} / {pm:.2e} "
                          f"(kernels − plain max {dist(dk, dp, n)[1]:.2e})")
    print(f"[gan-agree] one step, {c.size}², batch {TRAIN_BATCH}, sgd lr {c.learning_rate}: "
          f"g_loss kernels {mk['g_loss']:.7f} plain {mp['g_loss']:.7f} float64 "
          f"{m64['g_loss']:.7f} (kernels vs plain rel {rel['g_loss']:.2e}), d_loss "
          f"{mk['d_loss']:.7f} / {mp['d_loss']:.7f} / {m64['d_loss']:.7f} (rel "
          f"{rel['d_loss']:.2e}), bound 1e-5; updates, distance from the float64 update "
          f"over the net's largest float64 update, kernels / plain: {'; '.join(report)} "
          f"(bound, per kind of net: kernels ≤ 2 × plain in rms, 4 × plain at the max, "
          f"+ 1e-6)")
    if not ok:
        fail(f"GAN kernel path less accurate than the plain path: losses {rel}, {report}")


def phase_gan_reference(torch, fdc, norm, gan):
    """A tiny GAN config (no diffaug, float batches: the step draws
    nothing) whose discriminators reach B4 (128 channels), 3 steps on the
    card and on the CPU from the same weights: the losses agree within 1e-4
    relative (IEEE float32 on both; the CPU runs the plain versions, the
    card the kernels)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(g_norm="instance", d_norm="instance", size=32, d_pixel_size=128,
                           max_size=256, d_octaves=2, conv_impl="pallas",
                           lr_schedule="constant", learning_rate=1e-4)
    r = np.random.default_rng(13)
    batches = [tuple(torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
                     for _ in range(2)) for _ in range(3)]
    per_step, b4_step, _ = gan_counts(fdc, cfg, 2)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = gan.init_gan_state(cfg, torch.Generator().manual_seed(0), device=dev)
        step = gan.make_gan_train_step(cfg)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        losses[dev] = []
        for a, b in batches:
            state, m = step(state, a.to(dev), b.to(dev), torch.Generator(device=dev))
            losses[dev] += [float(m["g_loss"]), float(m["d_loss"])]
        launched = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        want = (0, 0) if dev == "cpu" else (3 * sum(per_step.values()), 3 * b4_step)
        if launched != want:
            fail(f"gan-reference on {dev}: B3/B4 launches {launched}, expected {want}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses["cuda"], losses["cpu"]))
    print(f"[gan-reference] tiny GAN, 3 steps, card vs CPU: g/d losses card "
          f"{[round(v, 7) for v in losses['cuda']]} CPU {[round(v, 7) for v in losses['cpu']]}; "
          f"max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny GAN training on the card differs from the CPU by {rel} relative")


def phase_gan_train_cli(torch, cli, fdc, norm, cfg, tmp, globs):
    """The user's GAN training command, ``cli.main(["gan-train", ...])``,
    on the two class folders of PNGs (circles → crosses) streamed from
    disk, at the default width with GAN_FLAGS, float32, batch 16 per class,
    CLI_STEPS steps, one checkpoint and one ``log_sample`` (three
    transfers of a fixed batch): exact B3/B4 launches, finite losses, the
    transfer tags, the checkpoint. Returns (B3, B4) launches."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    conv_impl="pallas")
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, c, TRAIN_BATCH)
    want = (CLI_STEPS * sum(per_step.values()) + 3 * b3_fwd, CLI_STEPS * b4_step + 3 * b4_fwd)
    args = ["gan-train", "--device", "cuda", *_width(cfg, ("size", "pixel_size", "max_size",
                                                           "octaves")),
            *GAN_FLAGS, "--compute-dtype", "float32", "--batch-size", str(TRAIN_BATCH),
            "--classes", *globs, "--steps-per-epoch", str(CLI_STEPS), "--epochs", "1",
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1",
            "--data-workers", "2", "--native-loader", "false",
            "--log-dir", os.path.join(tmp, "logs-gan"),
            "--checkpoint-dir", os.path.join(tmp, "ckpt-gan")]
    got, secs = _run_cli(cli, (norm.instance_norm_fused, fdc.down_conv_fused), args)
    if got != want:
        fail(f"gan-train-cli: launches B3/B4 {got}, expected {want} ({CLI_STEPS} steps and 3 "
             f"generator forwards in log_sample)")
    ev = _events(os.path.join(tmp, "logs-gan"))
    missing = [t for t in ("transfer_ab/image/0", "transfer_ba/image/0", "cycle_aba/image/0",
                           "g_loss", "d_loss", "cycle", "images_per_sec") if t not in ev]
    if missing:
        fail(f"gan-train-cli: the event file lacks {missing}")
    vals = {k: ev[k][0][1] for k in ("g_loss", "d_loss", "cycle", "images_per_sec")}
    if not all(np.isfinite(v) for v in vals.values()):
        fail(f"gan-train-cli: {vals}")
    if ckpt_lib.all_steps(os.path.join(tmp, "ckpt-gan")) != [CLI_STEPS]:
        fail("gan-train-cli: no checkpoint at the last step")
    print(f"[gan-train-cli] fp32, {CLI_STEPS} steps at batch {TRAIN_BATCH} per class from PNG "
          f"files + one log_sample: launches B3/B4 {got}; g_loss {vals['g_loss']:.5f}, d_loss "
          f"{vals['d_loss']:.5f}, cycle {vals['cycle']:.5f}; {vals['images_per_sec']:.3f} img/s "
          f"per class; checkpoint step {CLI_STEPS}; wall {secs:.2f} s")
    torch.cuda.empty_cache()
    return got


# ------------------------------------------------------------------ eval


def phase_eval(torch, cli, fdc, norm, sampler, cfg, tmp):
    """The user's ``cli.main(["eval", ...])``: ``--model diffusion`` on
    [train-cli]'s checkpoint (its config: the default width, T = 200, stride
    50, fid_samples EVAL_SAMPLES), exactly ``len(sample_timesteps)`` denoiser
    calls of B4 launches and a finite fid and kid; ``--model gan`` on
    [gan-train-cli]'s checkpoint with ``--fid-samples EVAL_SAMPLES``, two
    generator forwards (A→B, B→A) of exact B3/B4 launches and finite
    transfer scores. Then the trained extractor's features of 16 images at
    256² on the card against the CPU (within 1e-4 relative: IEEE float32
    convolutions in other orders), and ``run_sampler_benchmark`` at batch 16
    in float32 and bfloat16. Returns the eval commands' (B3, B4) launches."""
    from gan_class_transfer2_tpu_torch.utils import benchmark
    from gan_class_transfer2_tpu_torch.utils import fid_extractor as fx

    t_phase = time.perf_counter()
    sample_calls = len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    results = {}
    counters = (norm.instance_norm_fused, fdc.down_conv_fused)
    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    conv_impl="pallas")
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, c, EVAL_SAMPLES)
    wants = {"diffusion": (0, sample_calls * b4_per_call(fdc, cfg, EVAL_SAMPLES)),
             "gan": (2 * b3_fwd, 2 * b4_fwd)}
    total = [0, 0]
    for model, ckpt, extra in (("diffusion", "ckpt-cli", []),
                               ("gan", "ckpt-gan", ["--fid-samples", str(EVAL_SAMPLES)])):
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = _cli_json(cli, ["eval", "--device", "cuda", "--model", model,
                              "--checkpoint-dir", os.path.join(tmp, ckpt), *extra])[-1]
        secs = time.perf_counter() - t0
        got = tuple(k.launches for k in counters)
        if got != wants[model]:
            fail(f"eval {model}: launches B3/B4 {got}, expected {wants[model]}")
        keys = ("fid", "kid") if model == "diffusion" else (
            "transfer_fid_ab", "transfer_kid_ab", "transfer_fid_ba", "transfer_kid_ba")
        if not all(np.isfinite(out.get(k, np.nan)) for k in keys):
            fail(f"eval {model}: {out}")
        total = [t + g for t, g in zip(total, got)]
        results[model] = out
        print(f"[eval] cli eval --model {model} (step {out['step']}, fid_samples "
              f"{EVAL_SAMPLES}): {json.dumps({k: out[k] for k in keys})}; launches B3/B4 {got}; "
              f"wall {secs:.2f} s")

    x = np.random.default_rng(0).uniform(-1, 1, (16, 256, 256, 3)).astype(np.float32)
    cpu = fx.trained_features(torch.from_numpy(x)).numpy()
    card = fx.trained_features(torch.from_numpy(x).cuda()).cpu().numpy()
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"[eval] trained extractor features, 16 images 256² -> 256: card vs CPU max "
          f"{rel:.3e} relative to max|feature| (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"eval: the extractor's features on the card differ by {rel} relative")

    for dtype in ("float32", "bfloat16"):
        fdc.down_conv_fused.launches = 0
        res = benchmark.run_sampler_benchmark(
            cfg.replace(compute_dtype=dtype, conv_impl="pallas", sample_stride=50),
            batch=TRAIN_BATCH, iters=3, device="cuda")
        print(f"[eval] run_sampler_benchmark {dtype}, batch {TRAIN_BATCH}, stride 50: "
              f"{json.dumps(res)}")
    fdc.down_conv_fused.launches = 0  # the benchmark is not the main path's count
    print(f"[eval] the phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(total)


def main():
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    try:
        import gan_class_transfer2_tpu_torch as port
        from gan_class_transfer2_tpu_torch import cli
        from gan_class_transfer2_tpu_torch.models import api
        from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
        from gan_class_transfer2_tpu_torch.sample import sampler
        from gan_class_transfer2_tpu_torch.utils import png, weights
    except ImportError as e:
        fail(f"the port is not beside this script (run it from the repo root): {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail(f"imported the port from {port.__file__}, not from {HERE}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # float32 references are IEEE float32 (the JAX package's Precision.HIGHEST)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build()
    kernels = phase_kernels(torch, F, fdc)

    from gan_class_transfer2_tpu_torch.config import Config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        weights_npz = os.path.join(tmp, "weights.npz")
        full = api.init_denoiser(Config().validate(), device="cpu")  # random, seed 0
        weights.save_flat_npz(weights_npz, weights.export_flat_weights(full))
        print(f"[weights] default config, {sum(p.numel() for p in full.parameters())} "
              f"params, random from seed 0")
        del full
        sampled, cfg = phase_sample(fdc, cli, sampler, png, weights_npz, tmp)
        model = phase_timing(torch, fdc, sampler, weights, weights_npz, cfg)
    edit_launches = phase_edit(torch, fdc, sampler, model, cfg)
    del model
    phase_reference(torch, api, sampler)

    from gan_class_transfer2_tpu_torch.ops import adam_kernel
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.train import trainer

    # the train step holds IEEE float32 itself (models/unet.ieee_fp32, from
    # the loss forward through backward()): train under torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    train_rows, b4_err = phase_train_kernels(torch, F, fdc, fd, adam_kernel, api, cfg)
    train_launches, train_results = phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg)
    hbm_launches = phase_train_hbm(torch, fdc, fd, adam_kernel, trainer, cfg, train_results)
    for name, n in hbm_launches.items():
        train_launches[name] += n
    phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg)

    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.train import gan

    files = tempfile.TemporaryDirectory(prefix="chip_smoke_files_")
    paeth_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_paeth_")
    t0 = time.perf_counter()
    globs = write_class_pngs(files.name)
    paeth_glob = write_paeth_pngs(paeth_dir.name)
    print(f"[loader] wrote {PAETH_FILES[0]} Paeth/Average PNGs of {PAETH_FILES[1]}²")
    phase_loader(globs, paeth_glob, train_results[("float32", "kernels")]["images_per_sec"])
    print(f"[loader] the phase took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cli_launches = phase_train_cli(torch, cli, fdc, fd, adam_kernel, sampler, cfg, files.name)
    resume_launches = phase_train_resume(torch, cli, fdc, fd, adam_kernel, trainer, sampler,
                                         png, cfg, files.name)
    t1 = time.perf_counter()
    cache_launches = phase_cache(torch, cli, fdc, fd, adam_kernel, cfg, paeth_dir.name,
                                 paeth_glob)
    print(f"[cache] the phase took {time.perf_counter() - t1:.2f} s")
    paeth_dir.cleanup()
    for name in cli_launches:
        train_launches[name] += cli_launches[name] + resume_launches[name] + cache_launches[name]
    print(f"[train-resume] [train-cli], [train-resume] and [cache] took "
          f"{time.perf_counter() - t0:.2f} s")

    gan_rows, b4_gan_err = phase_gan_kernels(torch, F, fdc, norm, cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        gan_launches = phase_gan(torch, cli, fdc, norm, gan, cfg, tmp)
    phase_gan_agree(torch, fdc, norm, gan, cfg)
    phase_gan_reference(torch, fdc, norm, gan)
    t0 = time.perf_counter()
    cli_b3, cli_b4 = phase_gan_train_cli(torch, cli, fdc, norm, cfg, files.name, globs)
    print(f"[gan-train-cli] took {time.perf_counter() - t0:.2f} s")
    eval_b3, eval_b4 = phase_eval(torch, cli, fdc, norm, sampler, cfg, files.name)
    files.cleanup()
    gan_launches["float32"] = (gan_launches["float32"][0] + cli_b3 + eval_b3,
                               gan_launches["float32"][1] + cli_b4 + eval_b4)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    # one row per compiled kernel; the down conv's times and bound sum the
    # four shapes of one denoiser call at batch 4, its max_abs_err is the
    # worst forward error at batch 4 and 16 (with and without ReLU); the
    # instance norm's times and bound sum one GAN step's 102 launches at
    # batch 16; launches are the main-path runs' (sample, edit, train,
    # train-hbm, train-cli, train-resume, cache, gan, gan-train-cli and eval
    # for the down conv; gan, gan-train-cli and eval for the instance norm;
    # the train phases and cache for the others)
    source = "gan_class_transfer2_tpu_torch/csrc/down_conv.cu"
    replaces = "gan_class_transfer2_tpu/ops/pallas_conv.py:36"
    rows = []
    for dtype, launches in (
        ("float32", sampled["float32"]["launches"] + edit_launches
         + train_launches["down_conv_k4s2_f32"] + gan_launches["float32"][1]),
        ("bfloat16", sampled["bfloat16"]["launches"] + train_launches["down_conv_k4s2_bf16"]
         + gan_launches["bfloat16"][1]),
    ):
        s = kernels[dtype]
        rows.append({
            "name": f"down_conv_k4s2_{'f32' if dtype == 'float32' else 'bf16'}",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(s["max_abs_err"], b4_err[dtype], b4_gan_err[dtype]),
            "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["flops_ms"] >= s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"],
        })
    for name, row in train_rows.items():
        rows.append(dict(row, launches=train_launches[name]))
    for dtype, row in gan_rows.items():
        rows.append(dict(row, launches=gan_launches[dtype][0]))
    for row in rows:
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} was not launched on the main path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
