#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gan_class_transfer2_tpu_torch) on one
NVIDIA card. Run it from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. build  — compile every csrc/*.cu of the port with nvcc for sm_90a;
  2. kernels — hold each kernel against its plain PyTorch version on the card
     at the shapes the serving path gives it (the four full-width k4/s2 down
     convs at batch 4, float32 and bfloat16), and time kernel, plain version
     and one library call (cuDNN) on the same inputs beside the bound;
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
  6. train kernels — B1 (fused forward diffusion, batch 16 × 256²×3) and B2
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
  8. train-agree — one injected full-width step from the same weights, t and
     ε through the kernel path and the plain path: losses and updates agree.

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
# B1 kernel vs plain: the same Philox words; ε differs by the rounding of
# log and cos (|ε| < 6, a few float32 ulps)
DIFFUSE_ATOL = 4e-6
# flops per element of B1 outside Philox's integer work: Box–Muller's two
# int→float conversions, 4 mul/add, log, sqrt, cos (~10 each as polynomials)
# and the 3 of x·ss + ε·sn; an estimate for the operations bound
DIFFUSE_FLOPS_PER_ELEMENT = 40
ADAM_FLOPS_PER_ELEMENT = 12  # 2 mul + add (m), 3 mul + add (v), sqrt, add, mul, div, sub


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
    """Kernel vs plain version at the four full-width shapes; returns one
    summary per dtype (sums over the shapes of one denoiser call)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops_ms=0.0,
                 bytes_ms=0.0, max_abs_err=0.0)
        for (hw, c, o) in SHAPES:
            x = torch.randn((BATCH, hw, hw, c), generator=gen, device="cuda").to(dtype)
            k = torch.randn((4, 4, c, o), generator=gen, device="cuda") / (16 * c) ** 0.5
            b = torch.randn((o,), generator=gen, device="cuda") * 0.1
            with torch.inference_mode():
                before = fdc.down_conv_fused.launches
                y = fdc.down_conv_fused(x, k, b)
                ref = fdc.down_conv_plain(x, k, b)
                torch.cuda.synchronize()
                fdc.down_conv_fused.launches = before  # comparison launches do not count
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                if not err <= KERNEL_RTOL[dtype_name] * scale:
                    fail(f"kernel {dtype_name} {x.shape}->{o}: max|err| {err} > "
                         f"{KERNEL_RTOL[dtype_name]} x max|y| {scale}")
                # one library call computing the same function: cuDNN on the
                # same NHWC memory (a channels_last NCHW view), bias folded in
                x_lib = x.permute(0, 3, 1, 2)
                w_lib = k.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                b_lib = b.to(dtype)
                ms = cuda_ms(lambda: fdc.down_conv_fused(x, k, b))
                plain_ms = cuda_ms(lambda: fdc.down_conv_plain(x, k, b))
                lib_ms = cuda_ms(lambda: torch.relu_(
                    F.conv2d(x_lib, w_lib, b_lib, stride=2, padding=1)))
                fdc.down_conv_fused.launches = before
            h2 = hw // 2
            flops = 2 * BATCH * h2 * h2 * o * 16 * c
            nbytes = x.element_size() * (x.numel() + k.numel() + b.numel() + y.numel())
            flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound = max(flops_ms, bytes_ms)
            print(f"[kernel] {dtype_name} x{tuple(x.shape)} -> {o}: max|err| {err:.3e} "
                  f"(max|y| {scale:.3f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"cuDNN {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if flops_ms >= bytes_ms else 'bytes'}); "
                  f"{flops / ms / 1e9:.1f} TFLOP/s = {bound / ms:.1%} of bound")
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["library_ms"] += lib_ms
            s["bound_ms"] += bound
            s["flops_ms"] += flops_ms
            s["bytes_ms"] += bytes_ms
            s["max_abs_err"] = max(s["max_abs_err"], err)
        summary[dtype_name] = s
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

    for dtype in ("float32", "bfloat16"):
        for impl in ("pallas", "lax"):
            c = cfg.replace(conv_impl=impl, compute_dtype=dtype)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sampler.sample(c, model, init, snapshots=False)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
            kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            print(f"[profile] {dtype}/{impl}: one sample call (batch {BATCH}, "
                  f"{len(sampler.sample_timesteps(c))} denoiser calls): kernels busy "
                  f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler")
            for e in kernels[:6]:
                print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                      f"x{e.count:<4d} {e.key[:100]}")


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
    from gan_class_transfer2_tpu_torch.models import unet

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    # ---- B1: batch 16 × 256²×3 float32
    n = cfg.size * cfg.size * 3
    x = torch.rand((TRAIN_BATCH, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (TRAIN_BATCH,), generator=gen, device="cuda")
    from gan_class_transfer2_tpu_torch.core.schedule import alpha_dash

    ad = alpha_dash(t.float(), cfg.steps, cfg.schedule)
    ss, sn = ad.sqrt(), (1 - ad).sqrt()
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    before = fd.diffuse_fused.launches
    y = fd.diffuse_fused(x, ss, sn, seed)
    ref = fd.diffuse_plain(x, ss, sn, seed)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    if not err <= DIFFUSE_ATOL:
        fail(f"diffuse kernel vs plain: max|err| {err} > {DIFFUSE_ATOL}")
    if not torch.equal(fd.diffuse_fused(x, ss, torch.zeros_like(sn), seed), x * ss[:, None]):
        fail("diffuse kernel with sn = 0 is not x·ss")
    eps = fd.diffuse_fused(torch.zeros_like(x), torch.zeros_like(ss), torch.ones_like(sn), seed)
    mean, std = eps.double().mean().item(), eps.double().std().item()
    if not (abs(mean) < 5 / eps.numel() ** 0.5 and abs(std - 1) < 5 / (2 * eps.numel()) ** 0.5):
        fail(f"diffuse kernel noise has mean {mean}, std {std}")
    ms = cuda_ms(lambda: fd.diffuse_fused(x, ss, sn, seed), reps=50)
    plain_ms = cuda_ms(lambda: fd.diffuse_plain(x, ss, sn, seed), reps=5)
    fd.diffuse_fused.launches = before
    rows["diffuse_f32"] = _row(
        "diffuse_f32", "gan_class_transfer2_tpu_torch/csrc/diffuse.cu",
        "gan_class_transfer2_tpu/ops/kernels.py:44", 0, err, ms, plain_ms,
        DIFFUSE_FLOPS_PER_ELEMENT * x.numel(), 2 * 4 * x.numel(), None)
    print(f"[train-kernel] B1 diffuse x{tuple(x.shape)}: max|err| {err:.3e} (bound "
          f"{DIFFUSE_ATOL}); noise mean {mean:.2e} std {std:.5f}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {rows['diffuse_f32']['bound_ms']:.4f} ms "
          f"({rows['diffuse_f32']['bound_by']}); no one-call library yardstick")
    del x, y, ref, eps

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
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        worst = {"y": 0.0, "dx": 0.0, "dK": 0.0, "db": 0.0}
        flips = 0
        b4_err[dtype_name] = 0.0
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
                y = fdc.down_conv_fused(xs, k, b)
                yp = fdc.down_conv_plain(xs, k, b)
                err = (y.float() - yp.float()).abs().max().item()
                scale = yp.float().abs().max().item()
                if not err <= KERNEL_RTOL[dtype_name] * scale:
                    fail(f"B4 forward {dtype_name} x{tuple(xs.shape)}->{o}: max|err| {err} > "
                         f"{KERNEL_RTOL[dtype_name]} x max|y| {scale}")
                b4_err[dtype_name] = max(b4_err[dtype_name], err)
                worst["y"] = max(worst["y"], err / scale)
                # an output whose pre-activation lies within rounding of 0
                # may pass one ReLU and not the other; g is 0 there for both
                same = (y > 0) == (yp > 0)
                flips += int((~same).sum().item())
                gm = torch.where(same, g, torch.zeros_like(g))
                got = torch.autograd.grad(y, (xs, k, b), gm, retain_graph=True)
                want = torch.autograd.grad(yp, (xs, k, b), gm, retain_graph=True)
                for gname, a, w in zip(("dx", "dK", "db"), got, want):
                    gerr = (a.float() - w.float()).abs().max().item()
                    gscale = w.float().abs().max().item()
                    if not gerr <= GRAD_RTOL[dtype_name] * gscale:
                        fail(f"B4 {gname} {dtype_name} x{tuple(xs.shape)}->{o}: max|err| {gerr} "
                             f"> {GRAD_RTOL[dtype_name]} x max|{gname}| {gscale}")
                    worst[gname] = max(worst[gname], gerr / gscale)
                ms = cuda_ms(lambda: torch.autograd.grad(y, (xs, k, b), g, retain_graph=True))
                plain_ms = cuda_ms(lambda: torch.autograd.grad(yp, (xs, k, b), g,
                                                               retain_graph=True))
                fdc.down_conv_fused.launches = before
                flops = 2 * 2 * TRAIN_BATCH * (hw // 2) ** 2 * o * 16 * c  # dx and dK
                nbytes = xs.element_size() * (2 * xs.numel() + 2 * k.numel() + y.numel())
                bound = max(flops / PEAK_FLOPS[dtype_name] * 1e3, _bytes_ms(nbytes))
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += bound
                del xs, k, b, g, gm, y, yp, got, want
        print(f"[train-kernel] B4 {dtype_name}, batch {TRAIN_BATCH}, four shapes: max error "
              f"relative to the largest value: y {worst['y']:.2e} (bound "
              f"{KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK {worst['dK']:.2e}, db "
              f"{worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]}); {flips} ReLU mask flip(s); "
              f"backward: cuDNN dx+dK+db {tot['ms']:.4f} ms, plain autograd "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (operations)")
    return rows, b4_err


def _bench(cli, args):
    """One ``cli bench`` run; returns its JSON result (the line is printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue().strip().splitlines()
    if rc != 0 or not out:
        fail(f"cli {' '.join(args)} returned {rc}")
    print(f"[train] {out[-1]}")
    return json.loads(out[-1])


def phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg):
    """The training slice through ``cli bench`` at the default width, per
    dtype × path; exact launch counts; a profile of one step of each.
    Returns the kernel path's launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from gan_class_transfer2_tpu_torch.models import unet

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
            res = _bench(cli, args)
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
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[train-profile] {dtype}/{path}: one step at batch {TRAIN_BATCH}: kernels busy "
              f"{busy:.3f} ms of {res['step_ms']:.3f} ms per step (bench, no profiler): idle "
              f"share {max(0.0, 1 - busy / res['step_ms']):.1%}; {len(kernels)} kernel names")
        for e in kernels[:8]:
            print(f"[train-profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:100]}")
        del state, step, xb
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0
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
    train_launches = phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg)
    phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    # one row per compiled kernel; the down conv's times and bound sum the
    # four shapes of one denoiser call at batch 4, its max_abs_err is the
    # worst forward error at batch 4 and 16; launches are the main-path runs'
    # (sample, edit and train for the down conv; train for the others)
    source = "gan_class_transfer2_tpu_torch/csrc/down_conv.cu"
    replaces = "gan_class_transfer2_tpu/ops/pallas_conv.py:36"
    rows = []
    for dtype, launches in (
        ("float32", sampled["float32"]["launches"] + edit_launches
         + train_launches["down_conv_k4s2_f32"]),
        ("bfloat16", sampled["bfloat16"]["launches"] + train_launches["down_conv_k4s2_bf16"]),
    ):
        s = kernels[dtype]
        rows.append({
            "name": f"down_conv_k4s2_{'f32' if dtype == 'float32' else 'bf16'}",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(s["max_abs_err"], b4_err[dtype]),
            "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["flops_ms"] >= s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"],
        })
    for name, row in train_rows.items():
        rows.append(dict(row, launches=train_launches[name]))
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
