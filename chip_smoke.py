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
     path is the one the tests hold against the JAX package) must agree.

The last two lines of its output are a JSON line of per-kernel results and
``{"ok": true, "device": {...}}``; before them the card's name and power
limit. Without a card, or without the port beside it, it exits non-zero and
prints no result.
"""

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
# pallas vs lax images, in uint8 levels (1 level = 2/255 of the [-1, 1)
# range): float32 paths agree to ~1e-5, so only a rounding flip at a level
# boundary; bfloat16 paths round differently inside 4 of the 6 down convs
# (~4e-3 relative each), and 4 denoiser calls carry that to the image
IMAGE_LEVELS = {"float32": 1, "bfloat16": 6}


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
    phase_reference(torch, api, sampler)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    # one row per compiled kernel; its times and bound sum the four shapes of
    # one denoiser call at batch 4, its launches are the main-path runs'
    source = "gan_class_transfer2_tpu_torch/csrc/down_conv.cu"
    replaces = "gan_class_transfer2_tpu/ops/pallas_conv.py:36"
    rows = []
    for dtype, launches in (("float32", sampled["float32"]["launches"] + edit_launches),
                            ("bfloat16", sampled["bfloat16"]["launches"])):
        s = kernels[dtype]
        rows.append({
            "name": f"down_conv_k4s2_{'f32' if dtype == 'float32' else 'bf16'}",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["flops_ms"] >= s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
