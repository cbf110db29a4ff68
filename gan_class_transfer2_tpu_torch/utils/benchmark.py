"""Throughput benchmarks — counterpart of
gan_class_transfer2_tpu/utils/benchmark.py (``steps_to_fixed_fid``,
``model_flops_per_image``, ``run_benchmark``, ``run_sampler_benchmark``):
the GAN steps to a transfer-quality target, and images per second of the
train step on a synthetic batch resident on the device, with the same JSON
keys as the JAX package's ``bench`` command, and of the reverse-diffusion
sampler. Warmup is excluded from the timing; each timed loop ends in
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

# Dense bf16 tensor-core peak for MFU (NVIDIA's data sheet, H100 SXM, 700 W),
# matched on the exact name that card reports. Other cards, the PCIe and NVL
# H100 parts included, and float32 runs (IEEE, no tensor cores) get mfu=None
# rather than a wrong denominator.
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"
H100_SXM_PEAK_BF16_TFLOPS = 989.0


@dataclasses.dataclass
class BenchResult:
    metric: str
    value: float
    unit: str
    vs_baseline: float
    extra: dict

    def to_json(self) -> str:
        return json.dumps({
            "metric": self.metric,
            "value": round(self.value, 3),
            "unit": self.unit,
            "vs_baseline": round(self.vs_baseline, 3),
            **self.extra,
        })


def steps_to_fixed_fid(runner, target_fid: float, max_steps: int = 20_000,
                       check_every: int = 500, direction: str = "ab", metric: str = "fid"):
    """BASELINE.json's second headline metric: train the class-transfer GAN
    until its transfer score reaches ``target_fid``; returns (steps, score),
    or (None, the last score) when ``max_steps`` runs out.

    ``runner``: a ``train.gan_loop.GANRunner``, trained ``check_every`` steps
    at a time (``fit(epochs=1, steps_per_epoch=check_every,
    log_samples=False)``) and scored by ``transfer_scores(direction)``.
    ``metric``: "fid" (the BASELINE-named metric) or "kid" (comparable
    across eval-set sizes, docs/FID.md)."""
    def _score():
        scores = runner.transfer_scores(direction)
        if scores is None:  # degenerate eval sets: fail loudly here
            raise ValueError(
                "steps_to_fixed_fid needs >= 2 held-out images per class "
                "(transfer_scores returned None); raise fid_samples or "
                "supply bigger class globs"
            )
        return scores[metric]

    steps_done = int(runner.state.step)
    score = _score()
    while score > target_fid and steps_done < max_steps:
        runner.fit(epochs=1, steps_per_epoch=check_every, log_samples=False)
        steps_done = int(runner.state.step)
        score = _score()
        print(f"steps_to_fixed_{metric}: step {steps_done} {metric} {score:.4f}", flush=True)
    return (steps_done if score <= target_fid else None), score


def _peak_tflops(compute_dtype: str, device: torch.device):
    if compute_dtype != "bfloat16" or device.type != "cuda":
        return None
    if torch.cuda.get_device_name(device) != H100_SXM_NAME:
        return None
    return H100_SXM_PEAK_BF16_TFLOPS


def model_flops_per_image(cfg, in_channels: int = 3) -> int:
    """Analytic FORWARD FLOPs per image of the Denoiser U-Net: 2 per MAC; a
    k×k conv at output spatial S² costs S²·k²·cin·cout MACs, a stride-2
    transposed conv in-spatial²·k²·cin·cout. The elementwise diffusion
    algebra is excluded. A training step counts 3× forward."""

    def block(spatial, cin, filters, depth):
        m, c = 0, cin
        for _ in range(depth):
            m += spatial * spatial * 9 * c * filters
            c = filters
        return m, c

    macs, c = 0, in_channels
    m, c = block(cfg.size, c, cfg.pixel_size, cfg.block_depth)
    macs += m
    skip = []
    for i in range(cfg.octaves):
        f = cfg.octave_filters(i)
        skip.append(c)
        s_half = cfg.size >> (i + 1)
        macs += s_half * s_half * 16 * c * f  # down 4×4/s2
        m, c = block(s_half, f, f, cfg.block_depth)
        macs += m
    m, c = block(cfg.size >> cfg.octaves, c, cfg.middle_filters(), cfg.block_depth)
    macs += m
    for i in reversed(range(cfg.octaves)):
        f = cfg.octave_filters(i)
        u = cfg.octave_up_filters(i)
        s_half = cfg.size >> (i + 1)
        m, c = block(s_half, c, f, cfg.block_depth)
        macs += m
        macs += s_half * s_half * 16 * c * u  # up convT 4×4/s2
        c = u
        if cfg.skip_mode == "concat":
            c += skip[i]
        elif cfg.skip_mode == "residual":
            macs += (cfg.size >> i) ** 2 * c * skip[i]  # skip dense
            c = skip[i]
    m, c = block(cfg.size, c, cfg.pixel_size, cfg.block_depth)
    macs += m
    macs += cfg.size * cfg.size * c * cfg.out_channels()  # head dense
    return 2 * macs


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(cfg, steps: int = 30, warmup: int = 3, baseline_ips: float | None = None,
                  device="cuda") -> BenchResult:
    """Time ``steps`` train steps (after ``warmup`` untimed ones) of the
    default train step on a synthetic batch resident on ``device``."""
    from ..models.api import resolve_device
    from ..train import trainer

    device = resolve_device(device)
    state = trainer.init_state(cfg, device=device)
    step_fn = trainer.make_train_step(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    r = np.random.default_rng(0)
    batch = torch.from_numpy(
        r.uniform(-1, 1, (cfg.batch_size, cfg.size, cfg.size, 3)).astype(np.float32)
    ).to(device)

    for _ in range(warmup):
        state, loss = step_fn(state, batch, generator)
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step_fn(state, batch, generator)
    _synchronize(device)
    dt = time.perf_counter() - t0

    ips = steps * cfg.batch_size / dt
    train_flops_per_image = 3 * model_flops_per_image(cfg)
    tflops = train_flops_per_image * ips / 1e12
    peak = _peak_tflops(cfg.compute_dtype, device)
    return BenchResult(
        metric="train_images_per_sec_per_chip",
        value=ips,
        unit="images/sec/chip",
        vs_baseline=(ips / baseline_ips) if baseline_ips else 0.0,
        extra={
            "images_per_sec": round(ips, 3),
            "step_ms": round(dt / steps * 1000, 3),
            "batch_size": cfg.batch_size,
            "size": cfg.size,
            "compute_dtype": cfg.compute_dtype,
            "conv_impl": cfg.conv_impl,
            "n_chips": 1,
            "backend": device.type,
            "model_tflops_per_chip": round(tflops, 3),
            "train_flops_per_image": train_flops_per_image,
            "mfu": round(tflops / peak, 4) if peak else None,
            "mfu_peak_tflops": peak,
            "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu",
            "final_loss": float(loss),
        },
    )


def run_sampler_benchmark(cfg, batch: int = 8, iters: int = 3, mesh=None,
                          device="cuda") -> dict:
    """Throughput of the reverse-diffusion sampler (``sample/sampler.py``,
    ``len(sample_timesteps(cfg))`` denoiser calls a batch) at ``batch``
    images from random weights, after one untimed call; the JAX function's
    keys. ``sampler_mfu`` is None off an H100 SXM and in float32, as in
    ``run_benchmark``. On a mesh (``parallel/mesh.py``) the batch is split
    over the ranks as ``shard_sample_batch`` splits it (every rank calls
    this; the rate is the whole batch's, the TFLOP/s each rank's share)."""
    from ..models import api
    from ..parallel import mesh as mesh_lib
    from ..parallel import multihost
    from ..sample import sampler

    device = mesh.device if mesh is not None else api.resolve_device(device)
    model = api.init_denoiser(cfg, device=device)
    r = np.random.default_rng(0)
    init = torch.from_numpy(
        r.normal(size=(batch, cfg.size, cfg.size, 3)).astype(np.float32)).to(device)
    init, _ = mesh_lib.shard_sample_batch(init, mesh)
    imgs = sampler.sample(cfg, model, init, snapshots=False).images
    float(imgs.sum())  # warm up and synchronise
    _synchronize(device)
    multihost.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        imgs = sampler.sample(cfg, model, init, snapshots=False).images
    _synchronize(device)
    multihost.barrier()  # the whole batch is done when the last rank is
    dt = time.perf_counter() - t0
    # forward-only: each visited timestep is one denoiser forward
    n_calls = len(sampler.sample_timesteps(cfg))
    ips = batch * iters / dt
    ranks = mesh.size if mesh is not None else 1
    tflops = ips / ranks * n_calls * model_flops_per_image(cfg) / 1e12
    peak = _peak_tflops(cfg.compute_dtype, device)
    return {
        "sampler_images_per_sec": round(ips, 3),
        "sampler_batch": batch,
        "sampler_steps": cfg.steps,
        "sampler_denoiser_calls": n_calls,
        "sampler_mesh": ranks,
        "sampler_tflops_per_chip": round(tflops, 3),
        "sampler_mfu": round(tflops / peak, 4) if peak else None,
    }
