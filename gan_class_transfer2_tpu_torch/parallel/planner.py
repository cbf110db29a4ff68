"""Parallelism planner: pick a mesh for a workload (``cli plan``) —
counterpart of gan_class_transfer2_tpu/parallel/planner.py.

Given a workload Config and a card budget, it enumerates the parallelism
strategies the port implements (DP, DP + ZeRO-1, TP, pipeline over octave
bands, spatial sharding), models per-card memory and expected throughput
for each, and recommends concrete Config overrides. Everything is analytic:
the port's modules built on ``device="meta"`` give the exact parameter and
state shapes with no FLOPs and no allocation, and the activation and MAC
models are closed-form, so planning needs no card.

The JAX package calibrates these models on TPU v5e measurements. None of
them is carried over: the constants below were measured on one NVIDIA H100
by ``tools/bench_grid_torch.py`` (the log is named beside each):

* throughput: the (size × batch) ladder of img/s of the port's train step
  through the kernels at 64²–1024², in float32 and in bfloat16 (so float32
  needs no factor), interpolated in log2(size) × log2(batch);
* the activation constant: ``torch.cuda.max_memory_allocated`` less the
  model state, over the analytic saved elements, fitted at one point and
  checked at a second, per dtype;
* the cycle-GAN step's cost in units of the diffusion step, from three
  anchors at 256², batch 16 a class;
* remat: its measured peak and step time (reported, not chosen).

The TPU's padding of a per-chip batch to a multiple of 8 has no
counterpart on the card (the held-out points off multiples of 8 follow the
ladder), so it is not modelled. Predictions are first-order: DP scales
the one-card ladder by the card count (its all-reduce is outside the
model). Strategies with no cost model that holds on the card report
``pred_img_s=None`` with a note instead of an invented number, as JAX's
planner does for TP's activation collectives and spatial halos; here the
pipeline too, whose measured steps over cards contradict the bubble model
JAX prices it with (``PP_NOTE``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# --------------------------------------------------------------- constants

HBM_GB_H100 = 80.0
BUDGET_FRAC = 0.75  # headroom for the caching allocator's fragmentation and cuDNN workspaces

CALIBRATION = ("tools/bench_grid_torch.py on one NVIDIA H100 80GB HBM3, 700.00 W, torch "
               "2.11.0+cu128; its log bench_grid.jsonl")

# Single-card training throughput (img/s) of the port's step through the
# kernels (B4 and the conv epilogue, optimizer="adam_fused", fused diffusion), the
# default widths (octaves 4 at 64², 6 elsewhere): per dtype, per size, the
# batch ladder. Measured by tools/bench_grid_torch.py (see CALIBRATION).
MEASURED_GRID: dict = {
    "float32": {
        64: ((32, 2831.441), (64, 3273.03), (128, 3397.741), (256, 3569.625), (512, 3642.827)),
        128: ((32, 751.685), (64, 811.218), (128, 832.682), (256, 852.049)),
        256: ((16, 206.792), (32, 212.339), (64, 217.122), (128, 218.993), (256, 219.469)),
        512: ((8, 53.477), (16, 54.367), (32, 54.803), (64, 54.989)),
        1024: ((8, 13.656), (16, 13.703)),
    },
    "bfloat16": {
        64: ((32, 6875.236), (64, 11699.795), (128, 25200.894), (256, 32322.818), (512, 37118.06)),
        128: ((32, 3943.44), (64, 6699.451), (128, 8066.357), (256, 9063.396)),
        256: ((16, 1682.806), (32, 2015.257), (64, 2256.687), (128, 2384.639), (256, 2449.254)),
        512: ((8, 505.225), (16, 560.02), (32, 595.78), (64, 608.847)),
        1024: ((8, 148.218), (16, 151.52)),
    },
}

# Activation memory (peak − model state) over the analytic saved elements ×
# dtype bytes × batch, per dtype (see CALIBRATION).
ACT_CALIB: dict = {"float32": 2.0447, "bfloat16": 2.0716}
# fitted at (512, 64); checked at (256, 16): predicted 2.272 GB against
# 2.158 measured in float32, 1.48 against 1.531 in bfloat16

# Cycle-GAN step time in units of the diffusion step at the same (size,
# per-class batch), per dtype: base (adversarial only) + cycle + identity,
# from the three anchors (see CALIBRATION).
GAN_STEP_COST: dict = {
    "float32": {"base": 3.447, "cycle": 1.99, "identity": 1.985},
    "bfloat16": {"base": 4.484, "cycle": 2.096, "identity": 1.77},
}
# anchors (ms): the diffusion step float32 77.363, bfloat16 9.594; the GAN
# steps read off as base + cycle + identity (full), base + cycle (identity off), base

# B2 over the default model's leaves: 0.2817 ms with bfloat16 moments against 0.3956
# with float32 (PERF.md §6; chip_smoke.py [train-kernel], H100 80GB HBM3, 700.00 W)
BF16_MOMENTS_NOTE = "bf16 moments (free — measured: B2 is faster on them)"

# The port's pipeline over cards, one process (tools/parallel_cards_torch.py
# --part pipeline; four H100 80GB HBM3 at 700.00 W of one host; 256², batch 16,
# float32): 2 stages x 2 microbatches 83.59 ms a step, x 4 91.35; 4 stages x 4
# 94.75, x 8 114.15; 2 stages x 2 replicas 85.55 — all slower than one card's
# 78.57. The bubble model's overlap (pp_times) is not what the cards do, so a
# pipeline candidate gets no throughput prediction.
PP_NOTE = ("no throughput prediction: the port's pipeline measured slower than one card "
           "over 2 and 4 H100s at 256² b16 (83.6–114.2 against 78.6 ms a step)")

REMAT_NOTE = (
    "remat is not offered as a memory lever: measured at 512² b16 float32 on the H100 it "
    "lowered the peak 12.9% (6.928 → 6.037 GB) for "
    "44% more step time (294.339 → 423.757 ms)"
)


def _grid_dtype(cfg) -> Optional[str]:
    """The measured ladder for ``cfg``'s compute dtype (float16 has none)."""
    return cfg.compute_dtype if cfg.compute_dtype in MEASURED_GRID else None


def gan_step_cost_ratio(cfg) -> float:
    """Cycle-GAN step time ÷ diffusion step time at equal (size, batch)."""
    cost = GAN_STEP_COST[_grid_dtype(cfg) or "bfloat16"]
    return (cost["base"] + (cost["cycle"] if cfg.cycle_term_active else 0.0)
            + (cost["identity"] if cfg.identity_term_active else 0.0))


# ---------------------------------------------------------- memory models


def abstract_params(cfg):
    """The denoiser ``cfg`` describes, built on ``device="meta"``: exact
    parameter shapes, no FLOPs, no allocation."""
    from ..models import api

    with torch.device("meta"):
        return api.build_denoiser(cfg)


def _leaves(tree) -> list:
    """The tensors of a module, a state NamedTuple or a list."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _leaf_bytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def param_bytes(tree) -> int:
    """Bytes of a tree's tensors (a module's parameters, a state's leaves);
    an int leaf of a state (its step count, an int32 scalar in JAX's
    state) counts 4."""
    if isinstance(tree, bool):
        return 0
    if isinstance(tree, int):
        return 4
    if isinstance(tree, (tuple, list)):
        return sum(param_bytes(v) for v in tree)
    return sum(_leaf_bytes(t) for t in _leaves(tree))


@dataclasses.dataclass
class _AbstractMesh:
    """Stands in for a mesh so the port's runtime rules (``mesh._leaf_spec``,
    ``_zero1_spec``) run without devices: the planner models the rules its
    runtime applies."""

    shape: dict


def _spec_divisor(spec, axis_sizes: dict) -> int:
    """How many ways a partition spec splits a leaf."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            div *= axis_sizes.get(ax, 1)
    return div


def tp_param_bytes_per_chip(tree, model: int) -> int:
    """Per-card parameter bytes under the port's TP rule (``mesh._leaf_spec``)."""
    from . import mesh as mesh_lib

    sizes = {"model": model}
    return sum(_leaf_bytes(t) // _spec_divisor(mesh_lib._leaf_spec(t, model), sizes)
               for t in _leaves(tree))


def zero1_moment_bytes_per_chip(tree, data: int, model: int, moment_dtype: str) -> int:
    """Per-card Adam moment bytes (2 moments) under the port's
    ``mesh._zero1_spec`` (model-major where a kernel is split over both:
    the same bytes a card as JAX's data-major stacking; a split kernel whose
    last axis does not divide by both stays on ``model``, where JAX moves
    it to ``data``)."""
    from . import mesh as mesh_lib

    fake = _AbstractMesh(shape={"data": data, "model": model})
    sizes = {"data": data, "model": model}
    itemsize = 2 if moment_dtype == "bfloat16" else 4
    return 2 * sum(t.numel() * itemsize // _spec_divisor(mesh_lib._zero1_spec(t, fake), sizes)
                   for t in _leaves(tree))


def model_state_bytes_per_chip(p_bytes_chip: int, n_param_elems_chip: float, *,
                               zero1_data: int = 1, moment_dtype: str = "float32",
                               moment_bytes_chip: Optional[int] = None,
                               ema: bool = False) -> float:
    """Steady per-card model state: fp32 params + fp32 grads (live at the
    update) + 2 Adam moments (optionally ZeRO-1-sharded / bf16)."""
    if moment_bytes_chip is None:
        mb = 2 if moment_dtype == "bfloat16" else 4
        moment_bytes_chip = 2 * n_param_elems_chip * mb / zero1_data
    state = p_bytes_chip + p_bytes_chip + moment_bytes_chip
    if ema:
        state += p_bytes_chip
    return float(state)


def act_elems_per_image(cfg) -> int:
    """Saved-activation elements per image: every down/up conv output plus
    the input and head output. Multiplied by ACT_CALIB to cover autograd's
    saved tensors, cotangents and workspaces."""
    total = 2 * cfg.size**2 * 3
    for i in range(cfg.octaves):
        sp_down = (cfg.size >> (i + 1)) ** 2
        total += sp_down * cfg.octave_filters(i)
        total += (cfg.size >> i) ** 2 * cfg.octave_up_filters(i)
        if cfg.block_depth:
            total += 2 * cfg.block_depth * sp_down * cfg.octave_filters(i)
    return total


def _act_calib(cfg) -> float:
    """The measured constant of ``cfg``'s dtype; float16 takes bfloat16's
    (the same bytes an element)."""
    return ACT_CALIB[_grid_dtype(cfg) or "bfloat16"]


def act_bytes(cfg, local_batch: float, spatial_ways: int = 1) -> float:
    dtype_bytes = 2 if cfg.compute_dtype in ("bfloat16", "float16") else 4
    return _act_calib(cfg) * act_elems_per_image(cfg) * dtype_bytes * local_batch / spatial_ways


# ------------------------------------------------- pipeline (PP) models


def channels(cfg, i):
    """(f_i, u_i) — down/up conv out-channels at octave i."""
    return cfg.octave_filters(i), cfg.octave_up_filters(i)


def conv_macs(cfg):
    """Per-image MACs of every conv, attributed to octaves (down, up, head)."""
    down, up = [], []
    for i in range(cfg.octaves):
        f_in = 3 if i == 0 else channels(cfg, i - 1)[0]
        f_i, u_i = channels(cfg, i)
        sp_down = (cfg.size // 2 ** (i + 1)) ** 2
        d = sp_down * 16 * f_in * f_i
        if i == cfg.octaves - 1:
            up_in = f_i
        else:
            up_in = channels(cfg, i + 1)[1] + f_i
        sp_up = (cfg.size // 2**i) ** 2
        u = sp_up * 4 * up_in * u_i
        if cfg.block_depth > 0:
            blk = cfg.block_depth * sp_down * 9 * f_i * f_i
            d += blk
            u += blk
        down.append(d)
        up.append(u)
    head = cfg.size**2 * (channels(cfg, 0)[1] + 3) * 3
    return down, up, head


def stage_work(cfg, plan):
    """Per-device (w_down, w_up) MACs per image under a stage plan."""
    down, up, head = conv_macs(cfg)
    out = []
    for s, (a, b) in enumerate(plan):
        w_d = sum(down[a:b])
        w_u = sum(up[a:b])
        if s == 0:
            w_u += head
        if s == len(plan) - 1:
            mid = (cfg.block_depth * (cfg.size // 2**cfg.octaves) ** 2 * 9
                   * channels(cfg, cfg.octaves - 1)[0] ** 2)
            out.append((w_d + w_u + mid, 0.0))
        else:
            out.append((w_d, w_u))
    return out


def boundary_bytes(cfg, plan, micro_batch, dtype_bytes=2):
    """Bytes PP ships across each stage boundary per microbatch (forward
    activations + backward cotangents)."""
    per_boundary = []
    for s in range(len(plan) - 1):
        k = plan[s][1]
        sp = (cfg.size // 2**k) ** 2
        f_prev = channels(cfg, k - 1)[0]
        u_k = channels(cfg, k)[1]
        fwd = micro_batch * sp * (f_prev + u_k) * dtype_bytes
        per_boundary.append(2 * fwd)
    return per_boundary


def pp_times(work, n_micro):
    """(t_pp, t_ideal, bubble) in MAC units from per-device (w_d, w_u)."""
    w_dev = [d + u for d, u in work]
    taus = [d for d, _ in work[:-1]] + [work[-1][0]] + [u for _, u in reversed(work[:-1])]
    t_pp = (n_micro - 1) * max(w_dev) + sum(taus)
    t_ideal = n_micro * sum(w_dev) / len(work)
    return t_pp, t_ideal, 1 - t_ideal / t_pp


def pp_stage_act_elems(cfg, plan, s) -> int:
    """Saved-activation elements per image for stage s's octave band."""
    a, b = plan[s]
    total = 0
    for i in range(a, b):
        total += (cfg.size >> (i + 1)) ** 2 * cfg.octave_filters(i)
        total += (cfg.size >> i) ** 2 * cfg.octave_up_filters(i)
        if cfg.block_depth:
            total += 2 * cfg.block_depth * (cfg.size >> (i + 1)) ** 2 * cfg.octave_filters(i)
    if s == 0:
        total += 2 * cfg.size**2 * 3
    return total


def _stage_param_bytes(tree, plan) -> list:
    """Parameter bytes of each stage's view (``pipeline.stage_indices``)."""
    from . import pipeline as pp

    params = list(tree.parameters())
    return [sum(_leaf_bytes(params[i]) for i in ix) for ix in pp.stage_indices(tree, plan)]


# ---------------------------------------------------- throughput model


def _flops_per_image_train(cfg) -> float:
    from ..utils import benchmark as bench_lib

    return 3.0 * bench_lib.model_flops_per_image(cfg)


def _grid_cfg(size: int, dtype: str):
    """The Config the grid was measured at (default widths)."""
    from ..config import Config

    return Config(size=size, octaves=4 if size == 64 else 6, compute_dtype=dtype,
                  checkpoint_dir=None)


def _ladder_ips(grid: dict, size: int, batch: float) -> float:
    """A measured size's batch ladder interpolated in log2(batch), clamped
    at its ends."""
    ladder = grid[size]
    xs = [math.log2(b) for b, _ in ladder]
    ys = [v for _, v in ladder]
    return float(np.interp(math.log2(max(batch, 1.0)), xs, ys))


def predict_ips_per_chip(cfg, local_batch: float) -> Optional[float]:
    """First-order per-card img/s at this size and local batch, or None for
    a compute dtype without a measured ladder.

    For each measured size, its ladder at the work-equivalent batch
    (conserving b·size²) gives achieved model TFLOP/s through that size's
    FLOP count; those are interpolated in log2(size) and converted back
    through ``cfg``'s FLOP count. At a grid point this is the measurement
    itself. The ladder of ``cfg``'s dtype is used (float32 is measured, not
    scaled from bfloat16), and no batch is padded."""
    from ..utils import benchmark as bench_lib

    dtype = _grid_dtype(cfg)
    if dtype is None:
        return None
    grid = MEASURED_GRID[dtype]
    pts = []
    for s in sorted(grid):
        b_eq = local_batch * (cfg.size / s) ** 2
        fl = 3.0 * bench_lib.model_flops_per_image(_grid_cfg(s, dtype))
        pts.append((math.log2(s), _ladder_ips(grid, s, b_eq) * fl / 1e12))
    tflops = float(np.interp(math.log2(cfg.size), [p[0] for p in pts], [p[1] for p in pts]))
    return tflops * 1e12 / _flops_per_image_train(cfg)


def _knee_batch(cfg) -> int:
    """Smallest power-of-two per-card batch whose predicted throughput is
    ≥95% of the flat ceiling."""
    ceiling = 0.95 * predict_ips_per_chip(cfg, 1 << 20)
    b = 1
    while b < (1 << 20) and predict_ips_per_chip(cfg, b) < ceiling:
        b *= 2
    return b


# ----------------------------------------------------- GAN-mode workloads


def _gan_generator_passes(cfg, model: str) -> int:
    """Gradient-traversed generator (U-Net) applications per G step
    (zero-weight terms are elided, train/gan.py)."""
    extra = (1 if cfg.cycle_term_active else 0) + (1 if cfg.identity_term_active else 0)
    per_direction = 1 + extra
    return 2 * per_direction if model == "gan" else per_direction


def _abstract_gan_state(cfg, model: str):
    """The GANState / ConditionalGANState ``cfg`` describes, built on
    ``device="meta"`` (no draws, no allocation)."""
    from ..models import conditional as cond_lib
    from ..models import discriminator as d_lib
    from ..train import gan as gan_lib
    from ..train.trainer import make_optimizer

    ema = cfg.ema_decay > 0
    with torch.device("meta"):
        if model == "gan":
            g_ab, g_ba = gan_lib.build_generator(cfg), gan_lib.build_generator(cfg)
            d_a, d_b = d_lib.Discriminator(cfg), d_lib.Discriminator(cfg)
            state = gan_lib.GANState(0, g_ab, g_ba, d_a, d_b, None, None, None, None)
            return state._replace(
                g_opt=make_optimizer(cfg).init(gan_lib.g_params(state)),
                d_opt=gan_lib._d_optimizer(cfg).init(gan_lib.d_params(state)),
                ema_g_ab=gan_lib._ema_copy(g_ab) if ema else None,
                ema_g_ba=gan_lib._ema_copy(g_ba) if ema else None)
        from ..train import conditional_gan as cgan_lib

        g = cond_lib.ConditionalDenoiser(cfg, cfg.num_classes, cfg.class_embed_dim)
        d = d_lib.Discriminator(cfg, num_classes=cfg.num_classes)
        return cgan_lib.ConditionalGANState(
            0, g, d, make_optimizer(cfg).init(list(g.parameters())),
            gan_lib._d_optimizer(cfg).init(list(d.parameters())),
            gan_lib._ema_copy(g) if ema else None)


def _plan_gan(cfg, model: str, n_chips: int, hbm_gb: float, budget_frac: float) -> dict:
    """DP candidates for the GAN-mode trainers (planner.py:453): exact state
    bytes from the meta-built state, activations the diffusion model × the
    generator pass count (discriminator excluded); throughput for
    model="gan" the diffusion ladder ÷ the measured GAN_STEP_COST ratio
    (img/s per class); cgan has no measured anchors and stays None."""
    cfg = cfg.validate()
    budget = hbm_gb * 1024**3 * budget_frac
    passes = _gan_generator_passes(cfg, model)
    g_fields = ("g_ab", "g_ba", "d_a", "d_b") if model == "gan" else ("generator",
                                                                     "discriminator")

    def state_bytes(mdt: str, zero1_ways: int) -> int:
        c = cfg
        if mdt != c.moment_dtype:
            c = c.replace(moment_dtype=mdt, optimizer=c.optimizer
                          if c.optimizer in ("adam_tf", "adam_fused") else "adam_tf")
        tree = _abstract_gan_state(c, model)
        total = param_bytes(tree)
        opt = param_bytes(tree.g_opt) + param_bytes(tree.d_opt)
        total -= opt - opt // zero1_ways
        total += sum(param_bytes(getattr(tree, f)) for f in g_fields)
        return total

    candidates = []
    B = cfg.batch_size
    if B % n_chips == 0 or n_chips == 1:
        b_local = B / n_chips

        def act_fn(accum):
            return act_bytes(cfg, b_local) * passes

        ov, state, act, lever_note = _auto_levers(cfg, n_chips, n_chips, state_bytes, act_fn,
                                                  budget, allow_accum=False)
        overrides = {"mesh_data": n_chips, "mesh_model": 1, **ov}
        note = f"{passes} generator passes/step (cycle/identity terms)"
        if lever_note:
            note += "; " + lever_note
        fits = state + act <= budget
        ips = None
        per_chip = predict_ips_per_chip(cfg, b_local)
        if fits and model == "gan" and per_chip is not None:
            ratio = gan_step_cost_ratio(cfg)
            ips = per_chip / ratio * n_chips
            note += (f"; pred is img/s per class (measured step-cost ratio {ratio:.2f}× the "
                     "diffusion step)")
        candidates.append(Candidate("DP", overrides, state / 1e9, act / 1e9, fits, ips, None,
                                    note))
    else:
        candidates.append(Candidate("DP", {"mesh_data": n_chips}, 0, 0, False, None, None,
                                    f"batch_size={B} not divisible by {n_chips} chips"))

    chosen = candidates[0] if candidates and candidates[0].fits else None
    flags = " ".join(f"--{k.replace('_', '-')} {v}"
                     for k, v in (chosen.overrides.items() if chosen else ()))
    tree = _abstract_gan_state(cfg, model)
    n_params = sum(t.numel() for f in g_fields for t in _leaves(getattr(tree, f)))
    return {
        "workload": {
            "model": model,
            "size": cfg.size,
            "batch_size": B,
            "params_m": round(n_params / 1e6, 1),
            "compute_dtype": cfg.compute_dtype,
            "generator_passes": passes,
        },
        "chips": n_chips,
        "slices": 1,
        "hbm_gb": hbm_gb,
        "budget_gb": round(budget / 1e9, 2),
        "candidates": [c.to_dict() for c in candidates],
        "chosen": chosen.name if chosen else None,
        "overrides": chosen.overrides if chosen else {},
        "cli_flags": flags,
        "notes": [
            "GAN-mode planning covers DP (the supported mesh scaling for the GAN steps)",
            "gan throughput = diffusion ladder ÷ measured step-cost ratio (GAN_STEP_COST "
            f"anchors at 256² b16 a class; {CALIBRATION}); cgan has no measured anchors and "
            "stays unpredicted" if model == "gan"
            else "no cgan throughput prediction — no measured anchors (the GAN_STEP_COST "
            "ratios are cycle-GAN-specific)",
            "activation model = diffusion activations × generator passes, discriminator "
            "excluded (±30%)",
            REMAT_NOTE,
        ],
    }


# ------------------------------------------------------------ candidates


@dataclasses.dataclass
class Candidate:
    name: str
    overrides: dict
    state_gb: float
    act_gb: float
    fits: bool
    pred_img_s: Optional[float]  # total, all cards; None = no cost model
    ici_mb_step: Optional[float]  # bytes across cards a step (JAX's key name)
    note: str = ""

    @property
    def total_gb(self) -> float:
        return self.state_gb + self.act_gb

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "overrides": self.overrides,
            "state_gb": round(self.state_gb, 2),
            "act_gb": round(self.act_gb, 2),
            "total_gb": round(self.total_gb, 2),
            "fits": self.fits,
            "pred_img_s": round(self.pred_img_s, 1) if self.pred_img_s is not None else None,
            "ici_mb_step": round(self.ici_mb_step, 1) if self.ici_mb_step is not None else None,
            "note": self.note,
        }


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def _auto_levers(cfg, zero1_ways, dp_total, state_fn, act_fn, budget, allow_accum=True):
    """Engage the memory levers until the candidate fits (planner.py:627):
    bf16 moments → ZeRO-1 → grad_accum (with ``batch_size`` reduced to
    B/accum). Returns (overrides, state_bytes, act_bytes, note)."""
    overrides: dict = {}
    notes = []
    mdt = cfg.moment_dtype
    z0 = zero1_ways if cfg.zero1 else 1
    state = state_fn(mdt, z0)
    act = act_fn(1)
    if state + act > budget and mdt != "bfloat16":
        mdt = "bfloat16"
        overrides["moment_dtype"] = "bfloat16"
        overrides["optimizer"] = (cfg.optimizer if cfg.optimizer in ("adam_tf", "adam_fused")
                                  else "adam_tf")
        state = state_fn(mdt, z0)
        notes.append(BF16_MOMENTS_NOTE)
    if state + act <= budget:
        return overrides, state, act, "; ".join(notes)

    z_state = state_fn(mdt, zero1_ways) if zero1_ways > 1 else state
    can_zero1 = zero1_ways > 1 and not cfg.zero1 and cfg.grad_accum == 1
    if can_zero1 and z_state + act <= budget:
        overrides["zero1"] = True
        notes.append("ZeRO-1 moments over data axis")
        return overrides, z_state, act, "; ".join(notes)

    if allow_accum and cfg.grad_accum == 1 and not cfg.zero1:
        B = cfg.batch_size
        b_local = B // max(dp_total, 1)
        accum = 2
        while accum <= min(64, b_local):
            if b_local % accum == 0 and state + act_fn(accum) <= budget:
                overrides["grad_accum"] = accum
                overrides["batch_size"] = B // accum
                notes.append(f"grad_accum={accum} with batch_size {B // accum} (micro-step "
                             f"batch {b_local // accum}/chip; effective batch stays {B})")
                return overrides, state, act_fn(accum), "; ".join(notes)
            accum *= 2

    if can_zero1 and z_state < state:
        overrides["zero1"] = True
        notes.append("ZeRO-1 moments over data axis (still does not fit)")
        state = z_state
    return overrides, state, act, "; ".join(notes)


def plan(cfg, n_chips: int, hbm_gb: float = HBM_GB_H100, budget_frac: float = BUDGET_FRAC,
         model: str = "diffusion") -> dict:
    """Enumerate and rank parallelism strategies for ``cfg`` on ``n_chips``
    cards (planner.py:692): a JSON-ready dict with the workload, every
    candidate with its memory and throughput model, the chosen strategy's
    Config overrides and CLI flags, and the caveats."""
    if model in ("gan", "cgan"):
        return _plan_gan(cfg, model, n_chips, hbm_gb, budget_frac)
    if model != "diffusion":
        raise ValueError(f"unknown model {model!r}")
    cfg = cfg.validate()
    tree = abstract_params(cfg)
    p_bytes = param_bytes(tree)
    n_params = p_bytes / 4
    budget = hbm_gb * 1024**3 * budget_frac
    slices = max(getattr(cfg, "mesh_slice", 1), 1)
    if n_chips % slices:
        raise ValueError(f"n_chips={n_chips} not divisible by mesh_slice={slices}")
    per_slice = n_chips // slices
    B = cfg.batch_size
    dtype_note = ("" if _grid_dtype(cfg) else
                  f"no measured ladder for {cfg.compute_dtype}: throughput unpredicted")
    candidates = []

    def add(c):
        candidates.append(c)

    # ---- pure DP (optionally with the auto levers) ----
    dp_total = n_chips
    if B % dp_total == 0 or dp_total == 1:
        b_local = B / dp_total

        def state_fn(mdt, z):
            return model_state_bytes_per_chip(
                p_bytes, n_params,
                moment_bytes_chip=zero1_moment_bytes_per_chip(tree, per_slice, 1, mdt)
                if z > 1 else None,
                moment_dtype=mdt, ema=cfg.ema_decay > 0)

        def act_fn(accum):
            return act_bytes(cfg, b_local / accum)

        ov, state, act, lever_note = _auto_levers(cfg, per_slice, dp_total, state_fn, act_fn,
                                                  budget)
        fits = state + act <= budget
        ips = None
        per_chip = predict_ips_per_chip(cfg, b_local / ov.get("grad_accum", 1))
        if fits and per_chip is not None:
            eff_batch = b_local / ov.get("grad_accum", 1)
            ips = per_chip * n_chips
            eff = per_chip / predict_ips_per_chip(cfg, 1 << 20)
            if eff < 0.95:
                knee = _knee_batch(cfg) * dp_total
                lever_note = (lever_note + "; " if lever_note else "") + (
                    f"per-chip batch {eff_batch:g} is below the measured knee — global batch "
                    f"≥{knee} would buy ~{(1 / eff - 1):.0%} more throughput if the recipe "
                    "tolerates it")
            if n_chips > 1:
                lever_note = (lever_note + "; " if lever_note else "") + (
                    "linear in cards: the gradient all-reduce is outside the model")
        ici = 2 * (dp_total - 1) / dp_total * n_params * 2 / 1e6
        name = "DP" + (f"×{slices}slices" if slices > 1 else "")
        ov = {"mesh_data": per_slice, "mesh_model": 1, **ov}
        if slices > 1:
            ov["mesh_slice"] = slices
        note = "; ".join(filter(None, (lever_note, dtype_note)))
        if slices > 1:
            note = (note + "; " if note else "") + (
                "cross-slice gradient partials ride the slower link (hierarchical all-reduce)")
        add(Candidate(name, ov, state / 1e9, act / 1e9, fits, ips, ici, note))
    else:
        add(Candidate("DP", {"mesh_data": per_slice}, 0, 0, False, None, None,
                      f"batch_size={B} not divisible by {dp_total} chips — round batch to a "
                      f"multiple or use grad_accum"))

    # ---- DP × TP ----
    for m in (2, 4, 8):
        if per_slice % m or slices > 1:
            continue
        dp = per_slice // m
        if dp < 1 or (B % dp and dp > 1):
            continue
        b_local = B / max(dp, 1)
        p_chip = tp_param_bytes_per_chip(tree, m)
        state = model_state_bytes_per_chip(p_chip, p_chip / 4, moment_dtype=cfg.moment_dtype,
                                           ema=cfg.ema_decay > 0)
        act = act_bytes(cfg, b_local)  # activations whole on every model rank
        fits = state + act <= budget
        add(Candidate(
            f"DP{dp}×TP{m}", {"mesh_data": dp, "mesh_model": m}, state / 1e9, act / 1e9, fits,
            None, None,
            "TP halves param memory per ×2 but adds per-layer activation collectives — no "
            "cost model on this card; prefer DP/PP unless params alone overflow"))

    # ---- PP × DP ----
    from . import pipeline as pp

    for S in range(2, min(cfg.octaves, per_slice) + 1):
        if slices > 1:
            continue
        idle = 0
        if per_slice % S == 0:
            dp = per_slice // S
        else:
            dp, idle = 1, per_slice - S  # PP-only plan, leftover cards idle
        if B % max(dp, 1):
            continue
        b_local = B // max(dp, 1)
        cuts = [c for c in (cfg.pipeline_cuts or "").split(",") if c]
        plan_cfg = cfg if len(cuts) + 1 == S else cfg.replace(pipeline_cuts="")
        plan_s = pp.plan_stages(plan_cfg, S)
        work = stage_work(cfg, plan_s)
        ms = [d for d in _divisors(int(b_local)) if S <= d <= 32 * S]
        M = None
        for cand_m in ms:  # ascending: first under 10%, else the largest
            _, _, bub = pp_times(work, cand_m)
            M = cand_m
            if bub < 0.10:
                break
        if M is None:
            continue
        _, _, bubble = pp_times(work, M)
        micro_b = b_local // M
        stage_p = _stage_param_bytes(tree, plan_s)
        worst = max(range(S), key=lambda s: stage_p[s])
        state = model_state_bytes_per_chip(stage_p[worst], stage_p[worst] / 4,
                                           moment_dtype=cfg.moment_dtype, ema=cfg.ema_decay > 0)
        # live per card: the recompute keeps one microbatch's band activations at a
        # time, plus the stage's boundary inputs stashed for every microbatch
        dtype_b = 2 if cfg.compute_dtype != "float32" else 4
        bb_per_micro = boundary_bytes(cfg, plan_s, micro_b, dtype_b)

        def stage_act(s):
            band = _act_calib(cfg) * pp_stage_act_elems(cfg, plan_s, s) * dtype_b * micro_b
            bufs = sum(bb_per_micro[j] for j in range(len(bb_per_micro))
                       if j in (s - 1, s)) * M / 2
            return band + bufs

        act = max(stage_act(s) for s in range(S))
        fits = state + act <= budget
        bb = sum(boundary_bytes(cfg, plan_s, micro_b)) * M / 1e6
        note = f"bubble {bubble:.1%} at M={M}; {PP_NOTE}"
        if idle:
            note += f"; {idle} of {per_slice} chips sit idle (S∤chips)"
        add(Candidate(
            f"PP{S}×DP{dp}",
            {"mesh_data": dp, "pipeline_stages": S, "pipeline_microbatches": M},
            state / 1e9, act / 1e9, fits, None, bb, note))

    # ---- DP × spatial (library API — no Config knob) ----
    for sp in (2, 4, 8):
        if per_slice % sp or slices > 1:
            continue
        dp = per_slice // sp
        if B % max(dp, 1):
            continue
        b_local = B / max(dp, 1)
        state = model_state_bytes_per_chip(p_bytes, n_params, moment_dtype=cfg.moment_dtype,
                                           ema=cfg.ema_decay > 0)
        act = act_bytes(cfg, b_local, spatial_ways=sp)
        fits = state + act <= budget
        add(Candidate(
            f"DP{dp}×spatial{sp}", {}, state / 1e9, act / 1e9, fits, None, None,
            "height-sharded activations (halo exchange); library API: "
            "parallel.spatial_train.make_dp_spatial_mesh(data, spatial) — use when ONE "
            "image's activations overflow a card (≥1024² territory)"))

    def key(c: Candidate):
        return (not c.fits, c.pred_img_s is None, -(c.pred_img_s or 0), c.total_gb)

    candidates.sort(key=key)
    chosen = candidates[0] if candidates and candidates[0].fits else None
    flags = ""
    if chosen:
        flags = " ".join(f"--{k.replace('_', '-')} {v}" for k, v in chosen.overrides.items())
    return {
        "workload": {
            "size": cfg.size,
            "batch_size": B,
            "params_m": round(n_params / 1e6, 1),
            "compute_dtype": cfg.compute_dtype,
            "flops_per_image_train": _flops_per_image_train(cfg),
        },
        "chips": n_chips,
        "slices": slices,
        "hbm_gb": hbm_gb,
        "budget_gb": round(budget / 1e9, 2),
        "candidates": [c.to_dict() for c in candidates],
        "chosen": chosen.name if chosen else None,
        "overrides": chosen.overrides if chosen else {},
        "cli_flags": flags,
        "notes": [
            f"predictions are first-order, calibrated on one H100 ({CALIBRATION}); across "
            "cards DP scales the one-card ladder, its all-reduce not modelled",
            REMAT_NOTE,
        ],
    }


def format_plan(result: dict) -> str:
    """Human-readable table for the CLI."""
    w = result["workload"]
    tag = f" [{w['model']}]" if "model" in w else ""
    lines = [
        f"workload: {w['size']}²×3{tag}, {w['params_m']} M params, "
        f"global batch {w['batch_size']}, {w['compute_dtype']}",
        f"budget: {result['chips']} chips × {result['hbm_gb']} GB HBM "
        f"(plan to {result['budget_gb']} GB/chip)",
        "",
        f"{'strategy':<16} {'state GB':>9} {'act GB':>8} {'total':>7} "
        f"{'fits':>5} {'pred img/s':>11}  note",
    ]
    for c in result["candidates"]:
        pred = f"{c['pred_img_s']:.0f}" if c["pred_img_s"] is not None else "—"
        lines.append(
            f"{c['name']:<16} {c['state_gb']:>9.2f} {c['act_gb']:>8.2f} "
            f"{c['total_gb']:>7.2f} {'yes' if c['fits'] else 'NO':>5} "
            f"{pred:>11}  {c['note']}")
    lines.append("")
    if result["chosen"]:
        lines.append(f"recommended: {result['chosen']}")
        if result["cli_flags"]:
            lines.append(f"  flags: {result['cli_flags']}")
    else:
        lines.append("NO strategy fits — shrink the batch, raise grad_accum, or add chips")
    for n in result["notes"]:
        lines.append(f"note: {n}")
    return "\n".join(lines)
