#!/usr/bin/env python3
"""Measure the PyTorch port's training-throughput ladder on one card: the
numbers ``gan_class_transfer2_tpu_torch/parallel/planner.py`` is calibrated
with (the counterpart of tools/bench_grid.py, which measured the JAX
package's TPU grid).

  * the grid: img/s of the default train step at each (size, batch) point of
    JAX's ``DEFAULT_GRID`` (tools/bench_grid.py:25-31; default widths,
    octaves 4 at 64², 6 elsewhere), in float32 and bfloat16, through the
    kernels (B4 and the conv epilogue, ``optimizer="adam_fused"``, fused
    diffusion): ``utils/benchmark.run_benchmark`` (warmup untimed, the
    timed loop ends in a synchronise), with ``torch.cuda.max_memory_allocated``
    over the run;
  * held-out points (``--held-out``), measured the same way, to check the
    model off the grid (batches that are not multiples of 8 among them);
  * remat: the peak memory and step time of one point with ``remat=True``
    beside the same point without;
  * the cycle-GAN step at 256², batch 16 a class, default GAN knobs with
    B4, in three forms (the full cycle, identity off,
    adversarial only) against the diffusion step at the same size and
    batch, in both dtypes (``--gan``).

One JSON line a measurement; the card's name and power limit first. A point
that does not fit the card is recorded as ``"oom": true``. ``--fit LOG``
reads such a log (no card needed) and prints the planner's constants from
it: the ladders, the activation constant fitted at ``FIT_POINT`` and checked
at ``CHECK_POINT``, the GAN step-cost terms and the remat numbers.

    python tools/bench_grid_torch.py --out bench_grid.jsonl
    python tools/bench_grid_torch.py --fit bench_grid.jsonl
    python tools/bench_grid_torch.py --grid 256:16 --dtypes float32 --device cpu  # rehearsal
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_GRID = ",".join(
    [f"64:{b}" for b in (32, 64, 128, 256, 512)]
    + [f"128:{b}" for b in (32, 64, 128, 256)]
    + [f"256:{b}" for b in (16, 32, 64, 128, 256)]
    + [f"512:{b}" for b in (8, 16, 32, 64)]
    + [f"1024:{b}" for b in (8, 16)]
)
HELD_OUT = "256:20,256:24,384:16,512:12"
FIT_POINT, CHECK_POINT = (512, 64), (256, 16)  # JAX fits at 512² b64; the check is the default step
KERNEL_PATH = dict(optimizer="adam_fused", fused_diffusion=True)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _point(size: int, batch: int, dtype: str, steps: int, warmup: int, device: str, **kw):
    import torch

    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.utils.benchmark import run_benchmark

    cfg = Config(size=size, octaves=4 if size == 64 else 6, batch_size=batch,
                 compute_dtype=dtype, **KERNEL_PATH, **kw).validate()
    row = {"size": size, "batch": batch, "dtype": dtype, **kw}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    try:
        res = run_benchmark(cfg, steps=steps, warmup=warmup, device=device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return dict(row, oom=True)
    row.update(img_s=res.extra["images_per_sec"], step_ms=res.extra["step_ms"],
               final_loss=res.extra["final_loss"])
    if cuda:
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
    return row


def _gan_point(size: int, batch: int, dtype: str, steps: int, warmup: int, device: str,
               form: str):
    """ms of the cycle-GAN step (one batch of ``batch`` a class) in one of
    the three forms."""
    import torch

    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.train import gan

    weights = {"full": {}, "identity_off": {"identity_weight": 0.0},
               "adversarial_only": {"identity_weight": 0.0, "cycle_weight": 0.0}}[form]
    cfg = Config(size=size, batch_size=batch, compute_dtype=dtype, **weights).validate()
    state = gan.init_gan_state(cfg, device=device)
    step = gan.make_gan_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    r = torch.Generator().manual_seed(1)
    a = (torch.rand((batch, size, size, 3), generator=r) * 2 - 1).to(device)
    b = (torch.rand((batch, size, size, 3), generator=r) * 2 - 1).to(device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for _ in range(warmup):
        state, metrics = step(state, a, b, gen)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, a, b, gen)
    sync()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return {"gan": form, "size": size, "batch": batch, "dtype": dtype, "step_ms": round(ms, 3),
            "img_s_per_class": round(batch * 1e3 / ms, 3)}


def fit(path: str) -> dict:
    """The planner's constants from a log of this tool."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.parallel import planner

    rows = [json.loads(line) for line in open(path)]
    card = next(r["card"] for r in rows if "card" in r)
    out = {"card": card, "grid": {}, "act_calib": {}, "gan_step_cost": {}}
    for r in rows:
        if r.get("kind") == "grid" and not r.get("oom"):
            out["grid"].setdefault(r["dtype"], {}).setdefault(r["size"], []).append(
                (r["batch"], r["img_s"]))

    def activation_constant(r):
        cfg = Config(size=r["size"], octaves=4 if r["size"] == 64 else 6,
                     compute_dtype=r["dtype"])
        p = planner.param_bytes(planner.abstract_params(cfg))
        state = planner.model_state_bytes_per_chip(p, p / 4)
        dtype_bytes = 2 if r["dtype"] == "bfloat16" else 4
        return ((r["peak_bytes"] - state)
                / (planner.act_elems_per_image(cfg) * dtype_bytes * r["batch"]))

    for dtype in out["grid"]:
        at = {(r["size"], r["batch"]): r for r in rows
              if r.get("kind") == "grid" and r["dtype"] == dtype and "peak_bytes" in r}
        c = activation_constant(at[FIT_POINT])
        check = at[CHECK_POINT]
        cfg = Config(size=check["size"], octaves=6, compute_dtype=dtype)
        p = planner.param_bytes(planner.abstract_params(cfg))
        pred = (planner.model_state_bytes_per_chip(p, p / 4) + c * planner.act_elems_per_image(cfg)
                * (2 if dtype == "bfloat16" else 4) * check["batch"])
        out["act_calib"][dtype] = {"fit": FIT_POINT, "value": round(c, 4), "check": CHECK_POINT,
                                   "predicted_gb": round(pred / 1e9, 3),
                                   "measured_gb": round(check["peak_bytes"] / 1e9, 3)}
        base = next(r for r in rows if r.get("kind") == "gan_base" and r["dtype"] == dtype)
        gan = {r["gan"]: r["step_ms"] / base["step_ms"] for r in rows
               if r.get("kind") == "gan" and r["dtype"] == dtype}
        if gan:
            out["gan_step_cost"][dtype] = {
                "base": round(gan["adversarial_only"], 3),
                "cycle": round(gan["identity_off"] - gan["adversarial_only"], 3),
                "identity": round(gan["full"] - gan["identity_off"], 3),
                "diffusion_step_ms": base["step_ms"]}
    out["remat"] = [{k: r[k] for k in ("size", "batch", "remat", "step_ms", "peak_bytes")}
                    for r in rows if r.get("kind") == "remat"]
    out["held_out"] = [{k: r[k] for k in ("size", "batch", "dtype", "img_s")}
                       for r in rows if r.get("kind") == "held_out"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default=DEFAULT_GRID)
    ap.add_argument("--held-out", default=HELD_OUT)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--remat-point", default="512:16", help="size:batch, float32; '' skips")
    ap.add_argument("--gan", type=int, default=16, help="batch a class; 0 skips the GAN anchors")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--fit", default=None, metavar="LOG",
                    help="print the planner's constants from a log of this tool and exit")
    args = ap.parse_args(argv)
    if args.fit:
        print(json.dumps(fit(args.fit), indent=1))
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card (pass --device cpu for a rehearsal)", file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t_start = time.perf_counter()
    emit({"card": _card(), "torch": torch.__version__, "cuda": torch.version.cuda})
    for dtype in args.dtypes.split(","):
        for kind, spec in (("grid", args.grid), ("held_out", args.held_out)):
            for item in filter(None, spec.split(",")):
                size, batch = (int(v) for v in item.split(":"))
                t0 = time.perf_counter()
                row = _point(size, batch, dtype, args.steps, args.warmup, args.device)
                emit(dict(row, kind=kind, wall_s=round(time.perf_counter() - t0, 2)))
    if args.remat_point:
        size, batch = (int(v) for v in args.remat_point.split(":"))
        for remat in (False, True):
            emit(dict(_point(size, batch, "float32", args.steps, args.warmup, args.device,
                             remat=remat), kind="remat"))
    if args.gan:
        for dtype in args.dtypes.split(","):
            emit(dict(_point(256, args.gan, dtype, args.steps, args.warmup, args.device),
                      kind="gan_base"))
            for form in ("full", "identity_off", "adversarial_only"):
                emit(dict(_gan_point(256, args.gan, dtype, args.steps, args.warmup,
                                     args.device, form), kind="gan"))
    emit({"done": True, "wall_s": round(time.perf_counter() - t_start, 1)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
