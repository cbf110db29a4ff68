#!/usr/bin/env python3
"""Tensor parallelism, spatial sharding and pipeline parallelism of the
PyTorch port over four cards of one host.

``--part grids``: tensor parallelism and spatial sharding over four ranks,
each on a card of its own over nccl (``parallel/multihost``'s rule: nccl
when every rank has a card, gloo when ranks share one).

Two grids at the reference's full width (``Config()``: 256², 41.7 M
parameters), global batch 16, float32, one injected step each from the
same weights, t and ε:

  * data 2 × model 2 (``parallel/mesh.make_mesh(data=2, model=2)``): each
    conv's output channels split over the model pair, B4 on the local
    shapes, the gradients averaged over the data pair;
  * data 2 × spatial 2 (``parallel/spatial_train.make_dp_spatial_mesh``):
    the batch over the data pair, every activation's height over the
    spatial pair, the gradients summed over all four.

Each is held against one process's injected step on the same global batch
(run first on rank 0 alone): the loss within 1e-5 relative, the updates
beyond 1e-3 of the learning rate on at most 1e-4 of the elements (the
bounds of ``chip_smoke.py``'s ``[dp-agree]``). Timed: the step (median of
3, every rank started together) and one further step, with the calls and
bytes of its tensor-parallel gathers and input-gradient all-reduces, its
halos and its gradient all-reduce.

``--part pipeline``: ``parallel/pipeline.PipelineTrainer`` in this one
process over 2 and 4 cards (stage s on ``cuda:s``) and as 2 stages × 2
replicas, one generator-driven step each from the same weights and
generator state as the one-process step on ``cuda:0`` (same bounds), then
the step (median of 3) and the time the host took to return from it,
peak memory a card, and the planner's prediction for the same layout
beside it. With ``--norm batch`` the generator takes batch norms: each
layout with replicas is held against and timed beside the same layout
without them (each microbatch's statistics whole on its stage's first
card; the one-process step takes the whole batch's, another answer),
its replicas a thread each on cards of their own, summing each norm's
statistics; SGD with momentum there.

Printed: the cards' names and power limits, and one JSON object as the
last line (also written to ``--out``). Exit 1 when a check fails.

  python tools/parallel_cards_torch.py --out chiprun_out/parallel_cards.json
  python tools/parallel_cards_torch.py --part pipeline --out pipeline_cards.json
  python tools/parallel_cards_torch.py --part pipeline --norm batch --out pipeline_bn.json
  python tools/parallel_cards_torch.py --device cpu --tiny   # a rehearsal
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANKS = 4
BATCH = 16
LR = 1e-3


def _config(tiny: bool):
    from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config

    if tiny:
        return tiny_test_config(size=32, batch_size=BATCH, optimizer="adam_tf",
                                lr_schedule="constant", learning_rate=LR)
    return Config().replace(batch_size=BATCH, optimizer="adam_tf", lr_schedule="constant",
                            learning_rate=LR).validate()


def _rank(rank: int, port: int, device: str, tiny: bool, queue) -> None:
    import torch

    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost, spatial_train
    from gan_class_transfer2_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", RANKS, rank, device=device)
    cuda = device == "cuda"
    dev = multihost.local_device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = _config(tiny)
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).to(dev)
    init = api.init_denoiser(cfg, device="cpu")
    p0 = [p.detach().to(dev) for p in init.parameters()]

    def fresh():
        model = copy.deepcopy(init).to(dev)
        return trainer.TrainState(0, model, trainer.make_optimizer(cfg).init(
            list(model.parameters())), None, None)

    def timed(fn, reps=3, together=True):
        times = []
        for _ in range(reps):
            sync()
            if together:
                multihost.barrier()
            t1 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(times))

    out = {"rank": rank, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    ref = None
    if rank == 0:  # one process on the whole batch, rank 0 alone
        state = fresh()
        step = trainer.make_injected_train_step(cfg)
        state, loss = step(state, x, t, eps)
        sync()
        ref = {"loss": float(loss),
               "delta": [p.detach() - q for p, q in zip(state.model.parameters(), p0)]}
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], x, t, eps)

        out["one_process"] = {"loss": ref["loss"], "step_ms": timed(again, together=False)}
        del holder, state
    multihost.barrier()

    def check(res, whole):
        if ref is None:
            return
        res["rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
        diff = torch.cat([(p.detach() - q - d).abs().flatten()
                          for p, q, d in zip(whole.parameters(), p0, ref["delta"])])
        res["max_diff"] = diff.max().item()
        res["share"] = (diff > 1e-3 * LR).double().mean().item()
        res["ok"] = res["rel"] <= 1e-5 and res["share"] <= 1e-4

    def comm_step(fn):
        multihost.comm.reset()
        t1 = time.perf_counter()
        fn()
        sync()
        return {"step_ms": (time.perf_counter() - t1) * 1e3,
                "calls": dict(multihost.comm.calls),
                "mb": {k: v / 1e6 for k, v in multihost.comm.bytes.items()}}

    # data 2 x model 2
    mesh = mesh_lib.make_mesh(device=device, data=2, model=2)
    state = fresh()
    state = mesh_lib.shard_state(state, mesh_lib.state_shardings(state, mesh), mesh)
    rows = tuple(mesh_lib.local_rows(v, mesh) for v in (x, t, eps))
    step = trainer.make_injected_train_step(cfg, mesh)
    fdc.down_conv_fused.launches = 0
    state, loss = step(state, *rows)
    sync()
    res = {"loss": float(loss), "b4_launches": fdc.down_conv_fused.launches,
           "coords": dict(mesh.coords)}
    whole = mesh_lib.whole_module(state.model, mesh)
    check(res, whole)
    del whole
    holder = [state]

    def tp_again():
        holder[0], _ = step(holder[0], *rows)

    res["step_ms"] = timed(tp_again)
    res["comm"] = comm_step(tp_again)
    out["dp_tp"] = res
    del holder, state
    if cuda:
        torch.cuda.empty_cache()

    # data 2 x spatial 2
    smesh = spatial_train.make_dp_spatial_mesh(2, 2, device=device)
    step = spatial_train.make_dp_spatial_train_step(cfg, smesh)
    rows = (spatial_train.local_block(x, smesh).contiguous(), spatial_train.local_rows(t, smesh),
            spatial_train.local_block(eps, smesh).contiguous())
    state = fresh()
    state, loss = step(state, rows[0], None, t_int=rows[1], epsilon=rows[2])
    sync()
    res = {"loss": float(loss), "coords": dict(smesh.coords)}
    check(res, state.model)
    holder = [state]

    def sp_again():
        holder[0], _ = step(holder[0], rows[0], None, t_int=rows[1], epsilon=rows[2])

    res["step_ms"] = timed(sp_again)
    res["comm"] = comm_step(sp_again)
    out["dp_spatial"] = res
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    multihost.shutdown()
    queue.put(out)


PIPELINES = ((2, 2, 1), (2, 4, 1), (4, 4, 1), (4, 8, 1), (2, 2, 2))  # stages, micro, data


def _pipelines(device: str, tiny: bool, norm: str) -> dict:
    """``--part pipeline``: each layout of PIPELINES against the one-process
    step, in this process; under ``norm="batch"`` each layout with replicas
    against the same layout without them."""
    import torch

    from gan_class_transfer2_tpu_torch.parallel import pipeline, planner
    from gan_class_transfer2_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if cuda
             else [torch.device("cpu")] * RANKS)
    dev0 = cards[0]
    cfg = _config(tiny).replace(optimizer="adam_fused", fused_diffusion=True)
    cfg = (cfg.replace(octaves=4) if tiny else cfg)  # 4 stages need 4 octaves
    if norm == "batch":  # SGD with momentum, as chip_smoke.py's [pp-agree] under batch norm
        cfg = cfg.replace(g_norm=norm, optimizer="momentum")
    cfg = cfg.validate()
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (BATCH, cfg.size, cfg.size, 3)).astype(np.float32)).to(dev0)

    def sync():
        if cuda:
            for d in cards:
                torch.cuda.synchronize(d)

    def run(step, state):
        """(step ms, host ms: when the step returned, before the cards
        finished), medians of 3 after a warm step."""
        gen = torch.Generator(device=dev0).manual_seed(1)
        times = []
        for _ in range(4):
            t1 = time.perf_counter()
            state, _ = step(state, x, gen)
            t2 = time.perf_counter()
            sync()
            times.append(((time.perf_counter() - t1) * 1e3, (t2 - t1) * 1e3))
        return tuple(float(np.median([t[k] for t in times[1:]])) for k in (0, 1))

    def reference(c):
        """(loss, updates, step ms, host ms) of the one-process step, or
        under batch norm of the layout ``c`` without replicas."""
        if norm == "batch":
            tr = pipeline.PipelineTrainer(c.replace(mesh_data=1),
                                          devices=cards[:c.pipeline_stages])
            state, step = tr.init_state(), tr.step
        else:
            state, step = trainer.init_state(cfg, device=dev0), trainer.make_train_step(cfg)
        state, loss = step(state, x, torch.Generator(device=dev0).manual_seed(5))
        sync()
        delta = [p.detach().to(dev0) - q for p, q in zip(state.model.parameters(), p0)]
        return (float(loss), delta) + run(step, state)

    p0 = [p.detach().clone() for p in trainer.init_state(cfg, device=dev0).model.parameters()]
    out = {"norm": norm, "layouts": []}
    if norm != "batch":
        ref_loss, delta, one_ms, one_host = reference(cfg)
        out["one_process"] = {"loss": ref_loss, "step_ms": one_ms, "host_ms": one_host}
    for stages, micro, data in PIPELINES:
        c = cfg.replace(pipeline_stages=stages, pipeline_microbatches=micro, mesh_data=data)
        need = stages * data
        if norm == "batch":
            if data == 1:
                continue
            ref_loss, delta, one_ms, one_host = reference(c)
        if cuda:
            torch.cuda.empty_cache()
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
        tr = pipeline.PipelineTrainer(c, devices=cards[:need])
        st = tr.init_state()
        st, loss = tr.step(st, x, torch.Generator(device=dev0).manual_seed(5))
        sync()
        diff = torch.cat([(p.detach().to(dev0) - q - d).abs().flatten()
                          for p, q, d in zip(st.model.parameters(), p0, delta)])
        ms, host = run(tr.step, st)
        name = f"PP{stages}×DP{data}"
        pred = next((k for k in planner.plan(c, need)["candidates"] if k["name"] == name), {})
        against = f"PP{stages}×DP1" if norm == "batch" else "one process"
        res = {"stages": stages, "microbatches": micro, "data": data, "plan": tr.plan,
               "against": against, "against_step_ms": one_ms, "against_host_ms": one_host,
               "devices": [str(d) for row in tr.stage_devices for d in row],
               "loss": float(loss), "rel": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
               "max_diff": diff.max().item(), "share": (diff > 1e-3 * LR).double().mean().item(),
               "step_ms": ms, "host_ms": host, "planner_pred_img_s": pred.get("pred_img_s"),
               "planner_microbatches": pred.get("overrides", {}).get("pipeline_microbatches"),
               "peak_gb": [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards[:need]]
               if cuda else None}
        res["ok"] = res["rel"] <= 1e-5 and res["share"] <= 1e-4
        out["layouts"].append(res)
        print(f"{name} M={micro} on {res['devices']} (plan {tr.plan}): loss rel {res['rel']:.2e}, "
              f"updates beyond 1e-3·lr {res['share']:.2e}; step {ms:.2f} ms "
              f"({BATCH / ms * 1e3:.1f} img/s; the host returned after {host:.2f} ms) against "
              f"{against}'s {one_ms:.2f} ms ({one_host:.2f}); the "
              f"planner predicts {res['planner_pred_img_s']} img/s (its M "
              f"{res['planner_microbatches']}); peak GB a card {res['peak_gb']}", flush=True)
        del st, tr
    out["ok"] = all(r["ok"] for r in out["layouts"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a 32² tiny config instead of the full width (a rehearsal)")
    p.add_argument("--part", choices=("grids", "pipeline"), default="grids",
                   help="the rank grids over nccl (TP, spatial) or the one-process pipeline")
    p.add_argument("--norm", choices=("none", "batch"), default="none",
                   help="--part pipeline: the generator's norms (batch: the layouts with "
                        "replicas against the same without)")
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and not torch.cuda.is_available():
        print("parallel_cards_torch: no CUDA card (pass --device cpu for a rehearsal)",
              file=sys.stderr)
        return 1
    cards = []
    if args.device == "cuda":
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        for line in cards:
            print(line)
    if args.part == "pipeline":
        summary = dict(_pipelines(args.device, args.tiny, args.norm), cards=cards, batch=BATCH,
                       tiny=args.tiny)
        return _emit(summary, args.out)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(k, port, args.device, args.tiny, queue))
             for k in range(RANKS)]
    for proc in procs:
        proc.start()
    results = []
    try:
        for _ in procs:
            results.append(queue.get(timeout=1800))
    finally:
        for proc in procs:
            proc.join(120)
            if proc.is_alive():
                proc.terminate()
    results.sort(key=lambda r: r["rank"])
    r0 = results[0]
    summary = {"cards": cards, "device_count": torch.cuda.device_count() if args.device == "cuda"
               else 0, "backend": r0["backend"], "ranks": [r["device"] for r in results],
               "batch": BATCH, "tiny": args.tiny, "one_process": r0["one_process"]}
    ok = True
    for name in ("dp_tp", "dp_spatial"):
        a = r0[name]
        same = len({r[name]["loss"] for r in results}) == 1
        ok = ok and a["ok"] and same
        summary[name] = dict(a, losses_equal_on_all_ranks=same)
        c = a["comm"]
        print(f"{name}: loss {a['loss']:.7f} vs one process {r0['one_process']['loss']:.7f} "
              f"(rel {a['rel']:.2e}); updates max|Δ| {a['max_diff']:.3e}, share beyond "
              f"1e-3·lr {a['share']:.2e}; step {a['step_ms']:.2f} ms (one process "
              f"{r0['one_process']['step_ms']:.2f} ms); collectives of one step "
              f"({c['step_ms']:.2f} ms): " + ", ".join(
                  f"{k} {c['calls'][k]} x {c['mb'][k]:.1f} MB" for k in sorted(c["calls"])))
    summary["peak_gb"] = [r["peak_gb"] for r in results]
    summary["ok"] = ok
    return _emit(summary, args.out)


def _emit(summary: dict, out) -> int:
    line = json.dumps(summary)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
