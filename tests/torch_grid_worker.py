"""Scenarios of the port's tensor-parallel and spatial tests, and the worker
process that runs them as one rank of a gloo group on the CPU. Not a test
module: tests/test_torch_tp.py and tests/test_torch_spatial.py spawn

    python torch_grid_worker.py <mode> <rank> <world> <port> <dir>

once per rank; each rank runs the scenarios of ``<mode>`` and writes its
results to <dir>/<mode>-rank<k>.pt. The tests run the same scenario
functions in one process for the reference, and compare:

  * ``tp2``: two ranks as ``mesh_model=2`` (the diffusion, GAN and cGAN
    steps, an injected step from a carried JAX state, checkpoints both
    ways, a Runner's save, ``cli train --mesh-model 2``);
  * ``tp4``: four ranks as data 2 × model 2 under ZeRO-1, and with batch
    norms;
  * ``spatial2`` / ``spatial4``: height shards (the halo, the down conv,
    the U-Net forward and gradients, B3 over height blocks, the spatial
    train steps and each option they take) on a 2-way and a 4-way spatial
    mesh and a 2 × 2 data × spatial mesh."""

import contextlib
import io
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import multihost  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import spatial, spatial_train, spatial_unet  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

GLOBAL = 4

TP_CASES = {
    "adam_tf-ema": dict(optimizer="adam_tf", ema_decay=0.9),
    # the clip's global norm over the kernel slices, the decay on the
    # slices, the non-finite gate over the model group
    "clip-decay-dynamic": dict(optimizer="adam", grad_clip_norm=0.05, weight_decay=0.1,
                               dynamic_loss_scale=True),
    "uint8-momentum-remat": dict(optimizer="momentum", remat=True, block_depth=1),
}
INSTANCE = dict(g_norm="instance", d_norm="instance")
# the first-moment rule of ROADMAP.md Queue C: no Adam ahead of instance norms
GAN_CASE = dict(optimizer="sgd", **INSTANCE)
CGAN_CASE = dict(optimizer="momentum", **INSTANCE)


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _whole(mesh, *modules):
    """Every parameter of ``modules``, gathered whole (a collective on a
    tensor-parallel mesh)."""
    return [p.detach().clone() for m in modules
            for p in mesh_lib.whole_module(m, mesh).parameters()]


def _kernel_bytes(state):
    """{name: bytes} of the state's 4-D kernels this rank holds."""
    return {mesh_lib._name(p): t.numel() * t.element_size()
            for p, t in mesh_lib._leaves(state) if t.ndim == 4}


# ------------------------------------------------------------ the steps


def run_tp(name, mesh):
    """Two diffusion steps over ``mesh`` from the same weights and generator
    state, on the global batch's rows of the rank's data coordinate."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-2, warm_up=1, **TP_CASES[name])
    state, shardings = mesh_lib.init_sharded_state(cfg, mesh)
    step = mesh_lib.make_parallel_train_step(cfg, mesh)
    if name.startswith("uint8"):
        batch = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, (GLOBAL, 20, 20, 3), dtype=np.uint8))
    else:
        batch = torch.from_numpy(_np(3, (GLOBAL, 16, 16, 3)))
    batch = mesh_lib.local_rows(batch, mesh)
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    out = {"losses": losses, "params": _whole(mesh, state.model),
           "bytes": _kernel_bytes(state), "shardings": shardings}
    if state.ema_params is not None:
        ema = trainer.eval_model(state)
        out["ema"] = _whole(mesh, ema)
    return out


def run_tp_gan(mesh):
    """One cycle-GAN step (DiffAugment, R1's double backward, instance
    norms, EMA), then the transfer of 3 images with the split generator."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-3,
                           diffaug="color,translation,cutout", r1_weight=1.0, ema_decay=0.9,
                           **GAN_CASE)
    state, _ = mesh_lib.init_sharded_gan_state(cfg, mesh)
    step = mesh_lib.make_parallel_gan_train_step(cfg, mesh)
    a = mesh_lib.local_rows(torch.from_numpy(_np(4, (GLOBAL, 16, 16, 3))), mesh)
    b = mesh_lib.local_rows(torch.from_numpy(_np(5, (GLOBAL, 16, 16, 3))), mesh)
    state, metrics = step(state, a, b, torch.Generator().manual_seed(11))
    transfer = gan.make_transfer_fn(cfg, mesh)(gan.select_generator(state, "ab"),
                                              torch.from_numpy(_np(6, (3, 16, 16, 3))))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _whole(mesh, state.g_ab, state.g_ba, state.d_a, state.d_b,
                             state.ema_g_ab),
            "transfer": transfer.clone()}


def run_tp_cgan(mesh):
    """One conditional-GAN step (drawn targets, DiffAugment, R1), then the
    transfer of 3 images to classes (2, 0, 1)."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-3, num_classes=3,
                           diffaug="translation,color", r1_weight=0.5, **CGAN_CASE)
    state, _ = mesh_lib.init_sharded_conditional_gan_state(cfg, mesh)
    step = mesh_lib.make_parallel_conditional_gan_train_step(cfg, mesh)
    batch = {"image": mesh_lib.local_rows(torch.from_numpy(_np(7, (GLOBAL, 16, 16, 3))), mesh),
             "label": mesh_lib.local_rows(torch.tensor([0, 2, 1, 1]), mesh)}
    state, metrics = step(state, batch, torch.Generator().manual_seed(13))
    transfer = cgan.make_transfer_fn(cfg, mesh)(state.generator,
                                               torch.from_numpy(_np(8, (3, 16, 16, 3))),
                                               torch.tensor([2, 0, 1]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _whole(mesh, state.generator, state.discriminator),
            "transfer": transfer.clone()}


def run_injected(path, mesh):
    """One injected step from the state saved at ``path`` (a JAX state
    carried into the port) on its saved global batch, t and ε."""
    saved = torch.load(path, weights_only=False)
    cfg = Config.from_json(saved["config"])
    state = saved["state"]
    state = mesh_lib.shard_state(state, mesh_lib.state_shardings(state, mesh), mesh)
    rows = [mesh_lib.local_rows(saved[k], mesh) for k in ("x", "t", "eps")]
    state, loss = trainer.make_injected_train_step(cfg, mesh)(state, *rows)
    return {"loss": float(loss), "params": _whole(mesh, state.model)}


def tp_checkpoint(mesh, out_dir):
    """A split state after a step saved (gathered) by the coordinator to
    ``out_dir/tp``; the one-process checkpoint ``out_dir/one`` (written by
    the test) restored onto the ranks. Returns the rank's parts of the
    restored state's kernels and its live whole parameters."""
    cfg = tiny_test_config(batch_size=GLOBAL, optimizer="adam_tf", ema_decay=0.9)
    state, sh = mesh_lib.init_sharded_state(cfg, mesh)
    batch = mesh_lib.local_rows(torch.from_numpy(_np(3, (GLOBAL, 16, 16, 3))), mesh)
    state, _ = mesh_lib.make_parallel_train_step(cfg, mesh)(state, batch,
                                                            torch.Generator().manual_seed(1))
    snap = ckpt_lib.host_complete(state, None, sh)
    if multihost.is_coordinator():
        ckpt_lib.save(os.path.join(out_dir, "tp"), snap, cfg)
    multihost.barrier()
    fresh, _ = mesh_lib.init_sharded_state(cfg, mesh)
    fresh = ckpt_lib.restore(os.path.join(out_dir, "one"), fresh, shardings=sh)
    return {"live": _whole(mesh, state.model),
            "live_moments": {mesh_lib._name(p): t.clone() for p, t in mesh_lib._leaves(state)
                             if mesh_lib._is_opt_state_path(p) and t.ndim == 4},
            "restored_one": {mesh_lib._name(p): t.clone() for p, t in mesh_lib._leaves(fresh)},
            "shardings": sh}


def runner_save(mesh_model, out_dir):
    """A Runner under ``mesh_model`` on a dataset passed in: two steps, one
    checkpoint (every rank gathers, rank 0 writes), and the whole EMA
    parameters gathered the way ``log_sample`` gathers them."""
    from gan_class_transfer2_tpu_torch.train.loop import Runner

    cfg = tiny_test_config(batch_size=GLOBAL, mesh_model=mesh_model, ema_decay=0.9,
                           checkpoint_dir=os.path.join(out_dir, "runner"),
                           log_dir=os.path.join(out_dir, "rlogs"))

    class Pool:
        def __iter__(self):
            r = np.random.default_rng(0)
            while True:
                yield torch.from_numpy(r.uniform(-1, 1, (GLOBAL, 16, 16, 3)).astype(np.float32))

    runner = Runner(cfg, dataset=Pool(), log_dir=cfg.log_dir, device="cpu")
    for _ in range(2):
        runner.state, _ = runner.train_step(runner.state, next(runner.data_iter),
                                            runner.generator)
    runner._checkpoint_now()
    model = runner._eval_model()
    out = {"whole": [p.detach().clone() for p in model.parameters()],
           "local_shapes": [tuple(p.shape) for p in runner.state.model.parameters()]}
    runner.close()
    return out


def run_cli_train(rank, world, port, out_dir):
    """``cli train --mesh-model 2`` as a rank of the running group, with a
    checkpoint; the loss lines it printed."""
    from gan_class_transfer2_tpu_torch.data import synthetic

    pngs = os.path.join(out_dir, "pngs")
    if rank == 0:
        synthetic.save_as_pngs(synthetic.circles(8, 20), pngs)
    multihost.barrier()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(world), "--process-id", str(rank),
                       "--mesh-model", "2", "--size", "16", "--pixel-size", "4",
                       "--max-size", "8", "--octaves", "2", "--steps", "4", "--warm-up", "2",
                       "--test-step", "2", "--batch-size", "2", "--steps-per-epoch", "2",
                       "--epochs", "1", "--native-loader", "false", "--ema-decay", "0.9",
                       "--dataset-pattern", os.path.join(pngs, "*.png"),
                       "--checkpoint-every", "2",
                       "--checkpoint-dir", os.path.join(out_dir, "cli-ckpt"),
                       "--log-dir", os.path.join(out_dir, f"cli-logs-r{rank}")])
    printed = buf.getvalue()
    return {"rc": rc, "loss_lines": [ln.split(" images/s")[0].rsplit(" ", 1)[0]
                                     for ln in printed.splitlines() if "loss=" in ln]}


def run_tp_distill(mesh):
    """One distill_round (3 steps, stride 2) over ``mesh``: the student
    split over the model pair (the teacher whole), returned whole."""
    from gan_class_transfer2_tpu_torch.train import distill

    cfg = tiny_test_config(batch_size=GLOBAL, optimizer="adam_tf")
    teacher = api.init_denoiser(cfg, torch.Generator().manual_seed(2), device="cpu")
    r = np.random.default_rng(5)
    batches = [mesh_lib.local_rows(torch.from_numpy(
        r.uniform(-1, 1, (GLOBAL, 16, 16, 3)).astype(np.float32)), mesh) for _ in range(3)]
    losses = []
    student, loss = distill.distill_round(
        cfg, teacher, iter(batches), 2, 3, torch.Generator().manual_seed(17),
        log=lambda *_: None, on_loss=lambda s, i, v: losses.append(v), mesh=mesh)
    return {"loss": loss, "losses": losses,
            "params": [p.detach().clone() for p in student.parameters()],
            "whole": all(not hasattr(m, "tp") for m in student.modules())}


def run_tp_bench(mesh):
    """``run_benchmark`` over ``mesh`` (the parallel step on the sharded
    state), one untimed and one timed step."""
    from gan_class_transfer2_tpu_torch.utils import benchmark

    cfg = tiny_test_config(batch_size=GLOBAL)
    res = benchmark.run_benchmark(cfg, steps=1, warmup=1, device="cpu", mesh=mesh)
    return {"final_loss": res.extra["final_loss"], "n_chips": res.extra["n_chips"]}


def run_tp_gan_runner(mesh_model, out_dir):
    """A GANRunner under ``mesh_model`` on class datasets passed in: one
    log_sample (the split generators' transfers) and 2 steps; the logged
    transfer images and the epoch's metrics."""
    from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner

    cfg = tiny_test_config(batch_size=GLOBAL, mesh_model=mesh_model, log_images_every=1,
                           **GAN_CASE,
                           log_dir=os.path.join(out_dir, f"glogs{mesh_model}"))

    class Pool:
        def __init__(self, seed):
            self.seed = seed

        def __iter__(self):
            r = np.random.default_rng(self.seed)
            while True:
                yield torch.from_numpy(r.uniform(-1, 1, (GLOBAL, 16, 16, 3)).astype(np.float32))

    runner = GANRunner(cfg, Pool(1), Pool(2), log_dir=cfg.log_dir, device="cpu")
    images = []
    write = runner.writer.image
    runner.writer.image = lambda tag, imgs, *a, **k: images.append((tag, np.array(imgs)))
    runner.fit(epochs=1, steps_per_epoch=2)
    runner.writer.image = write
    out = {"images": images, "g_ab": _whole(runner.mesh, runner.state.g_ab)}
    runner.close()
    return out


def run_slice(mesh):
    """The ``zero1`` diffusion case of run_tp on this mesh (a slice mesh or
    the flat data mesh it must equal)."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-2, warm_up=1,
                           optimizer="adam_tf", zero1=True)
    state, sh = mesh_lib.init_sharded_state(cfg, mesh)
    step = mesh_lib.make_parallel_train_step(cfg, mesh)
    batch = mesh_lib.local_rows(torch.from_numpy(_np(3, (GLOBAL, 16, 16, 3))), mesh)
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    return {"losses": losses, "params": _whole(mesh, state.model), "shardings": sh,
            "spec": mesh_lib.batch_sharding(mesh).spec}


def run_tp4(mesh, out_dir):
    """data 2 × model 2 under ZeRO-1 (the stacked split) with the clip: two
    steps; a checkpoint of it written by the coordinator."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-2, warm_up=1, optimizer="adam",
                           grad_clip_norm=0.05, zero1=True, ema_decay=0.9)
    state, sh = mesh_lib.init_sharded_state(cfg, mesh)
    step = mesh_lib.make_parallel_train_step(cfg, mesh)
    batch = mesh_lib.local_rows(torch.from_numpy(_np(3, (GLOBAL, 16, 16, 3))), mesh)
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    snap = ckpt_lib.host_complete(state, None, sh)
    if multihost.is_coordinator():
        ckpt_lib.save(os.path.join(out_dir, "tp4"), snap, cfg)
    multihost.barrier()
    return {"losses": losses, "params": _whole(mesh, state.model), "shardings": sh,
            "moment_shapes": {mesh_lib._name(p): tuple(t.shape) for p, t in
                              mesh_lib._leaves(state) if mesh_lib._is_opt_state_path(p)},
            "coords": dict(mesh.coords)}


def run_tp4_batch(mesh):
    """data 2 × model 2 with batch norms in the denoiser (SGD with
    momentum, ZeRO-1): two steps; the statistics span the data pair, the
    model pair of a data group computes them alike."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-2, warm_up=1,
                           optimizer="momentum", g_norm="batch", zero1=True)
    state, _ = mesh_lib.init_sharded_state(cfg, mesh)
    step = mesh_lib.make_parallel_train_step(cfg, mesh)
    batch = mesh_lib.local_rows(torch.from_numpy(_np(3, (GLOBAL, 16, 16, 3))), mesh)
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    return {"losses": losses, "params": _whole(mesh, state.model)}


# -------------------------------------------------------------- spatial

SPATIAL_CFG = dict(size=32, pixel_size=4, max_size=8, octaves=2)
# what JAX's GSPMD step takes and the spatial step now takes too: norms
# (instance: B3 over height blocks; batch: over data × spatial), the
# per-step head, the whole-image losses, dynamic loss scaling, a uint8
# batch of 40² images the step crops to 32², and remat (alone and under
# instance norms: the recompute re-runs the halos and B3's block gathers)
SPATIAL_OPTIONS = {"instance": dict(g_norm="instance"), "batch": dict(g_norm="batch"),
                   "per_step": dict(per_step_output=True), "dct": dict(loss="dct"),
                   "multiscale": dict(loss="mse_multiscale"),
                   "dynamic": dict(dynamic_loss_scale=True), "uint8": dict(),
                   "remat": dict(remat=True),
                   "remat-instance": dict(remat=True, g_norm="instance", optimizer="momentum")}
RAW_SIDE = 40


def spatial_model(cfg, seed=0):
    return api.init_denoiser(cfg, torch.Generator().manual_seed(seed), device="cpu")


def run_spatial(mesh):
    """On this rank's height shard: the halo of a small block (1/1, 2/0 and
    0/0 rows), the k4/s2 down conv, the U-Net forward and its gradients
    (block_depth 0 and 1, concat elided or not)."""
    n = mesh.axis("spatial").size
    out = {}
    x = torch.arange(2 * 4 * n * 3 * 2, dtype=torch.float32).reshape(2, 4 * n, 3, 2)
    local = spatial_train.local_block(x, mesh).contiguous()
    out["halo"] = {(lo, hi): spatial.halo_exchange(local, "spatial", lo, hi)
                   for lo, hi in ((1, 1), (2, 0), (0, 1))}
    out["halo_zero_is_identity"] = spatial.halo_exchange(local, "spatial", 0, 0) is local
    r = np.random.default_rng(1)
    xc = torch.from_numpy(r.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32))
    kernel = torch.from_numpy(r.normal(size=(4, 4, 4, 8)).astype(np.float32) * 0.1)
    bias = torch.from_numpy(r.normal(size=(8,)).astype(np.float32) * 0.1)
    out["down"] = spatial.make_spatial_down_conv(mesh)(
        spatial_train.local_block(xc, mesh).contiguous(), kernel, bias)
    xi = torch.from_numpy(_np(0, (2, 32, 32, 3)))
    xl = spatial_train.local_block(xi, mesh).contiguous()
    for tag, over in (("base", {}), ("depth1", dict(block_depth=1)),
                      ("concat", dict(concat_elision=False))):
        cfg = tiny_test_config(**SPATIAL_CFG, **over)
        model = spatial_model(cfg, 1 if tag == "depth1" else 0)
        fn = spatial_unet.make_spatial_unet_apply(cfg, mesh)
        y = fn(model, xl.requires_grad_(False))
        # the global mean of y², each rank's share, summed over the ranks
        count = y.numel() * mesh.size
        grads = torch.autograd.grad((y ** 2).sum() / count, list(model.parameters()))
        grads = multihost.all_reduce_mean(list(grads), None, mean=False)
        out[tag] = {"y": y.detach().clone(), "grads": grads}
    out["b3"] = run_b3_blocks(mesh)
    return out


def run_b3_blocks(mesh):
    """B3 over height blocks (the plain version on the CPU) on this rank's
    block of a (2, 16, 8, 40) batch, float32 and bfloat16: y, and the VJP
    of a drawn cotangent (dx the block's; dγ and dβ summed over every
    rank, as the step's gradient all-reduce sums them)."""
    from gan_class_transfer2_tpu_torch.ops import norm

    r = np.random.default_rng(12)
    x = torch.from_numpy((r.normal(size=(2, 16, 8, 40)) * 2 + 0.5).astype(np.float32))
    dy = torch.from_numpy(r.normal(size=x.shape).astype(np.float32))
    gamma = torch.from_numpy(r.normal(1.0, 0.3, 40).astype(np.float32))
    beta = torch.from_numpy(r.normal(0.0, 0.3, 40).astype(np.float32))
    out = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xl = spatial_train.local_block(x, mesh).to(dtype).contiguous().requires_grad_()
        g, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        y = norm.instance_norm_blocks(xl, g, b, mesh.axis("spatial"))
        dx, dg, db = torch.autograd.grad(
            y, (xl, g, b), spatial_train.local_block(dy, mesh).to(dtype).contiguous())
        dg, db = multihost.all_reduce_mean([dg, db], None, mean=False)
        out[name] = {"y": y.detach().float(), "dx": dx.float(), "dgamma": dg, "dbeta": db}
    return out


def run_spatial_steps(mesh, injected_path):
    """One injected spatial step from the carried JAX state at
    ``injected_path``, and two generator-driven steps (unfused) on a
    32² batch: this rank's loss and the (whole) weights."""
    saved = torch.load(injected_path, weights_only=False)
    cfg = Config.from_json(saved["config"])
    state = saved["state"]
    dp = "data" in mesh.shape
    make = spatial_train.make_dp_spatial_train_step if dp else spatial_train.make_spatial_train_step
    step = make(cfg, mesh)
    state, loss = step(state, spatial_train.local_block(saved["x"], mesh).contiguous(), None,
                       t_int=spatial_train.local_rows(saved["t"], mesh),
                       epsilon=spatial_train.local_block(saved["eps"], mesh).contiguous())
    out = {"injected": {"loss": float(loss),
                        "params": [p.detach().clone() for p in state.model.parameters()]}}
    cfg = tiny_test_config(**SPATIAL_CFG, batch_size=GLOBAL, optimizer="adam_tf",
                           learning_rate=1e-2, warm_up=1, ema_decay=0.9)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    step = make(cfg, mesh)
    batch = spatial_train.local_block(torch.from_numpy(_np(9, (GLOBAL, 32, 32, 3))), mesh)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch.contiguous(), gen)
        losses.append(float(loss))
    out["drawn"] = {"losses": losses,
                    "params": [p.detach().clone() for p in state.model.parameters()],
                    "ema": [e.clone() for e in state.ema_params]}
    # the fused path on the card's noise: B1s's plain version at the rank's
    # position; the ranks' ε differ, so the loss is reported, not compared
    fcfg = cfg.replace(fused_diffusion=True)
    fstate = trainer.init_state(fcfg, torch.Generator().manual_seed(2), device="cpu")
    _, floss = make(fcfg, mesh)(fstate, batch.contiguous(), torch.Generator().manual_seed(5))
    out["fused_loss"] = float(floss)
    return out


def run_spatial_options(mesh, path):
    """One injected step for each of SPATIAL_OPTIONS from the JAX states
    saved at ``path`` (grid_jax_refs.write_options) on this rank's block of
    the batch, t and ε (a uint8 batch: the rank's rows of whole images and
    a generator for the crop's draws); the loss, the whole weights and the
    loss-scale state. Then a uint8 pool (``HBMDataset``, raw) under the
    mesh: the rows each rank draws. Each option's collectives over the step
    are counted by kind (``multihost.comm``), and a remat option's again
    with remat off."""
    from gan_class_transfer2_tpu_torch.data import device_augment
    from gan_class_transfer2_tpu_torch.parallel.mesh import Sharding

    dp = "data" in mesh.shape
    make = spatial_train.make_dp_spatial_train_step if dp else spatial_train.make_spatial_train_step
    out = {}
    for tag, d in torch.load(path, weights_only=False).items():
        cfg = Config.from_json(d["config"])
        rows = (spatial_train.local_rows(d["t"], mesh),
                spatial_train.local_block(d["eps"], mesh).contiguous())
        if d["raw"] is not None:
            batch, gen = spatial_train.local_rows(d["raw"], mesh), torch.Generator().manual_seed(3)
        else:
            batch, gen = spatial_train.local_block(d["x"], mesh).contiguous(), None
        multihost.comm.reset()
        state, loss = make(cfg, mesh)(d["state"], batch, gen, t_int=rows[0], epsilon=rows[1])
        out[tag] = {"loss": float(loss),
                    "params": [p.detach().clone() for p in state.model.parameters()],
                    "scale": None if state.scale_state is None else
                    (float(state.scale_state.scale), int(state.scale_state.good_steps)),
                    "comm": dict(multihost.comm.calls)}
        if cfg.remat:  # the same step without remat, for its collectives' count
            multihost.comm.reset()
            make(cfg.replace(remat=False), mesh)(state, batch, gen, t_int=rows[0],
                                                 epsilon=rows[1])
            out[tag]["comm_without_remat"] = dict(multihost.comm.calls)
    pool = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (6, RAW_SIDE, RAW_SIDE, 3),
                                                               dtype=np.uint8))
    spec = ("data", "spatial") if dp else (None, "spatial")
    hbm = device_augment.HBMDataset(pool, 32, GLOBAL, seed=1, raw=True,
                                    sharding=Sharding(mesh, spec), device="cpu")
    out["pool"] = next(iter(hbm)).clone()
    return out


def _mode_runs(mode, rank, world, port, out_dir):
    if mode == "tp2":
        mesh = mesh_lib.make_mesh(device="cpu", model=2)
        assert mesh.coords["model"] == rank and mesh.data_index == 0, mesh.coords
        out = {"tp": {k: run_tp(k, mesh) for k in TP_CASES},
               "gan": run_tp_gan(mesh), "cgan": run_tp_cgan(mesh),
               "injected": run_injected(os.path.join(out_dir, "injected.pt"), mesh),
               "checkpoint": tp_checkpoint(mesh, out_dir),
               "runner": runner_save(2, out_dir),
               "gan_runner": run_tp_gan_runner(2, out_dir)}
        mesh = mesh_lib.make_mesh(device="cpu", model=2)
        out["distill"] = run_tp_distill(mesh)
        out["bench"] = run_tp_bench(mesh)
        out["slice"] = run_slice(mesh_lib.make_mesh(device="cpu", slices=2))
        out["flat"] = run_slice(mesh_lib.make_mesh(device="cpu"))
        out["cli_train"] = run_cli_train(rank, world, port, out_dir)
        return out
    if mode == "tp4":
        mesh = mesh_lib.make_mesh(device="cpu", data=2, model=2)
        return {"tp4": run_tp4(mesh, out_dir), "tp4_batch": run_tp4_batch(mesh)}
    if mode == "spatial2":
        mesh = spatial_train.make_spatial_mesh(device="cpu")
        return {"spatial": run_spatial(mesh),
                "steps": run_spatial_steps(mesh, os.path.join(out_dir, "injected.pt")),
                "options": run_spatial_options(mesh, os.path.join(out_dir, "options.pt"))}
    if mode == "spatial4":
        out = {"spatial": run_spatial(spatial_train.make_spatial_mesh(device="cpu"))}
        mesh = spatial_train.make_dp_spatial_mesh(2, 2, device="cpu")
        out["dp"] = run_spatial(mesh)
        out["steps"] = run_spatial_steps(mesh, os.path.join(out_dir, "injected.pt"))
        out["options"] = run_spatial_options(mesh, os.path.join(out_dir, "options.pt"))
        return out
    raise ValueError(mode)


def main():
    mode, rank, world, port, out_dir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = _mode_runs(mode, rank, world, port, out_dir)
        torch.save(out, os.path.join(out_dir, f"{mode}-rank{rank}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
