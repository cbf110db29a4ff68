"""Scenarios of the port's data-parallel tests, and the worker process that
runs them as one rank of a two-rank gloo group on the CPU. Not a test
module: tests/test_torch_parallel.py spawns

    python torch_dp_worker.py <rank> <world> <port> <dir>

once per rank; each rank runs every scenario with the mesh of the group and
writes its results to <dir>/rank<k>.pt. The tests run the same scenario
functions in one process, on a mesh of one rank and the whole global batch,
for the reference, and compare. Last, each rank runs ``cli distill`` as a
rank of the same group on the teacher checkpoint the test wrote
(``write_distill_teacher``)."""

import contextlib
import io
import os
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api, unet  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import multihost  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import distill, gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

GLOBAL = 4  # the global batch: 2 rows a rank on 2 ranks

DIFFUSION_CASES = {
    # a uint8 batch (the step crops, flips and normalises it), an EMA
    "uint8-adam_tf-ema": dict(optimizer="adam_tf", ema_decay=0.9),
    "zero1": dict(optimizer="adam_tf", zero1=True),
    "zero1-bf16": dict(optimizer="adam_tf", moment_dtype="bfloat16", zero1=True),
    # the clip's global norm summed over the ranks' slices, the decay on
    # the parameter slices, the non-finite gate on the averaged gradients
    "zero1-clip-decay-dynamic": dict(optimizer="adam", grad_clip_norm=0.05, weight_decay=0.1,
                                     dynamic_loss_scale=True, zero1=True),
    "zero1-momentum": dict(optimizer="momentum", zero1=True),
    # batch norm in the denoiser: statistics over the global batch, as
    # JAX's jit over the mesh takes them; SGD with momentum, since a conv
    # bias ahead of a norm has no true gradient (no Adam, see below)
    "batch-momentum": dict(optimizer="momentum", g_norm="batch"),
    "zero1-batch-momentum": dict(optimizer="momentum", g_norm="batch", zero1=True),
    # the inner octaves recomputed in the backward take the same statistics
    "batch-remat-momentum": dict(optimizer="momentum", g_norm="batch", remat=True),
}
# Adam without instance norms: a conv bias ahead of an instance norm has no
# true gradient, only rounding noise, which Adam's normalised step turns
# into updates of either sign on either side
INSTANCE = dict(g_norm="instance", d_norm="instance")
BATCH = dict(g_norm="batch", d_norm="batch")
GAN_CASES = {"sgd-instance": dict(optimizer="sgd", **INSTANCE),
             "zero1-adam_tf": dict(optimizer="adam_tf", zero1=True),
             "sgd-batch": dict(optimizer="sgd", **BATCH)}
CGAN_CASES = {"momentum-instance": dict(optimizer="momentum", **INSTANCE),
              "zero1-bf16": dict(optimizer="adam_tf", moment_dtype="bfloat16", zero1=True),
              "momentum-batch": dict(optimizer="momentum", **BATCH)}


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _params(*modules):
    return [p.detach().clone() for m in modules for p in m.parameters()]


def _opt_shapes(state):
    return {mesh_lib._name(path): tuple(t.shape) for path, t in mesh_lib._leaves(state)
            if mesh_lib._is_opt_state_path(path)}


def _diffusion(name, mesh):
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-2, warm_up=1,
                           **DIFFUSION_CASES[name])
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
    return cfg, state, gen, shardings, losses


def _opt_leaves(state):
    return {mesh_lib._name(p): t.clone() for p, t in mesh_lib._leaves(state)
            if mesh_lib._is_opt_state_path(p)}


def run_diffusion(name, mesh, ckpt_dir=None):
    """Two steps of the diffusion step over ``mesh`` from the same weights
    and generator state; under ZeRO-1 with ``ckpt_dir``, a checkpoint of
    the sliced state round trip."""
    cfg, state, gen, shardings, losses = _diffusion(name, mesh)
    out = {"losses": losses, "params": _params(state.model), "opt_shapes": _opt_shapes(state),
           "opt_bytes": mesh_lib.opt_state_bytes(state), "shardings": shardings}
    if state.ema_params is not None:
        out["ema"] = [e.clone() for e in state.ema_params]
    if ckpt_dir is not None:
        out.update(_checkpoint_round_trip(cfg, state, gen, shardings, mesh, ckpt_dir))
    return out


def write_one_process_checkpoint(ckpt_dir):
    """The "zero1" case's state after its two steps in one process, saved
    to ``ckpt_dir/one``; returns its (full) optimizer leaves by name."""
    mesh = mesh_lib.make_mesh(device="cpu")
    cfg, state, gen, _, _ = _diffusion("zero1", mesh)
    ckpt_lib.save(os.path.join(ckpt_dir, "one"), ckpt_lib.host_complete(state, gen), cfg)
    return _opt_leaves(state)


def _checkpoint_round_trip(cfg, state, gen, shardings, mesh, ckpt_dir):
    """Save the (sliced) state, gathered on every rank and written by the
    coordinator; restore it into a fresh sharded state; and restore the
    one-process checkpoint ``ckpt_dir/one`` (written by the test) into
    another. Returns the optimizer leaves of both restores, by name."""
    snap = ckpt_lib.host_complete(state, gen, shardings)
    if multihost.is_coordinator():
        ckpt_lib.save(os.path.join(ckpt_dir, "ranks"), snap, cfg)
    multihost.barrier()
    out = {}
    for tag in ("ranks", "one"):
        fresh, _ = mesh_lib.init_sharded_state(cfg, mesh)
        fresh = ckpt_lib.restore(os.path.join(ckpt_dir, tag), fresh, shardings=shardings)
        out[f"restored_{tag}"] = _opt_leaves(fresh)
    out["live_opt"] = _opt_leaves(state)
    return out


def run_gan(name, mesh):
    """One cycle-GAN step (DiffAugment, R1, EMA) over
    ``mesh``; then the transfer of 3 images (padded to the ranks)."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-3, diffaug="color,translation,cutout",
                           r1_weight=1.0, ema_decay=0.9, **GAN_CASES[name])
    state, _ = mesh_lib.init_sharded_gan_state(cfg, mesh)
    step = mesh_lib.make_parallel_gan_train_step(cfg, mesh)
    a = mesh_lib.local_rows(torch.from_numpy(_np(4, (GLOBAL, 16, 16, 3))), mesh)
    b = mesh_lib.local_rows(torch.from_numpy(_np(5, (GLOBAL, 16, 16, 3))), mesh)
    state, metrics = step(state, a, b, torch.Generator().manual_seed(11))
    g_ab = gan.select_generator(state, "ab")
    images = torch.from_numpy(_np(6, (3, 16, 16, 3)))
    transfer = gan.make_transfer_fn(cfg, mesh)(g_ab, images)
    # the 3 images zero-padded to the ranks' 4, as the split transfer pads
    # them, run whole: with batch norms the padding rows enter JAX's
    # statistics too
    padded = gan.make_transfer_fn(cfg)(g_ab, torch.cat([images, torch.zeros(1, 16, 16, 3)]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _params(state.g_ab, state.g_ba, state.d_a, state.d_b, state.ema_g_ab),
            "transfer": transfer.clone(), "transfer_padded": padded[:3].clone()}


def run_cgan(name, mesh):
    """One conditional-GAN step (drawn targets, DiffAugment, R1) over
    ``mesh``; then the transfer of 3 images to classes (2, 0, 1)."""
    cfg = tiny_test_config(batch_size=GLOBAL, learning_rate=1e-3, num_classes=3,
                           diffaug="translation,color", r1_weight=0.5, **CGAN_CASES[name])
    state, _ = mesh_lib.init_sharded_conditional_gan_state(cfg, mesh)
    step = mesh_lib.make_parallel_conditional_gan_train_step(cfg, mesh)
    batch = {"image": mesh_lib.local_rows(torch.from_numpy(_np(7, (GLOBAL, 16, 16, 3))), mesh),
             "label": mesh_lib.local_rows(torch.tensor([0, 2, 1, 1]), mesh)}
    state, metrics = step(state, batch, torch.Generator().manual_seed(13))
    images = torch.from_numpy(_np(8, (3, 16, 16, 3)))
    transfer = cgan.make_transfer_fn(cfg, mesh)(state.generator, images, torch.tensor([2, 0, 1]))
    padded = cgan.make_transfer_fn(cfg)(state.generator,
                                        torch.cat([images, torch.zeros(1, 16, 16, 3)]),
                                        torch.tensor([2, 0, 1, 0]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _params(state.generator, state.discriminator), "transfer": transfer.clone(),
            "transfer_padded": padded[:3].clone()}


def run_remat_backward_on_another_thread(mesh):
    """The gradient of Σ prediction² over the global batch for a denoiser
    with batch norms under ``remat``, the backward run on another thread
    than the forward, as autograd's device threads run it on the card:
    the inner octaves recomputed there must take the ranks' statistics as
    the forward did. The rank's gradients summed over the ranks."""
    cfg = tiny_test_config(batch_size=GLOBAL, g_norm="batch", remat=True)
    model = api.init_denoiser(cfg, torch.Generator().manual_seed(3), device="cpu")
    x = mesh_lib.local_rows(torch.from_numpy(_np(10, (GLOBAL, 16, 16, 3))), mesh)
    params = list(model.parameters())
    with mesh_lib.norm_stats(mesh):
        loss = torch.sum(torch.square(unet.unet_apply(cfg, model, x)))
    grads = []
    backward = threading.Thread(target=lambda: grads.extend(torch.autograd.grad(loss, params)))
    backward.start()
    backward.join()
    assert len(grads) == len(params), "the backward thread failed"
    summed = multihost.all_reduce_mean([*grads, loss.detach()], None, mean=False)
    return {"grads": [g.clone() for g in summed[:-1]], "loss": float(summed[-1])}


def run_injected(path, mesh):
    """One injected step from the state saved at ``path`` (a JAX state
    carried into the port) on its saved global batch, t and ε, under the
    saved config with and without ZeRO-1."""
    saved = torch.load(path, weights_only=False)
    out = {}
    for zero1 in (False, True):
        cfg = Config.from_json(saved["config"]).replace(zero1=zero1)
        state = torch.load(path, weights_only=False)["state"]  # a fresh copy
        if zero1:
            state = mesh_lib.shard_state(state, mesh_lib.state_shardings(state, mesh, True), mesh)
        rows = [mesh_lib.local_rows(saved[k], mesh) for k in ("x", "t", "eps")]
        state, loss = trainer.make_injected_train_step(cfg, mesh)(state, *rows)
        out[zero1] = {"loss": float(loss), "params": _params(state.model)}
    return out


def run_carried_gan(path, mesh):
    """One cycle-GAN step (batch norms in G and D, R1, no DiffAugment: the
    step draws nothing) from the JAX state saved at ``path`` on its saved
    class batches; the metrics and every net's weights."""
    saved = torch.load(path, weights_only=False)
    cfg = Config.from_json(saved["config"])
    state = weights.from_jax_gan_state(cfg, saved["state"], device="cpu")
    a, b = (mesh_lib.local_rows(saved[k], mesh) for k in ("a", "b"))
    state, metrics = mesh_lib.make_parallel_gan_train_step(cfg, mesh)(
        state, a, b, torch.Generator().manual_seed(0))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "nets": {n: [p.detach().clone() for p in getattr(state, n).parameters()]
                     for n in ("g_ab", "g_ba", "d_a", "d_b")}}


def run_sampling(mesh):
    """The sampler's helpers over ``mesh``: padding, the data-parallel
    apply, the eval program, a gathered batch and the sampler benchmark."""
    from gan_class_transfer2_tpu_torch.utils import benchmark

    cfg = tiny_test_config(steps=4)
    x5 = torch.arange(10.0).reshape(5, 2)
    local, n = mesh_lib.shard_sample_batch(x5, mesh)
    par = mesh_lib.make_data_parallel_apply(mesh, lambda p, x, t, s: x * p + t[:, None] * s)
    applied = par(2.0, torch.arange(12.0).reshape(3, 4), torch.tensor([1.0, 2.0, 3.0]), 0.5)
    model = api.init_denoiser(cfg, device="cpu")
    r = np.random.default_rng(0)
    image = torch.from_numpy(r.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32))
    noise = torch.from_numpy(r.normal(size=(2, 16, 16, 3)).astype(np.float32))
    dictionary = torch.from_numpy(r.normal(size=(16, 16, 2 ** cfg.bits_per_pixel, 3))
                                  .astype(np.float32))
    ev = mesh_lib.make_parallel_eval_fn(cfg, mesh)(model, image, noise, dictionary)
    batch = mesh_lib.local_rows(torch.from_numpy(_np(9, (GLOBAL, 3))), mesh)
    bench = benchmark.run_sampler_benchmark(cfg, batch=3, iters=1, mesh=mesh)
    return {"local": local, "n": n, "applied": applied, "eval": {k: v.clone() for k, v in ev.items()},
            "fetched": multihost.host_fetch(batch, ("data",)), "bench_mesh": bench["sampler_mesh"]}


# a uint8 stream (the step's augment) as JAX's mesh test distills,
# labeled float batches of a conditional model under ZeRO-1, and a uint8
# stream into a student (and teacher) with batch norms
DISTILL_CASES = {"uint8": dict(), "labeled-zero1": dict(num_classes=3, zero1=True),
                 "batch-momentum": dict(g_norm="batch", optimizer="momentum")}


def run_distill(name, mesh):
    """One distill_round (3 steps, stride 2) over ``mesh`` from the same
    teacher and generator state, each rank on its rows of every global
    batch; the loss of each logged step and the student's weights."""
    overrides = DISTILL_CASES[name]
    cfg = tiny_test_config(batch_size=GLOBAL, **overrides)
    teacher = api.init_denoiser(cfg, torch.Generator().manual_seed(2), device="cpu")
    r = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        if name != "labeled-zero1":
            batches.append(mesh_lib.local_rows(torch.from_numpy(r.integers(
                0, 256, (GLOBAL, 20, 20, 3), dtype=np.uint8)), mesh))
        else:
            batches.append({"image": mesh_lib.local_rows(torch.from_numpy(
                r.uniform(-1, 1, (GLOBAL, 16, 16, 3)).astype(np.float32)), mesh),
                "label": mesh_lib.local_rows(torch.tensor([2, 0, 1, 1]), mesh)})
    losses = []
    student, loss = distill.distill_round(
        cfg, teacher, iter(batches), 2, 3, torch.Generator().manual_seed(17),
        log=lambda *_: None, on_loss=lambda s, i, v: losses.append(v), mesh=mesh)
    return {"loss": loss, "losses": losses, "params": _params(student)}


def write_distill_teacher(out_dir):
    """A teacher checkpoint (EMA kept) and 8 PNGs for ``cli distill``:
    ``out_dir/teacher``, ``out_dir/pngs``."""
    from gan_class_transfer2_tpu_torch.data import synthetic

    pngs = os.path.join(out_dir, "pngs")
    synthetic.save_as_pngs(synthetic.circles(8, 20), pngs)
    cfg = tiny_test_config(batch_size=GLOBAL, ema_decay=0.9, native_loader=False,
                           dataset_pattern=os.path.join(pngs, "*.png"))
    state = trainer.init_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    ckpt_lib.save(os.path.join(out_dir, "teacher"), state._replace(step=3), cfg)


def run_cli_distill(rank, world, port, out_dir):
    """``cli distill`` as a rank of the running group: its own --out and
    --log-dir, so that what a rank writes shows; the loss lines it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["distill", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(world), "--process-id", str(rank),
                       "--checkpoint-dir", os.path.join(out_dir, "teacher"),
                       "--out", os.path.join(out_dir, f"student-r{rank}"),
                       "--log-dir", os.path.join(out_dir, f"dlogs-r{rank}"),
                       "--distill-steps", "2"])
    printed = buf.getvalue()
    # flags that name another group than the running one are refused
    refused = []
    for flags in (["--num-processes", str(world + 1), "--process-id", str(rank)],
                  ["--num-processes", str(world), "--process-id", str(world - 1 - rank)]):
        try:
            cli.main(["distill", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
                      *flags, "--checkpoint-dir", os.path.join(out_dir, "teacher"),
                      "--out", os.path.join(out_dir, f"refused-r{rank}")])
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    return {"rc": rc, "loss_lines": [ln for ln in printed.splitlines() if "loss=" in ln],
            "printed": printed, "refused": refused}


def run_all(mesh, out_dir):
    return {
        "diffusion": {k: run_diffusion(k, mesh, out_dir if k == "zero1" else None)
                      for k in DIFFUSION_CASES},
        "gan": {k: run_gan(k, mesh) for k in GAN_CASES},
        "cgan": {k: run_cgan(k, mesh) for k in CGAN_CASES},
        "injected": run_injected(os.path.join(out_dir, "injected.pt"), mesh),
        "injected_batch": run_injected(os.path.join(out_dir, "injected-batch.pt"), mesh),
        "carried_gan": run_carried_gan(os.path.join(out_dir, "gan-batch.pt"), mesh),
        "sampling": run_sampling(mesh),
        "distill": {k: run_distill(k, mesh) for k in DISTILL_CASES},
        "remat_thread": run_remat_backward_on_another_thread(mesh),
    }


def main():
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = mesh_lib.make_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank), mesh
        out = run_all(mesh, out_dir)
        out["cli_distill"] = run_cli_distill(rank, world, port, out_dir)
        out["coordinator"] = multihost.is_coordinator()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
