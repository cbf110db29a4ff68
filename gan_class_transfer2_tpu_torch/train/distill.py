"""Progressive sampler distillation — counterpart of
gan_class_transfer2_tpu/train/distill.py (Salimans & Ho 2022, adapted to
the reference's sampler algebra).

A student is trained to land in ONE stride-2s sampler step exactly where the
teacher lands in TWO stride-s steps; k rounds give a model whose
``sample_stride = 2^k`` samples follow the original trajectory at 1/2^k the
denoiser calls. The derivation of the closed-form x-space target is in the
JAX module's docstring; the expressions below are written in its order so
that float32 results agree to rounding.

What differs from the JAX package, and why:

  * The teacher and the student are ``nn.Module``s (the denoiser, or the
    class-conditional one); the student starts as a copy of the teacher and
    is updated in place, as the train step updates its model.
  * ``jax.random`` keys become a ``torch.Generator``; the step's draws of
    ``t`` and ε can be injected (``t=``, ``epsilon=``), as the train step's
    parity harness injects them, because ``jax.random`` cannot be
    reproduced.
  * The kernels on this path are the JAX step's: the step takes the
    optax-form update even under ``adam_fused`` (distill.py:222), so the
    fused Adam kernel B2 never runs here, and it draws ε unfused
    (distill.py:159-160), so B1 never runs either. B4 runs in the three
    denoiser calls of a step (the teacher's two, the student's one) under
    ``conv_impl="pallas"``; the student's backward goes through cuDNN
    around it.
  * Over the ranks of a process group (``mesh=``, parallel/mesh.make_mesh,
    where JAX jits the step over its device mesh, distill.py:243-287): t,
    ε and the uint8 augment are drawn for the global batch from a generator
    alike on every rank, each rank takes its rows (``global_rows``,
    ``local_rows``) and runs both teacher forwards and the student on them,
    and one ``all_reduce`` averages the gradients and the loss
    (``trainer.average_over_ranks``): two ranks equal one process on the
    same global batch and generator state. Under ``zero1`` each rank keeps
    its slice of the optimizer state (``mesh.zero1_update``), as JAX's
    state shardings slice it.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..core import diffusion
from ..core.schedule import alpha_dash
from ..models import api as model_api
from ..models import unet
from ..parallel import mesh as mesh_lib
from . import trainer as trainer_lib


def _validate(cfg, stride: int) -> None:
    if cfg.parameterization == "ode":
        raise ValueError(
            "progressive distillation does not support the ODE "
            "parameterization: its sampler recurrence carries a stale "
            "epsilon_theta (core/diffusion.step_update, reference "
            "train.py:392,462), so the trajectory is not a function of the "
            "current latent alone and the one-step target is ill-defined"
        )
    if stride % 2 != 0:
        raise ValueError(f"student stride must be even, got {stride}")
    if stride > cfg.steps:
        raise ValueError(f"stride {stride} exceeds steps T={cfg.steps}")
    if cfg.dynamic_loss_scale or cfg.loss_scale > 0:
        raise ValueError(
            "loss scaling is unsupported on the distillation path "
            "(bf16 on TPU needs none); distill with compute_dtype="
            "'bfloat16' or 'float32'"
        )


def student_grid(cfg, stride: int):
    """The student's visit schedule: exactly what sample/serve visit at
    ``sample_stride=stride`` (sampler.sample_timesteps, the one definition
    of the subset schedule)."""
    from ..sample import sampler

    return sampler.sample_timesteps(cfg.replace(sample_stride=stride))


def _call(cfg, model, z, t_vec, class_idx):
    return model_api.apply_denoiser(
        cfg, model, z.to(unet.DTYPES[cfg.compute_dtype]), t_vec, class_idx=class_idx
    ).float()


def _t_vec(t):
    # clamped at 1 where the teacher's second step falls off the grid (the
    # lanes masked out below): JAX's gather of the per-step head clamps its
    # index there, torch.gather would refuse it
    return torch.clamp(t[:, 0, 0, 0].to(torch.int32), min=1)


@torch.no_grad()
def distill_target(cfg, teacher, z_t, t, stride: int, class_idx=None):
    """The student's x-space regression target at latent ``z_t``, timestep
    ``t`` ((B, 1, 1, 1) float), for a student of ``stride`` (even; the
    teacher runs at stride/2). Pure teacher computation, without gradient."""
    s = stride // 2
    pred1 = _call(cfg, teacher, z_t, _t_vec(t), class_idx)
    x1, e1 = diffusion.step_update(cfg, pred1, z_t, None, t)
    t_mid = t - s
    z_mid = diffusion.renoise(cfg, x1, e1, t_mid)
    pred2 = _call(cfg, teacher, z_mid, _t_vec(t_mid), class_idx)
    x2, e2 = diffusion.step_update(cfg, pred2, z_mid, e1, t_mid)

    t2 = t - stride
    ad_t = alpha_dash(t, cfg.steps, cfg.schedule)
    ad2 = alpha_dash(t2, cfg.steps, cfg.schedule)
    r = (1 - ad2) ** 0.5 / (1 - ad_t) ** 0.5
    z2 = diffusion.renoise(cfg, x2, e2, t2)
    x_mid_target = (z2 - r * z_t) / (ad2**0.5 - r * ad_t**0.5)

    # at the grid's last point the sampler returns x_θ: the target is the
    # teacher's final clean estimate (x₂ when it still visits t − s, else x₁)
    teacher_final = torch.where(t_mid >= 1, x2, x1)
    return torch.where(t2 >= 1, x_mid_target, teacher_final)


def x_to_prediction(cfg, x_target, z_t, t):
    """Map an x-space target to the model's prediction space (the inverse of
    step_update's prediction → x_θ map at latent ``z_t``, timestep ``t``)."""
    if cfg.parameterization == "x":
        return x_target
    ad = alpha_dash(t, cfg.steps, cfg.schedule)
    eps = (z_t - ad**0.5 * x_target) / (1 - ad) ** 0.5
    if cfg.parameterization == "scaled_epsilon":
        return eps * (1 - ad) ** 0.5
    return eps  # epsilon


def draw(cfg, batch, generator, stride: int, mesh=None):
    """The step's draws (distill.py:147-160): ``t`` uniform on the student
    grid, (B,) int32, and ε ~ N(0, 1) of the batch's shape, from
    ``generator`` (on the batch's device or the CPU), on the batch's device.
    On a mesh the draws are the global batch's and ``batch`` holds this
    rank's rows of it, which the draws are cut to."""
    grid = torch.as_tensor(student_grid(cfg, stride), dtype=torch.int32)
    n = mesh_lib.global_rows(batch.shape[0], mesh)
    idx = torch.randint(0, grid.shape[0], (n,), generator=generator, device=generator.device)
    t = mesh_lib.local_rows(grid.to(generator.device)[idx], mesh).to(batch.device)
    epsilon = torch.randn((n, *batch.shape[1:]), generator=generator, device=generator.device,
                          dtype=batch.dtype)
    return t, mesh_lib.local_rows(epsilon, mesh).to(batch.device)


def distill_loss(cfg, student, teacher, batch, generator, stride: int, class_idx=None, *,
                 t=None, epsilon=None, mesh=None):
    """Draw (t, ε) on the student grid (or take the injected ``t``, (B,)
    integers, and ``epsilon``), build z_t from data, and regress the
    student's prediction onto the two-teacher-step target, in the model's
    prediction space (with the trainer's prediction_weighting factor when
    configured). On a mesh: this rank's rows, of draws made for the global
    batch."""
    b = batch.shape[0]
    if t is None or epsilon is None:
        t_draw, eps_draw = draw(cfg, batch, generator, stride, mesh)
        t = t_draw if t is None else t
        epsilon = eps_draw if epsilon is None else epsilon
    t = torch.as_tensor(t).to(device=batch.device, dtype=torch.float32).reshape(b, 1, 1, 1)
    epsilon = torch.as_tensor(epsilon, dtype=batch.dtype).to(batch.device)
    z_t = diffusion.forward_diffuse(cfg, batch, epsilon, t)

    x_target = distill_target(cfg, teacher, z_t, t, stride, class_idx)
    target = x_to_prediction(cfg, x_target, z_t, t)
    pred = _call(cfg, student, z_t, t[:, 0, 0, 0].to(torch.int32), class_idx)
    if cfg.prediction_weighting and cfg.parameterization in ("epsilon", "scaled_epsilon"):
        w = (1 - alpha_dash(t, cfg.steps, cfg.schedule)) ** 0.5
        target, pred = target * w, pred * w
    return trainer_lib.compute_loss(cfg, target, pred)


def distill_opt_config(cfg, steps: int):
    """The round's optimizer schedule (distill.py:179-207): the checkpoint's
    optimizer and base LR, round-sized — warmup capped at a tenth of the
    round's APPLIED updates (``steps // grad_accum``), a constant LR after
    the ramp, and the EMA horizon capped to ~10% of the round (floored at
    0.5, so a state with an EMA keeps one)."""
    applied = max(steps // max(cfg.grad_accum, 1), 1)
    ema = cfg.ema_decay
    if ema > 0:
        ema = max(min(ema, 1.0 - 10.0 / max(applied, 11)), 0.5)
    return cfg.replace(
        warm_up=min(cfg.warm_up, max(applied // 10, 1)),
        lr_schedule="warmup",  # linear ramp then constant at base LR
        ema_decay=ema,
    )


def make_distill_step(cfg, stride: int, mesh=None):
    """``step(state, teacher, batch, generator, *, t=None, epsilon=None) ->
    (state, loss)``: one distillation step (distill.py:210-230). ``state``
    is a ``trainer.TrainState`` over the student (updated in place);
    uint8 batches run the on-device augment first, as the train step does;
    the update is the optax-form optimizer's, then the EMA blend gated as in
    ``trainer.ema_update``. The loss is a float32 tensor (no host sync).

    ``mesh``: the step over the ranks of a process group (distill.py:233,
    ``make_parallel_distill_step``): ``batch`` (and an injected ``t`` and
    ``epsilon``) are this rank's rows of the global batch, the gradients
    and the loss are averaged over the ranks, and the loss returned is the
    global batch's."""
    _validate(cfg, stride)
    optimizer = trainer_lib.make_optimizer(cfg)
    if mesh is not None and mesh.size <= 1:
        mesh = None
    zero1 = bool(cfg.zero1) and mesh is not None

    def step(state, teacher, batch, generator, *, t=None, epsilon=None):
        batch = trainer_lib.fold_and_augment(cfg, batch, generator, mesh)
        label = None
        if isinstance(batch, dict):
            label = batch.get("label")
            batch = batch["image"]
        params = list(state.model.parameters())
        with unet.ieee_fp32(torch.float32, batch.device):
            loss = distill_loss(cfg, state.model, teacher, batch, generator, stride,
                                class_idx=label, t=t, epsilon=epsilon, mesh=mesh)
            grads = torch.autograd.grad(loss, params)
        grads, (loss,) = trainer_lib.average_over_ranks(mesh, grads, [loss.detach()])
        opt_state = trainer_lib.update_params(optimizer, state.opt_state, params, grads, mesh,
                                              zero1)
        ema = trainer_lib.ema_update(cfg, state.ema_params, params, opt_state)
        return trainer_lib.TrainState(state.step + 1, state.model, opt_state, ema,
                                      state.scale_state), loss

    return step


def init_student(cfg, teacher, mesh=None) -> trainer_lib.TrainState:
    """A round's state: the student a trainable copy of the teacher, a fresh
    optimizer state over it (of ``cfg``, the round's optimizer config) and
    an EMA copy when ``cfg.ema_decay > 0``; on a mesh of more than one rank
    under ``cfg.zero1``, the optimizer state sliced as ``state_shardings``
    splits it."""
    student = copy.deepcopy(teacher).requires_grad_(True)
    params = list(student.parameters())
    ema = [p.detach().clone() for p in params] if cfg.ema_decay > 0 else None
    state = trainer_lib.TrainState(0, student, trainer_lib.make_optimizer(cfg).init(params), ema)
    if cfg.zero1 and mesh is not None and mesh.size > 1:
        state = mesh_lib.shard_state(state, mesh_lib.state_shardings(state, mesh, True), mesh)
    return state


def distill_round(cfg, teacher, data_iter, stride: int, steps: int,
                  generator: torch.Generator, log=print, on_loss=None, mesh=None):
    """One halving round: a student initialised from ``teacher`` (left
    untouched: its calls run without gradient), trained ``steps`` optimizer
    steps to stride ``stride`` on the round-sized schedule of
    :func:`distill_opt_config`. Returns (student module, final loss): the
    EMA weights when ``cfg.ema_decay > 0``.

    ``mesh``: the process group's mesh (``parallel/mesh.make_mesh``);
    ``data_iter`` then yields this rank's rows of each global batch and
    ``generator`` is alike on every rank (``make_distill_step``). A mesh of
    another kind (a ``LocalMesh``, a list of devices) is refused."""
    if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(
            f"distill_round(mesh={mesh!r}): distillation runs over the ranks of a process "
            "group (parallel/mesh.make_mesh()); in-process replicas (make_mesh(devices=...)) "
            "only serve")
    opt_cfg = distill_opt_config(cfg, steps)
    state = init_student(opt_cfg, teacher, mesh)
    step_fn = make_distill_step(opt_cfg, stride, mesh)
    loss = float("nan")
    sync_every = getattr(cfg, "host_sync_every", 0) or steps
    for i in range(steps):
        batch = next(data_iter)
        state, loss_dev = step_fn(state, teacher, batch, generator)
        if i % max(steps // 5, 1) == 0 or i == steps - 1:
            loss = float(loss_dev)  # synchronising fetch
            log(f"  distill stride {stride}: step {i + 1}/{steps} loss={loss:.6f}")
            if on_loss is not None:
                on_loss(stride, i + 1, loss)
        elif (i + 1) % sync_every == 0:
            float(loss_dev)  # bounded in-flight work (Config.host_sync_every)
    return trainer_lib.eval_model(state).requires_grad_(False), loss


def progressive_distill(cfg, teacher, data_iter, target_stride: int, steps_per_round: int,
                        generator: Optional[torch.Generator] = None, log=print,
                        on_loss=None, mesh=None):
    """Full schedule: the stride doubles each round from 2·sample_stride to
    ``target_stride``; each round's student becomes the next teacher.
    Returns (student module, final stride). ``generator`` defaults to one on
    the teacher's device seeded ``cfg.seed + 101``."""
    if generator is None:
        dev = next(teacher.parameters()).device
        generator = torch.Generator(device=dev).manual_seed(cfg.seed + 101)
    stride = max(cfg.sample_stride, 1)
    if target_stride < stride or (target_stride % stride) != 0 or (
        target_stride // stride
    ) & (target_stride // stride - 1):
        raise ValueError(
            f"target stride {target_stride} is not reachable by doubling "
            f"from the teacher's sample_stride {stride} "
            "(must be stride · 2^k)"
        )
    if target_stride > cfg.steps:
        raise ValueError(f"target stride {target_stride} exceeds steps T={cfg.steps}")
    model = teacher
    while stride < target_stride:
        stride *= 2
        log(f"distillation round -> stride {stride}")
        model, _ = distill_round(cfg, model, data_iter, stride, steps_per_round, generator,
                                 log=log, on_loss=on_loss, mesh=mesh)
    return model, stride
