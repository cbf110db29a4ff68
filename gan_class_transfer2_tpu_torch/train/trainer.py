"""The diffusion training step — counterpart of
gan_class_transfer2_tpu/train/trainer.py (reference train.py:217-280).

One step: draw ``t ~ U[1, T]`` per sample and ``ε ~ N(0, 1)`` (or, on the
``x`` path, let the fused diffusion kernel B1 draw ε itself), noise the batch,
predict, take the float32 loss, differentiate, apply the optimizer (the fused
Adam kernel B2 under ``optimizer="adam_fused"``) and blend the EMA.

What differs from the JAX package, and why:

  * PyTorch runs eagerly, so nothing is jitted or donated. The model's
    parameters are updated in place (no second copy of 41.7 M floats);
    optimizer states are new tensors each step, so that dynamic loss scaling
    can keep the old ones when it skips an update.
  * ``jax.random`` keys become a ``torch.Generator``. Draws are made on the
    generator's device and moved to the batch's: a generator on the batch's
    device is the rule (``make_train_step``), and a CPU generator makes a
    card run draw what a CPU run draws.
  * The optimizers are plain functions on lists of tensors, one per
    parameter in ``model.parameters()`` order, in optax's form: the
    ``GradientTransformation``s below mirror optax's ``adam``,
    ``scale_by_learning_rate``, ``sgd``, ``rmsprop``, ``clip_by_global_norm``,
    ``add_decayed_weights`` and ``MultiSteps``, with state ``NamedTuple``s of
    the same names and fields, so a state carries to and from optax
    (utils/weights.py). ``torch.optim`` is not used: its RMSprop has α = 0.99
    and ε outside the square root where optax has 0.9 and ε inside, its
    ``clip_grad_norm_`` adds 1e-6 to the norm, and its Adam is optax's form,
    not the Keras form of ``adam_tf``.
  * Counts that only depend on the step number (``MultiSteps``' mini-steps)
    are Python ints; counts that dynamic loss scaling may hold back (Adam's,
    the schedule's) are int32 tensors on the parameters' device, so a step
    never waits for the card.
  * Data parallelism (``mesh=``, built by ``parallel/mesh.py``): the batch
    is this rank's rows of the global batch; t, ε and the augment's
    parameters are drawn for the global batch and the rank takes its rows
    (trainer.py:283-284 draws over the global shape), the fused path runs
    B1s with the rank's position, and the gradients and the loss are
    averaged over the data extent by one ``all_reduce`` before the update
    (and before the non-finite test). Under tensor parallelism the model
    holds this rank's kernel slices and its convs gather their output
    channels (``parallel/tensor``), so the prediction and the loss are
    whole on every rank. The update runs on the rank's parts under
    ``cfg.zero1`` or tensor parallelism (``update_params``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core import diffusion
from ..core.schedule import make_lr_schedule
from ..data import device_augment
from ..models import api as model_api
from ..models import unet
from ..ops import adam_kernel, fused_diffusion
from ..ops import image as image_ops
from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from ..utils import profiler


class ScaleState(NamedTuple):
    """Dynamic loss-scaling state (TF LossScaleOptimizer semantics,
    reference train.py:82-83): halve on non-finite grads and skip the
    update; double after ``growth_interval`` consecutive finite steps."""

    scale: torch.Tensor  # float32 scalar
    good_steps: torch.Tensor  # int32 scalar


class TrainState(NamedTuple):
    step: int
    model: Any  # unet.Denoiser or ConditionalDenoiser, updated in place by the step
    opt_state: Any
    ema_params: Optional[list]  # one tensor per parameter, or None
    scale_state: Optional[ScaleState] = None


# ------------------------------------------------------------- optimizers


class GradientTransformation(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (updates, state, params) -> (updates, state)


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: list
    nu: list


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: list


class ScaleByRmsState(NamedTuple):
    nu: list


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: list
    skip_state: tuple = ()


def _count0(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _zeros(params, dtype=None):
    return [torch.zeros_like(p, dtype=dtype) for p in params]


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(), lambda u, s, params=None: (u, s))


def chain(*txs) -> GradientTransformation:
    """optax.chain: the updates pass through each transform in turn."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def scale_by_schedule(step_size_fn) -> GradientTransformation:
    def update(updates, state, params=None):
        step_size = step_size_fn(state.count)
        updates = list(torch._foreach_mul(updates, step_size.to(updates[0].dtype)))
        return updates, ScaleByScheduleState(state.count + 1)

    return GradientTransformation(lambda params: ScaleByScheduleState(_count0(params)), update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    return scale_by_schedule(lambda count: -1 * lr(count))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_adam: bias-corrected moments, eps after √ν̂. Each
    operation runs over every leaf at once (``torch._foreach_*``: a few
    launches a step in place of a dozen a leaf, which a GAN step's ~110
    leaves made its host's largest phase), the same operations in the same
    order as a leaf at a time, so the same bits."""

    def init(params):
        return ScaleByAdamState(_count0(params), _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        mu = list(torch._foreach_add(torch._foreach_mul(updates, 1 - b1),
                                     torch._foreach_mul(state.mu, b1)))
        nu = list(torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(updates, updates), 1 - b2),
            torch._foreach_mul(state.nu, b2)))
        count = state.count + 1
        t = count.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        den = torch._foreach_div(nu, bc2.to(nu[0].dtype))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        out = list(torch._foreach_div(mu, bc1.to(mu[0].dtype)))
        torch._foreach_div_(out, den)
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_adam_tf(b1=0.9, b2=0.999, eps=1e-7, moment_dtype=None) -> GradientTransformation:
    """Keras/TF Adam (trainer.py:77-141): eps after √v, not √v̂, with the bias
    correction folded into ``α = √(1−β₂ᵗ)/(1−β₁ᵗ)``; math in float32 whatever
    the moments' storage dtype."""

    def init(params):
        return ScaleByAdamState(_count0(params), _zeros(params, moment_dtype),
                                _zeros(params, moment_dtype))

    def update(updates, state, params=None):
        count = state.count + 1
        t = count.to(torch.float32)
        f32 = torch.float32
        mu32 = [b1 * m.to(f32) + (1.0 - b1) * g.to(f32) for m, g in zip(state.mu, updates)]
        nu32 = [b2 * v.to(f32) + (1.0 - b2) * torch.square(g.to(f32))
                for v, g in zip(state.nu, updates)]
        alpha = torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
        out = [(alpha * m / (torch.sqrt(v) + eps)).to(g.dtype)
               for m, v, g in zip(mu32, nu32, updates)]
        mu = [m.to(o.dtype) for m, o in zip(mu32, state.mu)]
        nu = [v.to(o.dtype) for v, o in zip(nu32, state.nu)]
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace: ``t' = g + decay·t``; Nesterov returns ``g + decay·t'``."""

    def update(updates, state, params=None):
        new = [g + decay * t for g, t in zip(updates, state.trace)]
        out = [g + decay * t for g, t in zip(updates, new)] if nesterov else new
        return out, TraceState(new)

    return GradientTransformation(lambda params: TraceState(_zeros(params)), update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_rms as optax.rmsprop uses it: no bias correction,
    eps inside the square root: ``g·rsqrt(ν + eps)``."""

    def update(updates, state, params=None):
        nu = [(1 - decay) * g**2 + decay * v for g, v in zip(updates, state.nu)]
        return [torch.rsqrt(v + eps) * g for v, g in zip(nu, updates)], ScaleByRmsState(nu)

    return GradientTransformation(lambda params: ScaleByRmsState(_zeros(params)), update)


def sign() -> GradientTransformation:
    """Per-variable sign(g) (reference train.py:47-48)."""
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda u, s, params=None: ([torch.sign(g) for g in u], s))


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda u, s, params: ([g + weight_decay * p for g, p in zip(u, params)], s))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: scale by ``max_norm/‖g‖`` only when
    ``‖g‖ >= max_norm`` (no epsilon in the norm). On ZeRO-1 slices
    (``params`` a ``parallel/mesh.RankSlices``) the norm is the full
    gradient's, summed over the ranks."""

    def update(updates, state, params=None):
        if hasattr(params, "global_sum"):
            g_norm = torch.sqrt(params.global_sum([torch.sum(g * g) for g in updates]))
        else:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in updates))
        trigger = g_norm < max_norm
        return [torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
                for g in updates], state

    return GradientTransformation(lambda params: EmptyState(), update)


def sgd(lr, momentum: Optional[float] = None, nesterov: bool = False):
    first = trace(momentum, nesterov) if momentum is not None else identity()
    return chain(first, scale_by_learning_rate(lr))


def multi_steps(tx: GradientTransformation, every_k: int) -> GradientTransformation:
    """optax.MultiSteps with ``use_grad_mean``: the running mean of ``every_k``
    gradients reaches the inner optimizer on the k-th mini-step; the other
    mini-steps return zero updates and leave the inner state (and so the
    learning-rate count) where it was."""

    def init(params):
        return MultiStepsState(0, 0, tx.init(params), _zeros(params))

    def update(updates, state, params=None):
        n, step, inner = state.mini_step, state.gradient_step, state.inner_opt_state
        acc = [a + (g - a) / (n + 1) for g, a in zip(updates, state.acc_grads)]
        if n == every_k - 1:
            out, inner = tx.update(acc, inner, params)
            acc, step = [torch.zeros_like(a) for a in acc], step + 1
        else:
            out = [torch.zeros_like(g) for g in updates]
        return out, MultiStepsState((n + 1) % every_k, step, inner, acc, state.skip_state)

    return GradientTransformation(init, update)


def make_optimizer(cfg) -> GradientTransformation:
    """The menu of trainer.py:144-189, transform for transform, Adam's β₁
    from ``cfg.adam_b1`` (0.9, the reference's, by default). Weight decay
    comes before the clip: the reference's l2 runs through its regularizers,
    so its gradient term is part of the clipped total."""
    lr = make_lr_schedule(cfg)
    txs = []
    if cfg.weight_decay > 0:
        txs.append(add_decayed_weights(2.0 * cfg.weight_decay))
    if cfg.grad_clip_norm > 0:
        txs.append(clip_by_global_norm(cfg.grad_clip_norm))
    if cfg.optimizer == "adam":
        txs.append(chain(scale_by_adam(b1=cfg.adam_b1, eps=cfg.adam_eps),
                         scale_by_learning_rate(lr)))
    elif cfg.optimizer in ("adam_tf", "adam_fused"):
        # adam_fused shares this state and math; train_step takes the fused
        # kernel B2 when adam_kernel.fused_adam_ok(cfg)
        moment_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None
        txs.append(scale_by_adam_tf(b1=cfg.adam_b1, eps=cfg.adam_eps,
                                    moment_dtype=moment_dtype))
        txs.append(scale_by_learning_rate(lr))
    elif cfg.optimizer == "sgd":
        txs.append(sgd(lr))
    elif cfg.optimizer == "momentum":
        txs.append(sgd(lr, momentum=cfg.momentum, nesterov=cfg.nesterov))
    elif cfg.optimizer == "sign_sgd":
        txs.append(sign())
        txs.append(sgd(lr))
    elif cfg.optimizer == "rmsprop":
        txs.append(chain(scale_by_rms(), scale_by_learning_rate(lr), identity()))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    tx = chain(*txs)
    if cfg.grad_accum > 1:
        tx = multi_steps(tx, cfg.grad_accum)
    return tx


@torch.no_grad()
def apply_updates(params, updates):
    """optax.apply_updates, in place: ``p ← p + u`` in p's dtype, over every
    leaf at once."""
    torch._foreach_add_(list(params), [u.to(p.dtype) for p, u in zip(params, updates)])


# ------------------------------------------------------------------ state


def init_state(cfg, generator: torch.Generator | None = None, device="cuda") -> TrainState:
    """Glorot-initialised model (draws from ``generator``, a CPU generator
    seeded with ``cfg.seed`` by default), optimizer state, EMA copy and
    loss-scale state, on ``device``."""
    model = model_api.init_denoiser(cfg, generator, device=device)
    params = list(model.parameters())
    opt_state = make_optimizer(cfg).init(params)
    ema = [p.detach().clone() for p in params] if cfg.ema_decay > 0 else None
    scale_state = None
    if cfg.dynamic_loss_scale:
        init_scale = cfg.loss_scale if cfg.loss_scale > 0 else 2.0**15
        dev = params[0].device
        scale_state = ScaleState(torch.tensor(init_scale, dtype=torch.float32, device=dev),
                                 torch.zeros((), dtype=torch.int32, device=dev))
    return TrainState(0, model, opt_state, ema, scale_state)


# ------------------------------------------------------------------- loss


def compute_loss(cfg, target, prediction):
    """Loss in float32 (reference train.py:262-272 and alternatives)."""
    target = target.to(torch.float32)
    prediction = prediction.to(torch.float32)
    if cfg.loss == "mse":
        return torch.mean(torch.square(target - prediction))
    if cfg.loss == "l1":
        # reference train.py:267-270 (max formulation)
        return torch.mean(torch.maximum(target - prediction, prediction - target))
    if cfg.loss == "dct":
        return torch.mean(image_ops.dct2d_weighted(target - prediction) ** 2)
    if cfg.loss == "mse_multiscale":
        return torch.mean(torch.square(target - prediction)) + torch.mean(
            torch.square(image_ops.avg_pool(target, 16) - image_ops.avg_pool(prediction, 16)))
    raise ValueError(f"unknown loss {cfg.loss!r}")


def draw_and_diffuse(cfg, batch, generator, *, t_int=None, epsilon_in=None, mesh=None):
    """The (t, ε) draws, forward diffusion and target of ``diffusion_loss``
    (trainer.py:272-322). ``t_int``/``epsilon_in`` inject the draws (the
    step-parity harness; on a mesh, this rank's rows). Returns ``(noised,
    target, prediction_scale, t_int)`` with ``t_int`` (B, 1, 1, 1) int32 on
    the batch's device. On the fused path the draws of t and of B1's seed
    and B1 itself are the only launches: B1 gathers its scales by t. On a
    mesh of more than one rank the draws are the global batch's and the
    fused path is B1s at the rank's position, when ``fused_sharded_ok``
    (trainer.py:288-311). The position is the data coordinate: JAX folds
    only the batch spec's axes (kernels.py:247-259), so the model ranks of
    a data group draw the same ε."""
    b, dev = batch.shape[0], batch.device
    n = mesh_lib.global_rows(b, mesh)
    if t_int is None:
        t_int = mesh_lib.local_rows(torch.randint(
            1, cfg.steps + 1, (n, 1, 1, 1), generator=generator, device=generator.device,
            dtype=torch.int32), mesh).to(dev)
    else:
        t_int = torch.as_tensor(t_int, dtype=torch.int32).reshape(b, 1, 1, 1).to(dev)
    fused = fused_diffusion.use_fused(cfg, batch.shape, epsilon_in)
    sharded = mesh is not None and mesh.size > 1
    if fused and sharded:
        fused = fused_diffusion.fused_sharded_ok(cfg, (n, *batch.shape[1:]),
                                                 mesh_lib.data_axis_size(mesh), ("data",))
    if fused:
        seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device,
                             dtype=torch.int64).to(dev)
        if sharded:
            noised = fused_diffusion.forward_diffuse_fused_sharded(cfg, batch, t_int, seed,
                                                                   mesh.data_index)
        else:
            noised = fused_diffusion.forward_diffuse_fused(cfg, batch, t_int, seed)
        epsilon, t = None, None  # ε never materialised; the x target needs no ᾱ(t)
    else:
        t = t_int.to(batch.dtype)
        if epsilon_in is None:
            epsilon = mesh_lib.local_rows(torch.randn(
                (n, *batch.shape[1:]), generator=generator, device=generator.device,
                dtype=batch.dtype), mesh).to(dev)
        else:
            epsilon = torch.as_tensor(epsilon_in, dtype=batch.dtype).to(dev)
        noised = diffusion.forward_diffuse(cfg, batch, epsilon, t)
    target, pred_scale = diffusion.training_target(cfg, batch, epsilon, t)
    return noised, target, pred_scale, t_int


def _image(batch):
    """The image tensor of a batch, or of a dict (labeled) batch."""
    return batch["image"] if isinstance(batch, dict) else batch


def diffusion_loss(cfg, model, batch, generator, *, t_int=None, epsilon_in=None, mesh=None):
    """Draw (t, ε), noise the batch, predict, and take the loss. A dict
    batch ``{"image", "label"}`` (class-conditional training) passes its
    label to the model as ``class_idx`` (trainer.py:244-266)."""
    label = None
    if isinstance(batch, dict):
        label = batch.get("label")
        batch = batch["image"]
    noised, target, pred_scale, t_int = draw_and_diffuse(
        cfg, batch, generator, t_int=t_int, epsilon_in=epsilon_in, mesh=mesh)
    prediction = model_api.apply_denoiser(cfg, model, noised, t_int[:, 0, 0, 0],
                                          class_idx=label)
    prediction = prediction.to(torch.float32) * pred_scale
    return compute_loss(cfg, target, prediction)


def augment_if_uint8(cfg, batch, generator, mesh=None):
    """The on-device crop / flip / normalise of uint8 (HBM-resident raw
    pixel) batches, ``data/device_augment.augment_batch`` at ``cfg.size``,
    drawing from ``generator`` (for the global batch on a mesh); dict
    (labeled) batches keep their other entries; float batches pass through
    untouched and draw nothing (trainer.py:343-357)."""
    raw = _image(batch)
    if raw.dtype != torch.uint8:
        return batch
    augmented = device_augment.augment_batch(raw, generator, cfg.size, mesh)
    if isinstance(batch, dict):
        return dict(batch, image=augmented)
    return augmented


def fold_and_augment(cfg, batch, generator, mesh=None):
    """The step's augment (trainer.py:325-340): a uint8 batch is cropped,
    flipped and normalised before t and ε are drawn, outside the
    differentiated region. JAX folds the step number into its key here; the
    port's generator advances with every draw instead."""
    with profiler.annotate("train.augment"):
        return augment_if_uint8(cfg, batch, generator, mesh)


def loss_and_grads(cfg, model, batch, generator, scale=None, *, t_int=None, epsilon_in=None,
                   mesh=None):
    """The differentiated part of the step: ``(loss, grads)`` for
    ``model.parameters()``, the loss multiplied by ``scale`` when given (the
    grads then too). float32 convs and matmuls stay IEEE float32 from the
    forward through the backward (``unet.ieee_fp32``): cuDNN would otherwise
    compute the weight and input gradients in TF32. On a mesh, batch norms
    take the statistics of the global batch (``mesh.norm_stats``)."""
    params = list(model.parameters())
    with unet.ieee_fp32(torch.float32, _image(batch).device), mesh_lib.norm_stats(mesh):
        with profiler.annotate("train.forward"):
            loss = diffusion_loss(cfg, model, batch, generator, t_int=t_int,
                                  epsilon_in=epsilon_in, mesh=mesh)
            if scale is not None:
                loss = loss * scale
        with profiler.annotate("train.backward"):
            grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads)


def _select(pred, new, old):
    """``jnp.where(pred, new, old)`` over a state tree."""
    if isinstance(new, torch.Tensor):
        return torch.where(pred, new, old)
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(pred, n, o) for n, o in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(_select(pred, n, o) for n, o in zip(new, old))
    return new


def average_over_ranks(mesh, grads, metrics):
    """``(grads, metrics)`` averaged over the batch axis of ``mesh`` (the
    ranks of this rank's model coordinate) by one ``all_reduce``: the
    gradient and the metrics of the global batch (each data group's batch
    is an equal share of it). Never over a model group: there the
    gradients of whole leaves are alike and those of split kernels are each
    rank's own. As they are in one process."""
    if mesh is None or mesh.size == 1:
        return list(grads), metrics
    values = multihost.all_reduce_mean([*grads, *metrics], mesh.axis("batch"))
    return values[:len(grads)], values[len(grads):]


@torch.no_grad()
def update_params(optimizer, opt_state, params, grads, mesh=None, zero1: bool = False,
                  finite=None):
    """``optimizer.update`` and its in-place apply (only where ``finite``,
    when given); under ``zero1`` or tensor parallelism on a mesh of more
    than one rank, on this rank's parts (``parallel/mesh.sharded_update``;
    ``params`` then a ``mesh.Params``, which knows the split kernels).
    Returns the new optimizer state."""
    if mesh_lib.needs_sharded_update(mesh, zero1):
        return mesh_lib.sharded_update(optimizer, opt_state, params, grads, mesh, zero1, finite)
    updates, new_state = optimizer.update(grads, opt_state, params)
    if finite is None:
        apply_updates(params, updates)
    else:
        for p, u in zip(params, updates):
            p.copy_(torch.where(finite, p + u.to(p.dtype), p))
    return new_state


def _apply(cfg, optimizer, state, params, grads, mesh=None):
    """The update without loss scaling: B2 when ``fused_adam_ok`` (never on
    a mesh of more than one rank), else the optax-form optimizer. Returns
    the new optimizer state."""
    if adam_kernel.fused_adam_ok(cfg, mesh.size if mesh is not None else 1):
        grads = [g.contiguous() for g in grads]
        return adam_kernel.fused_adam_apply(cfg, params, state.opt_state, grads)
    return update_params(optimizer, state.opt_state, params, grads, mesh, cfg.zero1)


def train_step(cfg, optimizer, state: TrainState, batch, generator, mesh=None):
    """One optimizer step (trainer.py:360-442). Updates the model's
    parameters in place; returns ``(new_state, loss)`` with the loss a
    float32 tensor on the batch's device (no host sync). On a mesh,
    ``batch`` is this rank's rows and the loss the global batch's."""
    with profiler.annotate("train.step", step=True):
        batch = fold_and_augment(cfg, batch, generator, mesh)
        scale = loss_scale(cfg, state)
        params = mesh_lib.params_of(state.model)
        loss, grads = loss_and_grads(cfg, state.model, batch, generator, scale, mesh=mesh)
        grads, (loss,) = average_over_ranks(mesh, grads, [loss])
        with profiler.annotate("train.update"):
            return finish_step(cfg, optimizer, state, params, grads, loss, scale, mesh)


def loss_scale(cfg, state: TrainState):
    """What the step multiplies its loss by: the dynamic scale's tensor,
    the static ``loss_scale``, or None."""
    if cfg.dynamic_loss_scale:
        return state.scale_state.scale
    return cfg.loss_scale if cfg.loss_scale > 0 else None


def finish_step(cfg, optimizer, state: TrainState, params, grads, loss, scale, mesh=None):
    """The step after its gradients (trainer.py:405-442): ``grads`` and
    ``loss`` taken with the loss multiplied by ``scale`` (None, the static
    loss scale, or the dynamic scale's tensor) and already reduced over the
    ranks, so that every rank decides alike. Unscales them; under dynamic
    loss scaling skips the whole update on a non-finite gradient and
    halves the scale, doubles it after ``loss_scale_growth_interval``
    clean steps; applies the update (on the rank's parts on ``mesh``; B2
    only on a mesh of one rank) and the EMA. Returns ``(new_state,
    loss)``."""
    dynamic = cfg.dynamic_loss_scale
    if scale is not None:
        inv = 1.0 / scale
        loss = loss * inv
        grads = [g * inv for g in grads]

    scale_state, finite = state.scale_state, None
    if dynamic:
        # skip the whole update on any non-finite gradient and halve the
        # scale; double it after growth_interval clean steps (train.py:82-83)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if mesh_lib.model_axis_size(mesh) > 1:  # split kernels: every part finite
            bad = multihost.all_reduce_sum((~finite).to(torch.float32), mesh.axis("model"))
            finite = bad == 0
        new_opt = update_params(optimizer, state.opt_state, params, grads, mesh, cfg.zero1,
                                finite)
        opt_state = _select(finite, new_opt, state.opt_state)
        s, good = scale_state.scale, scale_state.good_steps + 1
        grow = finite & (good >= cfg.loss_scale_growth_interval)
        new_scale = torch.where(finite, torch.where(grow, s * 2.0, s),
                                torch.clamp(s * 0.5, min=1.0))
        new_good = torch.where(finite & ~grow, good, torch.zeros_like(good))
        scale_state = ScaleState(new_scale, new_good)
    else:
        opt_state = _apply(cfg, optimizer, state, params, grads, mesh)
    ema = ema_update(cfg, state.ema_params, params, opt_state, finite=finite)
    return TrainState(state.step + 1, state.model, opt_state, ema, scale_state), loss


@torch.no_grad()
def ema_update(cfg, ema, params, opt_state, finite=None):
    """EMA blend gated on an applied update (trainer.py:445-469): under
    grad_accum only when the accumulation window closed, under dynamic loss
    scaling only on finite steps; a skipped step leaves the EMA as it was."""
    if ema is None:
        return None
    d = cfg.ema_decay
    if cfg.grad_accum > 1 and opt_state.mini_step != 0:
        return ema
    blended = [e * d + p * (1.0 - d) for e, p in zip(ema, params)]
    if finite is None:
        return blended
    return [torch.where(finite, b, e) for b, e in zip(blended, ema)]


@torch.no_grad()
def eval_model(state: TrainState, out=None):
    """The weights to sample from (the JAX CLI's ``ema_params if not None
    else params``): ``state.model`` itself without an EMA; with one,
    ``out`` (a copy of the model when None) holding the EMA values."""
    if state.ema_params is None:
        return state.model
    if out is None:
        out = copy.deepcopy(state.model).requires_grad_(False)
    for p, e in zip(out.parameters(), state.ema_params):
        p.copy_(e)
    return out


def make_train_step(cfg):
    """``step(state, batch, generator) -> (state, loss)``."""
    optimizer = make_optimizer(cfg)

    def step(state, batch, generator):
        return train_step(cfg, optimizer, state, batch, generator)

    return step


def make_injected_train_step(cfg, mesh=None):
    """``step(state, batch, t_int, epsilon) -> (state, loss)`` with the draws
    supplied by the caller (trainer.py:472-503): no augmentation, loss
    scaling or EMA. The update is applied as ``train_step`` applies it, so
    under ``adam_fused`` it goes through B2 (in one process). On a mesh the
    batch, t and ε are this rank's rows, and the gradients and the loss
    are averaged over the ranks."""
    optimizer = make_optimizer(cfg)

    def step(state, batch, t_int, epsilon):
        loss, grads = loss_and_grads(cfg, state.model, batch, None, t_int=t_int,
                                     epsilon_in=epsilon, mesh=mesh)
        grads, (loss,) = average_over_ranks(mesh, grads, [loss])
        params = mesh_lib.params_of(state.model)
        opt_state = _apply(cfg, optimizer, state, params, grads, mesh)
        return state._replace(step=state.step + 1, opt_state=opt_state), loss

    return step
