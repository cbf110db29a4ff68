"""GAN-mode training: cycle-consistent class transfer with two generator /
discriminator pairs — counterpart of gan_class_transfer2_tpu/train/gan.py.

  * G_AB, G_BA — U-Net generators (``models/unet.Denoiser`` with three
    output channels);
  * D_A, D_B — strided-conv discriminators (``models/discriminator``);
  * one step computes G's gradients with D held constant, then D's on
    detached fakes, both from the parameters as they were before the step,
    and only then applies the two updates (gan.py:251-266).

Loss menu (``cfg.gan_loss``): non-saturating BCE, LSGAN, hinge; plus the
cycle L1 ‖G_BA(G_AB(a)) − a‖₁, the identity L1 ‖G_AB(b) − b‖₁ and an
optional reconstruction L1, with the cycle and identity weights optionally
annealed (``loss_anneal_steps``); optional R1 penalty on D's real inputs;
DiffAugment on every D input.

What differs from the JAX package, and why:

  * PyTorch runs eagerly: the parameters live in ``nn.Module``s updated in
    place, and the generator EMAs are modules too (``transfer`` applies
    them). Optimizer states are the port's optax-form transforms
    (``trainer.make_optimizer``) over the flat lists ``g_ab + g_ba`` and
    ``d_a + d_b`` of module parameters; ``utils/weights.py`` carries them
    to and from optax's ``{"ab", "ba"}`` / ``{"a", "b"}`` trees.
  * Gradients come from ``torch.autograd.grad`` over exactly the parameters
    they are for, never ``.backward()``, which would also leave the G loss's
    gradient in D's ``.grad``.
  * The fused Adam kernel (B2) is not on this path, whatever the optimizer:
    the JAX GAN step applies ``optimizer.update`` itself and never calls it.
  * ``jax.random.fold_in(rng, step)`` gives the JAX step fresh draws every
    step; here the caller's ``torch.Generator`` advances with each draw.
  * Data parallelism (``mesh=``, ``parallel/mesh.py``): each class batch
    is this rank's rows; the augment and DiffAugment draws are the global
    batch's, each rank taking its rows; G's and D's gradients and the
    metrics are averaged over the ranks by one ``all_reduce`` after both
    ``autograd.grad`` calls. R1's double backward stays on the rank: the
    mean over the global batch is the mean of the ranks' means, their
    batches being equal.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models import discriminator as d_lib
from ..models import unet
from ..models.api import resolve_device
from ..ops import diffaug
from ..parallel import mesh as mesh_lib
from . import trainer as trainer_lib
from .trainer import make_optimizer


class GANState(NamedTuple):
    step: int
    g_ab: unet.Denoiser
    g_ba: unet.Denoiser
    d_a: d_lib.Discriminator
    d_b: d_lib.Discriminator
    g_opt: Any  # over list(g_ab.parameters()) + list(g_ba.parameters())
    d_opt: Any  # over list(d_a.parameters()) + list(d_b.parameters())
    ema_g_ab: Optional[unet.Denoiser]
    ema_g_ba: Optional[unet.Denoiser]


def _d_optimizer(cfg):
    if cfg.d_learning_rate > 0:
        cfg = cfg.replace(learning_rate=cfg.d_learning_rate)
    return make_optimizer(cfg)


def g_params(state: GANState) -> list:
    return list(state.g_ab.parameters()) + list(state.g_ba.parameters())


def d_params(state: GANState) -> list:
    return list(state.d_a.parameters()) + list(state.d_b.parameters())


def _ema_copy(model):
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema


def init_gan_state(cfg, generator: torch.Generator | None = None, device="cuda") -> GANState:
    """Glorot-initialised G_AB, G_BA, D_A, D_B, drawn in that order from
    ``generator`` (a CPU generator seeded with ``cfg.seed`` by default),
    their optimizer states and the generator EMAs, on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    g_ab = unet.Denoiser(cfg, out_channels=3).reset_parameters(generator).to(dev)
    g_ba = unet.Denoiser(cfg, out_channels=3).reset_parameters(generator).to(dev)
    d_a = d_lib.init_discriminator(cfg, generator, dev)
    d_b = d_lib.init_discriminator(cfg, generator, dev)
    state = GANState(0, g_ab, g_ba, d_a, d_b, None, None, None, None)
    ema = cfg.ema_decay > 0
    return state._replace(
        g_opt=make_optimizer(cfg).init(g_params(state)),
        d_opt=_d_optimizer(cfg).init(d_params(state)),
        ema_g_ab=_ema_copy(g_ab) if ema else None,
        ema_g_ba=_ema_copy(g_ba) if ema else None,
    )


# ------------------------------------------------------------------ losses


def adversarial_loss(cfg, logits, is_real: bool, for_generator: bool):
    logits = logits.float()
    if cfg.gan_loss == "nonsaturating":
        target = torch.ones_like(logits) if is_real else torch.zeros_like(logits)
        return F.binary_cross_entropy_with_logits(logits, target)
    if cfg.gan_loss == "lsgan":
        target = 1.0 if is_real else 0.0
        return torch.mean((logits - target) ** 2)
    if cfg.gan_loss == "hinge":
        if for_generator:
            return -torch.mean(logits)
        if is_real:
            return torch.mean(torch.relu(1.0 - logits))
        return torch.mean(torch.relu(1.0 + logits))
    raise ValueError(f"unknown gan_loss {cfg.gan_loss!r}")


def _l1(a, b):
    return torch.mean(torch.abs(a.float() - b.float()))


def annealed_weight(cfg, base: float, final: float, step: int):
    """The loss weight at optimizer ``step``: a linear ramp base → final over
    ``cfg.loss_anneal_steps``, then held. The Python float ``base`` when the
    anneal is off for this term, a float32 scalar tensor otherwise."""
    if final < 0 or cfg.loss_anneal_steps <= 0:
        return base
    frac = torch.clamp(torch.tensor(float(step)) / float(cfg.loss_anneal_steps), max=1.0)
    return base + (final - base) * frac


def _generate(cfg, model, x):
    return unet.unet_apply(cfg, model, x)


def r1_penalty(cfg, d_model, real, labels=None):
    """E over the batch of ‖∇ₓD(x)‖² (summed over pixels per sample), the
    R1 penalty's raw term; the step scales it by 0.5·r1_weight. The input
    gradient is taken with ``create_graph=True``, so differentiating the
    penalty with respect to D's parameters is a double backward through D:
    B4's backward (cuDNN's conv gradients) and B3's (torch ops) are both
    differentiable again."""
    x = real.detach().requires_grad_(True)
    out = d_lib.discriminator_apply(cfg, d_model, x, labels)
    (g,) = torch.autograd.grad(out.float().sum(), x, create_graph=True)
    return torch.mean(torch.sum(g.float() ** 2, dim=(1, 2, 3)))


# -------------------------------------------------------------------- step


def gan_train_step(cfg, g_optimizer, d_optimizer, state: GANState, batch_a, batch_b,
                   generator: torch.Generator, mesh=None):
    """One G/D update (gan.py:140-299). Updates the four nets' parameters
    and the EMAs in place; returns ``(new_state, metrics)`` with float32
    scalar tensors on the batch's device (no host sync); on a mesh, the
    global batch's."""
    # HBM-resident uint8 batches are cropped, flipped and normalised on the
    # device, each with its own draws, before anything else (gan.py:151-156)
    batch_a = trainer_lib.augment_if_uint8(cfg, batch_a, generator, mesh)
    batch_b = trainer_lib.augment_if_uint8(cfg, batch_b, generator, mesh)

    def aug(x):
        return diffaug.augment(cfg, generator, x, mesh)

    w_cycle = annealed_weight(cfg, cfg.cycle_weight, cfg.cycle_weight_final, state.step)
    w_ident = annealed_weight(cfg, cfg.identity_weight, cfg.identity_weight_final, state.step)
    gp, dp = g_params(state), d_params(state)
    zero = torch.zeros((), dtype=torch.float32, device=batch_a.device)

    def disc(d_model, x):
        return d_lib.discriminator_apply(cfg, d_model, x)

    # IEEE float32 convs from the first forward through both gradient calls
    with unet.ieee_fp32(torch.float32, batch_a.device):
        # ---- G: D enters as a constant of this derivative
        with _constant(dp):
            fake_b = _generate(cfg, state.g_ab, batch_a)
            fake_a = _generate(cfg, state.g_ba, batch_b)
            adv = (adversarial_loss(cfg, disc(state.d_b, aug(fake_b)), True, True)
                   + adversarial_loss(cfg, disc(state.d_a, aug(fake_a)), True, True))
            # zero-weight terms are not computed at all; they report 0
            cycle = (_l1(_generate(cfg, state.g_ba, fake_b), batch_a)
                     + _l1(_generate(cfg, state.g_ab, fake_a), batch_b)
                     if cfg.cycle_term_active else zero)
            ident = (_l1(_generate(cfg, state.g_ab, batch_b), batch_b)
                     + _l1(_generate(cfg, state.g_ba, batch_a), batch_a)
                     if cfg.identity_term_active else zero)
            recon = (_l1(fake_b, batch_a) + _l1(fake_a, batch_b)
                     if cfg.reconstruction_weight > 0 else zero)
            g_loss = (cfg.adversarial_weight * adv + w_cycle * cycle + w_ident * ident
                      + cfg.reconstruction_weight * recon)
            g_grads = torch.autograd.grad(g_loss, gp, materialize_grads=True)

        # ---- D on the detached fakes, from the same (not yet updated) params
        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        real_a, real_b = aug(batch_a), aug(batch_b)
        d_loss = (adversarial_loss(cfg, disc(state.d_a, real_a), True, False)
                  + adversarial_loss(cfg, disc(state.d_a, aug(fake_a)), False, False)
                  + adversarial_loss(cfg, disc(state.d_b, real_b), True, False)
                  + adversarial_loss(cfg, disc(state.d_b, aug(fake_b)), False, False)) * 0.5
        r1 = zero
        if cfg.r1_weight > 0:
            # at D's actual input, the augmented reals (augmented R1)
            r1 = r1_penalty(cfg, state.d_a, real_a) + r1_penalty(cfg, state.d_b, real_b)
            d_loss = d_loss + 0.5 * cfg.r1_weight * r1
        d_grads = torch.autograd.grad(d_loss, dp, materialize_grads=True)

    metrics = {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
               "adversarial": adv.detach(), "cycle": cycle.detach(),
               "identity": ident.detach()}
    if cfg.r1_weight > 0:
        metrics["r1"] = r1.detach()
    g_opt, d_opt, metrics = _update_both(cfg, g_optimizer, d_optimizer, state, gp, dp, g_grads,
                                         d_grads, metrics, mesh)
    _ema_step(cfg, state.ema_g_ab, state.g_ab, g_opt)
    _ema_step(cfg, state.ema_g_ba, state.g_ba, g_opt)
    if cfg.loss_anneal_steps > 0:
        # the current effective weights, so the anneal is visible
        metrics["cycle_weight"] = torch.as_tensor(w_cycle, dtype=torch.float32)
        metrics["identity_weight"] = torch.as_tensor(w_ident, dtype=torch.float32)
    return state._replace(step=state.step + 1, g_opt=g_opt, d_opt=d_opt), metrics


def _update_both(cfg, g_optimizer, d_optimizer, state, gp, dp, g_grads, d_grads, metrics,
                 mesh=None):
    """G's and D's updates, from gradients of the pre-step parameters,
    after one ``all_reduce`` of both gradients and the metrics on a mesh.
    Returns ``(g_opt, d_opt, metrics)``."""
    ng = len(g_grads)
    grads, values = trainer_lib.average_over_ranks(mesh, [*g_grads, *d_grads],
                                                   list(metrics.values()))
    metrics = dict(zip(metrics, values))
    g_opt = trainer_lib.update_params(g_optimizer, state.g_opt, gp, grads[:ng], mesh, cfg.zero1)
    d_opt = trainer_lib.update_params(d_optimizer, state.d_opt, dp, grads[ng:], mesh, cfg.zero1)
    return g_opt, d_opt, metrics


@contextlib.contextmanager
def _constant(params):
    """Hold ``params`` out of autograd for the block: the G loss's graph
    then records nothing for D's weights (no weight gradients computed)."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@torch.no_grad()
def _ema_step(cfg, ema_model, model, opt_state):
    """trainer.ema_update (gated on G's optimizer state), written into the
    EMA module in place."""
    if ema_model is None:
        return
    ema = list(ema_model.parameters())
    for e, new in zip(ema, trainer_lib.ema_update(cfg, ema, list(model.parameters()), opt_state)):
        if new is not e:
            e.copy_(new)


def make_gan_train_step(cfg):
    """``step(state, batch_a, batch_b, generator) -> (state, metrics)``."""
    g_opt = make_optimizer(cfg)
    d_opt = _d_optimizer(cfg)

    def step(state, batch_a, batch_b, generator):
        return gan_train_step(cfg, g_opt, d_opt, state, batch_a, batch_b, generator)

    return step


def select_generator(state: GANState, direction: str = "ab", use_ema: bool = True):
    """The generator module for a transfer direction (its EMA when kept)."""
    if direction not in ("ab", "ba"):
        raise ValueError(f"direction must be 'ab' or 'ba', got {direction!r}")
    if direction == "ab":
        return state.ema_g_ab if (use_ema and state.ema_g_ab is not None) else state.g_ab
    return state.ema_g_ba if (use_ema and state.ema_g_ba is not None) else state.g_ba


def make_transfer_fn(cfg, mesh=None):
    """``(generator_module, images) -> transferred`` under inference mode, on
    the images' device; on a mesh of more than one rank the images are
    split over the ranks and the result gathered, and on a serving
    ``LocalMesh`` over its replicas, the generator then being
    ``mesh.replicate``'s list (``parallel/mesh.make_data_parallel_apply``)."""
    from ..parallel import mesh as mesh_lib

    @torch.inference_mode()
    def fn(model, images):
        return _generate(cfg, model, images)

    return mesh_lib.make_data_parallel_apply(mesh, fn)


def transfer(cfg, state: GANState, images, direction: str = "ab", use_ema: bool = True):
    """Apply the learned class transfer to a batch of images."""
    return _generate(cfg, select_generator(state, direction, use_ema), images)
