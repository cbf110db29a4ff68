"""Multi-class conditional transfer (BASELINE config 5, "multi-class
conditional transfer at 256×256 with cycle/identity losses + EMA sampling")
— counterpart of gan_class_transfer2_tpu/train/conditional_gan.py.

One conditional generator G(x, target class) (models/conditional.py) and
one projection-conditioned discriminator D(x, class)
(models/discriminator.py), StarGAN-style:

  * adversarial: D judges (image, class) pairs — real images with their
    class against generated images with the target class;
  * cycle ``G(G(x, target), source) ≈ x`` and identity ``G(x, source) ≈ x``
    (each elided when its weight is zero: a generator forward fewer);
  * an optional reconstruction ``G(x, target) ≈ x``, and an EMA of G.

Batches arrive as ``{"image": (B, H, W, 3), "label": (B,)}``; each sample's
target class is ``(label + U[1, C − 1]) mod C``, drawn in the step (or
injected through ``targets=``). The step follows train/gan.py's port: G's
gradient with D held constant, D's on the detached fakes, both from the
parameters as they were before the step, then both updates, then the
gated EMA. B3 and B4 run in both nets on the card; B2 is not on this path
(the JAX step applies ``optimizer.update`` itself). On a mesh
(``parallel/mesh.py``) the batch is this rank's rows, the targets, augment
and DiffAugment draws the global batch's, and the gradients and metrics
are averaged over the ranks, as in ``train/gan.py``.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional

import torch

from ..models import conditional as cond_lib
from ..models import discriminator as d_lib
from ..models import unet
from ..models.api import resolve_device
from ..ops import diffaug
from . import trainer as trainer_lib
from ..parallel import mesh as mesh_lib
from .gan import (_constant, _d_optimizer, _ema_step, _l1, _update_both, adversarial_loss,
                  annealed_weight, r1_penalty)
from .trainer import make_optimizer


class ConditionalGANState(NamedTuple):
    step: int
    generator: cond_lib.ConditionalDenoiser
    discriminator: d_lib.Discriminator
    g_opt: Any  # over list(generator.parameters())
    d_opt: Any  # over list(discriminator.parameters())
    ema_generator: Optional[cond_lib.ConditionalDenoiser]


def init_conditional_gan_state(cfg, generator: torch.Generator | None = None,
                               device="cuda") -> ConditionalGANState:
    """Glorot-initialised G and D (with ``cfg.num_classes`` classes), drawn
    in that order from ``generator`` (a CPU generator seeded with
    ``cfg.seed`` by default), their optimizer states and G's EMA, on
    ``device``."""
    if cfg.num_classes < 2:
        raise ValueError("conditional GAN needs Config.num_classes >= 2")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    g = cond_lib.ConditionalDenoiser(cfg, cfg.num_classes, cfg.class_embed_dim)
    g = g.reset_parameters(generator).to(dev)
    d = d_lib.init_discriminator(cfg, generator, dev, num_classes=cfg.num_classes)
    ema = None
    if cfg.ema_decay > 0:
        ema = copy.deepcopy(g).requires_grad_(False)
    return ConditionalGANState(0, g, d, make_optimizer(cfg).init(list(g.parameters())),
                               _d_optimizer(cfg).init(list(d.parameters())), ema)


def _target_classes(cfg, labels, generator, mesh=None):
    """Per-sample target class != source: ``(label + U[1, C−1]) mod C``
    (drawn for the global batch on a mesh, of which ``labels`` are this
    rank's rows)."""
    n = mesh_lib.global_rows(labels.shape[0], mesh)
    shift = mesh_lib.local_rows(torch.randint(1, cfg.num_classes, (n,), generator=generator,
                                              device=generator.device), mesh).to(labels.device)
    return (labels.long() + shift) % cfg.num_classes


def conditional_gan_train_step(cfg, g_optimizer, d_optimizer, state: ConditionalGANState,
                               batch, generator: torch.Generator, *, targets=None, mesh=None):
    """One G/D update (conditional_gan.py:63-187). Updates G, D and the EMA
    in place; returns ``(new_state, metrics)`` with float32 scalar tensors
    on the batch's device (no host sync). ``targets``: the (B,) target
    classes, injected instead of drawn (the parity harness)."""
    batch = trainer_lib.augment_if_uint8(cfg, batch, generator, mesh)
    images, labels = batch["image"], batch["label"]
    dev = images.device
    labels = torch.as_tensor(labels).to(dev).long()
    if targets is None:
        targets = _target_classes(cfg, labels, generator, mesh)
    else:
        targets = torch.as_tensor(targets).to(dev).long()

    def aug(x):
        return diffaug.augment(cfg, generator, x, mesh)

    w_cycle = annealed_weight(cfg, cfg.cycle_weight, cfg.cycle_weight_final, state.step)
    w_ident = annealed_weight(cfg, cfg.identity_weight, cfg.identity_weight_final, state.step)
    g_model, d_model = state.generator, state.discriminator
    gp, dp = list(g_model.parameters()), list(d_model.parameters())
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def gen(x, c):
        return cond_lib.conditional_unet_apply(cfg, g_model, x, c)

    def disc(x, c):
        return d_lib.discriminator_apply(cfg, d_model, x, c)

    with unet.ieee_fp32(torch.float32, dev):
        # ---- G: D enters as a constant of this derivative
        with _constant(dp):
            fake = gen(images, targets)
            adv = adversarial_loss(cfg, disc(aug(fake), targets), True, True)
            # zero-weight terms are not computed at all; they report 0
            cycle = _l1(gen(fake, labels), images) if cfg.cycle_term_active else zero
            ident = _l1(gen(images, labels), images) if cfg.identity_term_active else zero
            recon = _l1(fake, images) if cfg.reconstruction_weight > 0 else zero
            g_loss = (cfg.adversarial_weight * adv + w_cycle * cycle + w_ident * ident
                      + cfg.reconstruction_weight * recon)
            g_grads = torch.autograd.grad(g_loss, gp, materialize_grads=True)

        # ---- D on the detached fakes, from the same (not yet updated) params
        fake = fake.detach()
        real = aug(images)
        d_loss = 0.5 * (adversarial_loss(cfg, disc(real, labels), True, False)
                        + adversarial_loss(cfg, disc(aug(fake), targets), False, False))
        r1 = zero
        if cfg.r1_weight > 0:
            # at D's actual (augmented) real input, the class held fixed
            r1 = r1_penalty(cfg, d_model, real, labels)
            d_loss = d_loss + 0.5 * cfg.r1_weight * r1
        d_grads = torch.autograd.grad(d_loss, dp, materialize_grads=True)

    metrics = {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
               "adversarial": adv.detach(), "cycle": cycle.detach(),
               "identity": ident.detach()}
    if cfg.r1_weight > 0:
        metrics["r1"] = r1.detach()
    g_opt, d_opt, metrics = _update_both(cfg, g_optimizer, d_optimizer, state, gp, dp, g_grads,
                                         d_grads, metrics, mesh)
    _ema_step(cfg, state.ema_generator, g_model, g_opt)
    if cfg.loss_anneal_steps > 0:
        metrics["cycle_weight"] = torch.as_tensor(w_cycle, dtype=torch.float32)
        metrics["identity_weight"] = torch.as_tensor(w_ident, dtype=torch.float32)
    return state._replace(step=state.step + 1, g_opt=g_opt, d_opt=d_opt), metrics


def make_conditional_gan_train_step(cfg):
    """``step(state, batch, generator, targets=None) -> (state, metrics)``."""
    g_opt = make_optimizer(cfg)
    d_opt = _d_optimizer(cfg)

    def step(state, batch, generator, targets=None):
        return conditional_gan_train_step(cfg, g_opt, d_opt, state, batch, generator,
                                          targets=targets)

    return step


def select_generator(state: ConditionalGANState, use_ema: bool = True):
    """The generator module (its EMA when kept)."""
    if use_ema and state.ema_generator is not None:
        return state.ema_generator
    return state.generator


def make_transfer_fn(cfg, mesh=None):
    """``(generator_module, images, target_vec) -> transferred`` under
    inference mode, on the images' device; on a mesh of more than one rank
    the images and targets are split over the ranks and the result
    gathered, and on a serving ``LocalMesh`` over its replicas, the
    generator then being ``mesh.replicate``'s list
    (``parallel/mesh.make_data_parallel_apply``)."""

    @torch.inference_mode()
    def fn(model, images, targets):
        return cond_lib.conditional_unet_apply(cfg, model, images, targets)

    return mesh_lib.make_data_parallel_apply(mesh, fn)


def transfer(cfg, state: ConditionalGANState, images, target_class, use_ema: bool = True):
    """Transfer a batch to ``target_class`` (an int, or (B,) integers)."""
    target = torch.as_tensor(target_class, device=images.device)
    target = torch.broadcast_to(target, (images.shape[0],))
    return cond_lib.conditional_unet_apply(cfg, select_generator(state, use_ema), images,
                                           target)
