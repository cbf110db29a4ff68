"""The reference's training steps and sampler, in float32 with TF32 off.

``DiffusionTrainer`` follows the denoiser's training step
(train.py:217-280): augment the uint8 batch, draw t and the noise, predict
the clean image (x parameterisation), mean squared error, Adam. The batch's
rows go through in blocks of ``block`` (the loss is the mean over all of
them, so the blocks' gradients add up to the whole batch's).

``CycleGANTrainer`` follows the two-class cycle GAN: G_AB, G_BA, D_A, D_B;
the generators' loss (non-saturating adversarial + cycle L1 + identity L1)
differentiated with the discriminators held constant, then the
discriminators' on the detached fakes, both from the parameters as they
were before the step; then both updates.

Both keep what the benchmark compares: each step's loss, the first step's
gradient by leaf, and each leaf's change after the steps run.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import diffusion as D
from . import model as M


@contextlib.contextmanager
def ieee_fp32():
    """float32 convs and matmuls in IEEE float32 (no TF32) inside."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class _Trainer:
    """What both trainers keep: losses, the first step's gradient norms, the
    starting weights (for the change after the steps)."""

    def __init__(self, weights):
        self.params = {k: v.detach().clone().float() for k, v in weights.items()}
        self.start = {k: v.clone() for k, v in self.params.items()}
        self.losses, self.grad_norms = [], None

    def _record(self, loss, grads):
        self.losses.append(float(loss))
        if self.grad_norms is None:
            self.grad_norms = _norms(grads)

    def delta_norms(self):
        return _norms({k: self.params[k] - self.start[k] for k in self.params})

    def readings(self, losses=None):
        """The comparison's readings (``perfbench.harness.feed.Readings``'s
        fields) as a namespace."""
        from types import SimpleNamespace

        return SimpleNamespace(losses=self.losses if losses is None else losses,
                               grad_norms=self.grad_norms, delta_norms=self.delta_norms(),
                               value_norms=_norms(self.params),
                               numel={k: v.numel() for k, v in self.params.items()})


class DiffusionTrainer(_Trainer):
    """``ranks``: the batch is split over that many data ranks, each of which
    noises its rows with the step's seed folded by its position
    (``diffusion.fold_seed``) and counts its samples from 0."""

    def __init__(self, cfg, weights, generator, ops=None, block=32, ranks=1):
        super().__init__(weights)
        self.cfg, self.g, self.ops, self.block, self.ranks = cfg, generator, ops, block, ranks
        keras = cfg.optimizer in ("adam_tf", "adam_fused")
        if cfg.optimizer not in ("adam", "adam_tf", "adam_fused"):
            raise NotImplementedError(f"reference optimizer {cfg.optimizer!r}")
        self.opt = D.Adam(self.params, cfg.learning_rate, cfg.warm_up, cfg.adam_eps, keras)

    def step(self, raw):
        """One step on the raw uint8 batch (B, H, W, 3); returns the loss."""
        cfg, b = self.cfg, raw.shape[0]
        rows, cols, flips = D.draw_augment(b, raw.shape[1], raw.shape[2], cfg.size, self.g)
        t, seed = D.draw_step(b, cfg.steps, self.g)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total = torch.zeros((), dtype=torch.float64, device=raw.device)
        n_elem = b * cfg.size * cfg.size * 3
        with ieee_fp32():
            local, lo = b // self.ranks, 0
            while lo < b:
                hi = min(lo + self.block, b, (lo // local + 1) * local)
                x = D.augment(raw[lo:hi], rows[lo:hi], cols[lo:hi], flips[lo:hi], cfg.size)
                rank_seed = D.fold_seed(seed, lo // local) if self.ranks > 1 else seed
                noised = D.noise_batch(x, t[lo:hi], rank_seed, cfg.steps, cfg.schedule,
                                       range(lo % local, lo % local + hi - lo))
                pred = M.nhwc(M.denoiser(cfg, leaves, M.nchw(noised), self.ops))
                part = torch.sum(torch.square(x - pred)) / n_elem
                for k, gk in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
                    grads[k] += gk
                total += part.detach().double()
                lo = hi
        self._record(total, grads)
        self.opt.step(self.params, grads)
        return float(total)


def _bce(logits, real):
    target = torch.ones_like(logits) if real else torch.zeros_like(logits)
    return F.binary_cross_entropy_with_logits(logits, target)


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


class CycleGANTrainer(_Trainer):
    """Leaves are named ``g_ab.*``, ``g_ba.*``, ``d_a.*``, ``d_b.*``."""

    def __init__(self, cfg, weights, generator, ops=None):
        super().__init__(weights)
        if cfg.gan_loss != "nonsaturating" or cfg.diffaug or cfg.r1_weight or (
                cfg.reconstruction_weight or cfg.loss_anneal_steps):
            raise NotImplementedError("the reference writes the default cycle-GAN losses")
        self.cfg, self.g, self.ops = cfg, generator, ops
        self.losses_d = []
        keras = cfg.optimizer in ("adam_tf", "adam_fused")
        lr_d = cfg.d_learning_rate if cfg.d_learning_rate > 0 else cfg.learning_rate
        g_keys = [k for k in self.params if k.startswith("g_")]
        d_keys = [k for k in self.params if k.startswith("d_")]
        self.g_keys, self.d_keys = g_keys, d_keys
        self.g_opt = D.Adam({k: self.params[k] for k in g_keys}, cfg.learning_rate, cfg.warm_up,
                            cfg.adam_eps, keras)
        self.d_opt = D.Adam({k: self.params[k] for k in d_keys}, lr_d, cfg.warm_up,
                            cfg.adam_eps, keras)

    def _net(self, leaves, prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in leaves.items() if k.startswith(prefix + ".")}

    def step(self, raw_a, raw_b):
        cfg, b = self.cfg, raw_a.shape[0]
        aug = []
        for raw in (raw_a, raw_b):
            rows, cols, flips = D.draw_augment(b, raw.shape[1], raw.shape[2], cfg.size, self.g)
            aug.append(M.nchw(D.augment(raw, rows, cols, flips, cfg.size)))
        a, bb = aug
        g_leaves = {k: self.params[k].detach().requires_grad_(True) for k in self.g_keys}
        d_const = {k: self.params[k].detach() for k in self.d_keys}
        ops = self.ops

        def gen(leaves, name, x):
            return M.denoiser(cfg, self._net(leaves, name), x, ops, norm=cfg.g_norm == "instance")

        def disc(leaves, name, x):
            return M.discriminator(cfg, self._net(leaves, name), x, ops)

        with ieee_fp32():
            fake_b, fake_a = gen(g_leaves, "g_ab", a), gen(g_leaves, "g_ba", bb)
            adv = (_bce(disc(d_const, "d_b", fake_b), True)
                   + _bce(disc(d_const, "d_a", fake_a), True))
            cycle = _l1(gen(g_leaves, "g_ba", fake_b), a) + _l1(gen(g_leaves, "g_ab", fake_a), bb)
            ident = _l1(gen(g_leaves, "g_ab", bb), bb) + _l1(gen(g_leaves, "g_ba", a), a)
            g_loss = cfg.adversarial_weight * adv + cfg.cycle_weight * cycle + (
                cfg.identity_weight * ident)
            g_grads = dict(zip(g_leaves, torch.autograd.grad(g_loss, list(g_leaves.values()))))
            d_leaves = {k: v.requires_grad_(True) for k, v in d_const.items()}
            fake_a, fake_b = fake_a.detach(), fake_b.detach()
            d_loss = (_bce(disc(d_leaves, "d_a", a), True)
                      + _bce(disc(d_leaves, "d_a", fake_a), False)
                      + _bce(disc(d_leaves, "d_b", bb), True)
                      + _bce(disc(d_leaves, "d_b", fake_b), False)) * 0.5
            d_grads = dict(zip(d_leaves, torch.autograd.grad(d_loss, list(d_leaves.values()))))
        self.losses_d.append(float(d_loss.detach()))
        self._record(g_loss.detach(), {**g_grads, **d_grads})
        g_params = {k: self.params[k] for k in self.g_keys}
        d_params = {k: self.params[k] for k in self.d_keys}
        self.g_opt.step(g_params, g_grads)
        self.d_opt.step(d_params, d_grads)
        self.params.update(g_params)
        self.params.update(d_params)
        return float(g_loss.detach())


def sample(cfg, weights, init, ops=None, block=16):
    """The reverse-diffusion sampler's final images for NHWC ``init``, in
    blocks of ``block`` rows."""
    w = {k: v.float() for k, v in weights.items()}
    out = []
    with torch.inference_mode(), ieee_fp32():
        for lo in range(0, init.shape[0], block):
            def denoise(x):
                return M.nhwc(M.denoiser(cfg, w, M.nchw(x), ops))
            out.append(D.sample_x(cfg, denoise, init[lo:lo + block].float()))
    return torch.cat(out)
