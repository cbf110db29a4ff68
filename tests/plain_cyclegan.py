"""The published CycleGAN in plain float32 PyTorch, the tier-1 tests' copy of
``perfbench/reference/cyclegan.py`` (Zhu et al., arXiv 1703.10593): the
authors' pytorch-CycleGAN-and-pix2pix ``models/networks.py``
(``ResnetGenerator`` without dropout, ``NLayerDiscriminator``,
``GANLoss("lsgan")``), ``models/cycle_gan_model.py`` (the G and D losses)
and ``util/image_pool.py``, layer for layer, in NCHW with
``F.pad(..., "reflect")``. It imports neither JAX nor any part of the port,
and turns TF32 off for its convs and matmuls.

Departures, none of which changes what is computed:

  * weights are a dict under the port's parameter names, kernels HWIO
    (transposed convs in dataflow orientation, (kh, kw, in, out)), so one
    seeded dict goes to both sides; the authors store OIHW;
  * the naming follows the port: D_A judges class A (real A against G_BA's
    fakes), where the authors' ``netD_A`` judges domain B;
  * a step takes float32 NHWC batches in [−1, 1), already cropped and
    flipped (the authors' data loader's work);
  * the image pool's draws: for the ``d`` images of a query past the fill,
    ``torch.rand(d)`` then ``torch.randint(0, n, (d,))`` from the step's
    generator, class A's query first (the authors draw with Python's
    ``random``, the slot only on a swap);
  * both discriminators' losses are differentiated in one call, as are both
    generators', from the parameters as they were before the step; the
    authors step G's optimizer between the two, which changes neither
    gradient (D is updated last, and D's fakes are G's from before);
  * Adam is ``torch.optim.Adam`` (ε after √v̂) written out, β₁ from the
    configuration, at a constant learning rate.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

EPS = 1e-5


@contextlib.contextmanager
def ieee_fp32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv(x, kernel, bias, stride=1, pad=0, reflect=False):
    """``nn.Conv2d(k, stride, padding=pad)`` behind ``nn.ReflectionPad2d(pad)``
    where ``reflect``; NCHW, kernel HWIO."""
    if reflect:
        x, pad = F.pad(x, (pad, pad, pad, pad), mode="reflect"), 0
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=stride, padding=pad)


def conv_transpose(x, kernel, bias):
    """``nn.ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``;
    kernel (3, 3, in, out)."""
    return F.conv_transpose2d(x, kernel.permute(2, 3, 0, 1), bias, stride=2, padding=1,
                              output_padding=1)


def instance_norm(x):
    """``nn.InstanceNorm2d(affine=False)``."""
    m = x.mean(dim=(2, 3), keepdim=True)
    v = torch.square(x - m).mean(dim=(2, 3), keepdim=True)
    return (x - m) * torch.rsqrt(v + EPS)


def _widths(base, n, cap):
    return [min(base * 2**i, cap) for i in range(n + 1)]


def generator_shapes(cfg, channels=3):
    f = _widths(cfg.pixel_size, cfg.octaves, cfg.max_size)
    shapes = OrderedDict()

    def layer(name, k, i, o):
        shapes[f"{name}.kernel"] = (k, k, i, o)
        shapes[f"{name}.bias"] = (o,)

    layer("stem", 7, channels, f[0])
    for i in range(cfg.octaves):
        layer(f"downs.{i}", 3, f[i], f[i + 1])
    for j in range(cfg.resnet_blocks):
        layer(f"blocks.{j}.conv_a", 3, f[-1], f[-1])
        layer(f"blocks.{j}.conv_b", 3, f[-1], f[-1])
    for n, i in enumerate(reversed(range(cfg.octaves))):
        layer(f"ups.{n}", 3, f[i + 1], f[i])
    layer("head", 7, f[0], channels)
    return shapes


def discriminator_shapes(cfg, channels=3):
    f = _widths(cfg.d_pixel_size or cfg.pixel_size, cfg.d_octaves or cfg.octaves, cfg.max_size)
    shapes = OrderedDict()
    c = channels
    for i, o in enumerate(f):
        shapes[f"convs.{i}.kernel"] = (4, 4, c, o)
        shapes[f"convs.{i}.bias"] = (o,)
        c = o
    shapes["head.kernel"] = (4, 4, c, 1)
    shapes["head.bias"] = (1,)
    return shapes


def init_weights(shapes, generator, bias_std=0.0):
    """N(0, 0.02) kernels; biases zero, or N(0, bias_std) where a test wants
    them to count."""
    out = OrderedDict()
    for name, shape in shapes.items():
        std = 0.02 if name.endswith("kernel") else bias_std
        out[name] = torch.randn(shape, generator=generator) * std
    return out


def generator(cfg, w, x):
    """``ResnetGenerator`` on NCHW ``x``."""

    def norm_relu(h):
        return torch.relu(instance_norm(h))

    h = norm_relu(conv(x, w["stem.kernel"], w["stem.bias"], pad=3, reflect=True))
    for i in range(cfg.octaves):
        h = norm_relu(conv(h, w[f"downs.{i}.kernel"], w[f"downs.{i}.bias"], stride=2, pad=1))
    for j in range(cfg.resnet_blocks):
        p = f"blocks.{j}"
        r = norm_relu(conv(h, w[f"{p}.conv_a.kernel"], w[f"{p}.conv_a.bias"], pad=1, reflect=True))
        h = h + instance_norm(conv(r, w[f"{p}.conv_b.kernel"], w[f"{p}.conv_b.bias"], pad=1,
                                   reflect=True))
    for n in range(cfg.octaves):
        h = norm_relu(conv_transpose(h, w[f"ups.{n}.kernel"], w[f"ups.{n}.bias"]))
    return torch.tanh(conv(h, w["head.kernel"], w["head.bias"], pad=3, reflect=True))


def discriminator(cfg, w, x):
    """``NLayerDiscriminator`` on NCHW ``x`` → (B, 1, h', w') logits."""
    n = cfg.d_octaves or cfg.octaves
    h = x
    for i in range(n + 1):
        h = conv(h, w[f"convs.{i}.kernel"], w[f"convs.{i}.bias"], stride=2 if i < n else 1, pad=1)
        if i > 0:
            h = instance_norm(h)
        h = F.leaky_relu(h, 0.2)
    return conv(h, w["head.kernel"], w["head.bias"], pad=1)


def lsgan(logits, real: bool):
    return torch.mean(torch.square(logits - (1.0 if real else 0.0)))


def l1(a, b):
    return torch.mean(torch.abs(a - b))


class ImagePool:
    """``util/image_pool.ImagePool``, its draws as the module docstring says."""

    def __init__(self, n):
        self.n, self.images, self.swaps = n, [], 0

    def query(self, fakes, g):
        fakes = fakes.detach()
        fill = min(fakes.shape[0], self.n - len(self.images))
        d = fakes.shape[0] - fill
        if d:
            u = torch.rand((d,), generator=g, device=g.device).tolist()
            slots = torch.randint(0, self.n, (d,), generator=g, device=g.device).tolist()
        out = []
        for i, image in enumerate(fakes):
            if i < fill:
                self.images.append(image.clone())
                out.append(image)
            elif u[i - fill] > 0.5:
                k = slots[i - fill]
                out.append(self.images[k])
                self.images[k] = image.clone()
                self.swaps += 1
            else:
                out.append(image)
        return torch.stack(out)


class Adam:
    def __init__(self, params, lr, b1, eps):
        self.lr, self.b1, self.eps, self.t = lr, b1, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2, t = self.b1, 0.999, self.t
        for k, g in grads.items():
            m = self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            v = self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            params[k] = params[k] - self.lr * (m / (1 - b1**t)) / (
                torch.sqrt(v / (1 - b2**t)) + self.eps)


def _net(leaves, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in leaves.items() if k.startswith(prefix + ".")}


class CycleGANTrainer:
    """G_AB, G_BA, D_A, D_B under ``g_ab.*``, ``g_ba.*``, ``d_a.*``, ``d_b.*``.
    ``step(a, b)`` on NHWC float32 batches returns ``(g_loss, d_loss)`` and
    keeps each step's gradients (``grads``)."""

    def __init__(self, cfg, weights, generator):
        self.cfg, self.g = cfg, generator
        self.params = {k: v.detach().clone().float() for k, v in weights.items()}
        self.g_keys = [k for k in self.params if k.startswith("g_")]
        self.d_keys = [k for k in self.params if k.startswith("d_")]
        self.pools = [ImagePool(cfg.image_pool) for _ in "ab"] if cfg.image_pool else None
        self.opt = {side: Adam({k: self.params[k] for k in keys}, cfg.learning_rate,
                               cfg.adam_b1, cfg.adam_eps)
                    for side, keys in (("g", self.g_keys), ("d", self.d_keys))}
        self.grads = []

    def step(self, a, b):
        cfg = self.cfg
        a, b = a.permute(0, 3, 1, 2).float(), b.permute(0, 3, 1, 2).float()
        g_leaves = {k: self.params[k].detach().requires_grad_(True) for k in self.g_keys}
        d_const = {k: self.params[k].detach() for k in self.d_keys}

        def gen(name, x):
            return generator(cfg, _net(g_leaves, name), x)

        with ieee_fp32():
            fake_b, fake_a = gen("g_ab", a), gen("g_ba", b)
            adv = (lsgan(discriminator(cfg, _net(d_const, "d_b"), fake_b), True)
                   + lsgan(discriminator(cfg, _net(d_const, "d_a"), fake_a), True))
            cycle = l1(gen("g_ba", fake_b), a) + l1(gen("g_ab", fake_a), b)
            ident = l1(gen("g_ab", b), b) + l1(gen("g_ba", a), a)
            g_loss = (cfg.adversarial_weight * adv + cfg.cycle_weight * cycle
                      + cfg.identity_weight * ident)
            grads = dict(zip(g_leaves, torch.autograd.grad(g_loss, list(g_leaves.values()))))
            fake_a, fake_b = fake_a.detach(), fake_b.detach()
            if self.pools is not None:
                fake_a = self.pools[0].query(fake_a, self.g)
                fake_b = self.pools[1].query(fake_b, self.g)
            d_leaves = {k: v.requires_grad_(True) for k, v in d_const.items()}

            def disc(name, x):
                return discriminator(cfg, _net(d_leaves, name), x)

            d_loss = (lsgan(disc("d_a", a), True) + lsgan(disc("d_a", fake_a), False)
                      + lsgan(disc("d_b", b), True) + lsgan(disc("d_b", fake_b), False)) * 0.5
            grads.update(zip(d_leaves, torch.autograd.grad(d_loss, list(d_leaves.values()))))
        self.grads.append(grads)
        for side, keys in (("g", self.g_keys), ("d", self.d_keys)):
            sub = {k: self.params[k] for k in keys}
            self.opt[side].step(sub, {k: grads[k] for k in keys})
            self.params.update(sub)
        return float(g_loss.detach()), float(d_loss.detach())


def param_count(shapes) -> int:
    return sum(math.prod(s) for s in shapes.values())
