"""The published CycleGAN in plain float32 PyTorch (Zhu et al., arXiv
1703.10593), written from the authors' pytorch-CycleGAN-and-pix2pix layer for
layer: ``models/networks.py`` (``ResnetGenerator`` without dropout,
``NLayerDiscriminator``, ``GANLoss("lsgan")``, ``init_weights`` normal 0.02),
``models/cycle_gan_model.py`` (the G and D losses) and
``util/image_pool.py``. NCHW tensors, ``F.pad(..., "reflect")``, no kernel,
cache or batching of the program under test, and nothing of it imported.

Widths from the configuration: ngf = ``pixel_size``, n_downsampling =
``octaves``, ``resnet_blocks`` blocks, ndf = ``d_pixel_size``, n_layers =
``d_octaves``, each width capped at ``max_size`` (512 = 8·ndf, the authors'
cap). ``ops`` and ``rec`` as in ``model.py``: each conv's input and kernel
rounded by ``ops`` (the control), and every conv and norm told to the
``Recorder`` (the norms are what ``b3_roofline`` counts).

Departures, none of which changes what is computed:

  * weights are a dict under the program's parameter names, kernels HWIO
    (transposed convs in dataflow orientation, (kh, kw, in, out)), so one
    seeded dict is handed to both sides; the authors store OIHW;
  * the naming follows the program: D_A judges class A (real A against
    G_BA's fakes), where the authors' ``netD_A`` judges domain B;
  * the images come from seeded uint8 pools of ``load_size``² images and
    take the program's crop of ``size``² and flip (``diffusion.augment``);
    the authors resize to ``load_size`` first;
  * the image pool's draws: for the ``d`` images of a query past the fill,
    ``torch.rand(d)`` then ``torch.randint(0, n, (d,))`` from the step's
    generator, class A's query first, after the augment's draws (the
    authors draw with Python's ``random``, the slot only on a swap);
  * both discriminators' losses are differentiated in one call, as are both
    generators', and the rows of a batch go through in blocks of
    ``block``, each block's loss weighted by its share of the batch: the
    losses are means and the norms are per sample, so the blocks'
    gradients add up to the batch's. The pool takes the whole batch's
    fakes between G's blocks and D's;
  * Adam is the authors' ``torch.optim.Adam`` (ε after √v̂) written out,
    β₁ from the configuration; the learning rate is constant (the linear
    decay starts after epoch 100).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import diffusion as D
from .model import EPS, _q
from .steps import ieee_fp32


def _conv(x, kernel, bias, ops, rec, stride=1, pad=0, reflect=False):
    """``nn.Conv2d(k, stride, padding=pad)`` behind ``nn.ReflectionPad2d(pad)``
    where ``reflect``; kernel HWIO."""
    if rec is not None:
        rec.add("conv", tuple(x.shape), tuple(kernel.shape), stride)
    if reflect:
        x, pad = F.pad(x, (pad, pad, pad, pad), mode="reflect"), 0
    w = kernel.permute(3, 2, 0, 1)
    return F.conv2d(_q(ops, x), _q(ops, w), bias, stride=stride, padding=pad)


def _conv_t(x, kernel, bias, ops, rec):
    """``nn.ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``;
    kernel (3, 3, in, out)."""
    if rec is not None:
        rec.add("conv_transpose", tuple(x.shape), tuple(kernel.shape))
    w = kernel.permute(2, 3, 0, 1)
    return F.conv_transpose2d(_q(ops, x), _q(ops, w), bias, stride=2, padding=1,
                              output_padding=1)


def instance_norm(x, rec=None):
    """``nn.InstanceNorm2d(affine=False)``: per (sample, channel) over (H,
    W), biased variance, rsqrt(v + 1e-5)."""
    if rec is not None:
        rec.add("instance_norm", tuple(x.shape))
    m = x.mean(dim=(2, 3), keepdim=True)
    v = torch.square(x - m).mean(dim=(2, 3), keepdim=True)
    return (x - m) * torch.rsqrt(v + EPS)


# ------------------------------------------------------------------ shapes


def _widths(base, n, cap):
    return [min(base * 2**i, cap) for i in range(n + 1)]


def generator_shapes(cfg, channels=3):
    """``name -> shape`` of the ResNet generator's parameters."""
    f = _widths(cfg.pixel_size, cfg.octaves, cfg.max_size)
    shapes = OrderedDict()

    def conv(name, k, i, o):
        shapes[f"{name}.kernel"] = (k, k, i, o)
        shapes[f"{name}.bias"] = (o,)

    conv("stem", 7, channels, f[0])
    for i in range(cfg.octaves):
        conv(f"downs.{i}", 3, f[i], f[i + 1])
    for j in range(cfg.resnet_blocks):
        conv(f"blocks.{j}.conv_a", 3, f[-1], f[-1])
        conv(f"blocks.{j}.conv_b", 3, f[-1], f[-1])
    for n, i in enumerate(reversed(range(cfg.octaves))):
        conv(f"ups.{n}", 3, f[i + 1], f[i])
    conv("head", 7, f[0], channels)
    return shapes


def discriminator_shapes(cfg, channels=3):
    """``name -> shape`` of the 70×70 PatchGAN's parameters."""
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


def init_weights(shapes, generator, device):
    """N(0, 0.02) kernels in one draw on ``device``, zero biases."""
    total = sum(math.prod(s) for n, s in shapes.items() if n.endswith("kernel"))
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32) * 0.02
    out, at = OrderedDict(), 0
    for name, shape in shapes.items():
        if name.endswith("kernel"):
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------- forwards


def generator(cfg, w, x, ops=None, rec=None):
    """``ResnetGenerator`` on NCHW ``x`` → NCHW images in (−1, 1)."""

    def conv(name, h, **kw):
        return _conv(h, w[f"{name}.kernel"], w[f"{name}.bias"], ops, rec, **kw)

    def norm_relu(h):
        return torch.relu(instance_norm(h, rec))

    h = norm_relu(conv("stem", x, pad=3, reflect=True))
    for i in range(cfg.octaves):
        h = norm_relu(conv(f"downs.{i}", h, stride=2, pad=1))
    for j in range(cfg.resnet_blocks):
        r = norm_relu(conv(f"blocks.{j}.conv_a", h, pad=1, reflect=True))
        h = h + instance_norm(conv(f"blocks.{j}.conv_b", r, pad=1, reflect=True), rec)
    for n in range(cfg.octaves):
        h = norm_relu(_conv_t(h, w[f"ups.{n}.kernel"], w[f"ups.{n}.bias"], ops, rec))
    return torch.tanh(conv("head", h, pad=3, reflect=True))


def discriminator(cfg, w, x, ops=None, rec=None):
    """``NLayerDiscriminator`` on NCHW ``x`` → patch logits (B, 1, h', w')."""
    n = cfg.d_octaves or cfg.octaves
    h = x
    for i in range(n + 1):
        h = _conv(h, w[f"convs.{i}.kernel"], w[f"convs.{i}.bias"], ops, rec,
                  stride=2 if i < n else 1, pad=1)
        if i > 0:
            h = instance_norm(h, rec)
        h = F.leaky_relu(h, 0.2)
    return _conv(h, w["head.kernel"], w["head.bias"], ops, rec, pad=1)


def lsgan(logits, real: bool):
    """``GANLoss("lsgan")``: the mean squared distance to 1 or 0."""
    return torch.mean(torch.square(logits - (1.0 if real else 0.0)))


def l1(a, b):
    return torch.mean(torch.abs(a - b))


# ------------------------------------------------------------- image pool


class ImagePool:
    """``util/image_pool.ImagePool``: up to ``n`` past fakes; a query goes
    image by image, filling the pool first, then with probability 0.5
    returning a stored image and storing the fresh one in its slot."""

    def __init__(self, n):
        self.n, self.images = n, []

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
            else:
                out.append(image)
        return torch.stack(out)


# -------------------------------------------------------------- the step


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class Adam:
    """``torch.optim.Adam(lr, betas=(b1, 0.999), eps)`` over a dict of float32
    leaves: bias-corrected moments, ε after √v̂."""

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
    """G_AB, G_BA, D_A, D_B under ``g_ab.*``, ``g_ba.*``, ``d_a.*``, ``d_b.*``;
    ``step(raw_a, raw_b)`` is one G/D step on two uint8 batches. Keeps what
    the benchmark compares: each step's G and D losses, the first step's
    gradient by leaf and each leaf's change after the steps."""

    def __init__(self, cfg, weights, generator, ops=None, block=4):
        if cfg.gan_loss != "lsgan" or cfg.diffaug or cfg.r1_weight or (
                cfg.reconstruction_weight or cfg.loss_anneal_steps or cfg.ema_decay):
            raise NotImplementedError("the reference writes the published CycleGAN's losses")
        if cfg.optimizer != "adam" or cfg.lr_schedule != "constant" or cfg.d_learning_rate:
            raise NotImplementedError("the reference writes Adam at one constant rate")
        self.cfg, self.g, self.ops, self.block = cfg, generator, ops, block
        self.params = {k: v.detach().clone().float() for k, v in weights.items()}
        self.start = {k: v.clone() for k, v in self.params.items()}
        self.losses, self.grad_norms = [], None
        self.g_keys = [k for k in self.params if k.startswith("g_")]
        self.d_keys = [k for k in self.params if k.startswith("d_")]
        self.pools = [ImagePool(cfg.image_pool) for _ in "ab"] if cfg.image_pool else None
        self.opt = {side: Adam({k: self.params[k] for k in keys}, cfg.learning_rate,
                               cfg.adam_b1, cfg.adam_eps)
                    for side, keys in (("g", self.g_keys), ("d", self.d_keys))}

    def _blocks(self, n):
        for lo in range(0, n, self.block):
            hi = min(lo + self.block, n)
            yield lo, hi, (hi - lo) / n

    def step(self, raw_a, raw_b):
        """One step; returns ``(g_loss, d_loss)``."""
        cfg, ops = self.cfg, self.ops
        real = []
        for raw in (raw_a, raw_b):
            rows, cols, flips = D.draw_augment(raw.shape[0], raw.shape[1], raw.shape[2],
                                               cfg.size, self.g)
            real.append(D.augment(raw, rows, cols, flips, cfg.size).permute(0, 3, 1, 2))
        a, b = real
        g_leaves = {k: self.params[k].detach().requires_grad_(True) for k in self.g_keys}
        d_const = {k: self.params[k].detach() for k in self.d_keys}

        def gen(leaves, name, x):
            return generator(cfg, _net(leaves, name), x, ops)

        def disc(leaves, name, x):
            return discriminator(cfg, _net(leaves, name), x, ops)

        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        g_loss = torch.zeros((), dtype=torch.float64, device=a.device)
        fakes = [[], []]
        with ieee_fp32():
            for lo, hi, share in self._blocks(a.shape[0]):
                ra, rb = a[lo:hi], b[lo:hi]
                fake_b, fake_a = gen(g_leaves, "g_ab", ra), gen(g_leaves, "g_ba", rb)
                adv = lsgan(disc(d_const, "d_b", fake_b), True) + lsgan(
                    disc(d_const, "d_a", fake_a), True)
                cycle = l1(gen(g_leaves, "g_ba", fake_b), ra) + l1(gen(g_leaves, "g_ab", fake_a),
                                                                   rb)
                ident = l1(gen(g_leaves, "g_ab", rb), rb) + l1(gen(g_leaves, "g_ba", ra), ra)
                part = (cfg.adversarial_weight * adv + cfg.cycle_weight * cycle
                        + cfg.identity_weight * ident) * share
                for k, gk in zip(g_leaves, torch.autograd.grad(part, list(g_leaves.values()))):
                    grads[k] += gk
                g_loss += part.detach().double()
                fakes[0].append(fake_a.detach())
                fakes[1].append(fake_b.detach())
            fake_a, fake_b = (torch.cat(f) for f in fakes)
            if self.pools is not None:
                fake_a = self.pools[0].query(fake_a, self.g)
                fake_b = self.pools[1].query(fake_b, self.g)
            d_leaves = {k: v.requires_grad_(True) for k, v in d_const.items()}
            d_loss = torch.zeros((), dtype=torch.float64, device=a.device)
            for lo, hi, share in self._blocks(a.shape[0]):
                part = (lsgan(disc(d_leaves, "d_a", a[lo:hi]), True)
                        + lsgan(disc(d_leaves, "d_a", fake_a[lo:hi]), False)
                        + lsgan(disc(d_leaves, "d_b", b[lo:hi]), True)
                        + lsgan(disc(d_leaves, "d_b", fake_b[lo:hi]), False)) * 0.5 * share
                for k, gk in zip(d_leaves, torch.autograd.grad(part, list(d_leaves.values()))):
                    grads[k] += gk
                d_loss += part.detach().double()
        self.losses.append((float(g_loss), float(d_loss)))
        if self.grad_norms is None:
            self.grad_norms = _norms(grads)
        for side, keys in (("g", self.g_keys), ("d", self.d_keys)):
            sub = {k: self.params[k] for k in keys}
            self.opt[side].step(sub, {k: grads[k] for k in keys})
            self.params.update(sub)
        return self.losses[-1]

    def readings(self):
        """The comparison's readings (``perfbench.harness.feed.Readings``'s
        fields) as a namespace."""
        return SimpleNamespace(
            losses=self.losses, grad_norms=self.grad_norms,
            delta_norms=_norms({k: self.params[k] - self.start[k] for k in self.params}),
            value_norms=_norms(self.params), numel={k: v.numel() for k, v in self.params.items()})
