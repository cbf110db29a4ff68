"""The published CycleGAN's training on one card: the port's G/D step
(``train/gan.make_gan_train_step``) with ResNet generators, 70×70
PatchGANs, least squares and the image pool, on two seeded uint8 pools on
the card, one a class, each batch cropped, flipped and normalised by the
step.

Parameters: ``batch`` images a class; ``pool`` images a class of
``pool_side``² pixels (the published ``load_size``); ``sync_every``,
``checked_steps``, ``warm_steps`` as for ``gan_train``; ``ref_block``: the
reference's rows a block. A unit is one step: ``2·batch`` images.

Readings: each checked step's generator and discriminator losses, the
first step's gradient by leaf of all four networks (from Adam's first
moment, m₁ = (1 − β₁)·g₁, at the configuration's β₁), each leaf's change
over the checked steps; the reference is ``reference/cyclegan.py``, whose
image pools repeat the program's draws, so steps that swap images are
compared too.

A program without the ResNet generator (``Config.generator``) cannot run
the cell: set-up exits at once.

Images smaller than the PatchGAN's least input (``3·2^d_octaves``: 24² for
the published three k4/s2 layers) take the deepest discriminator they
admit (``fit_patchgan``); the cell's 256² keeps the published layout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench import faults
from perfbench.harness import counts, feed, session
from perfbench.reference import cyclegan as ref
from perfbench.reference import model as ref_model
from perfbench.traffic import gan_train

NETS = gan_train.NETS
FEED_B1 = 0.9  # the β₁ at which ``feed.drive_checked_steps`` reads g₁ off m₁


def shapes(rcfg):
    g, d = ref.generator_shapes(rcfg), ref.discriminator_shapes(rcfg)
    return {"g_ab": g, "g_ba": g, "d_a": d, "d_b": d}


def seeded_weights(run, dev):
    """``g_ab.stem.kernel``-style names over the four nets, N(0, 0.02)."""
    out = {}
    for tag, (net, sh) in enumerate(shapes(run.ref_cfg()).items()):
        g = feed.generator(dev, run.seed, feed.WEIGHTS, tag)
        for k, v in ref.init_weights(sh, g, dev).items():
            out[f"{net}.{k}"] = v
    return out


def fit_patchgan(run):
    """Lower ``d_octaves`` in ``run.config`` until the images leave a patch
    map of one logit or more: each k4/s2 layer halves the side and the two
    k4/s1 layers take one each, so the side needs ``3·2^d_octaves``. The
    benchmark's shared CPU tests shrink every configuration to 16², where
    the published three layers leave none; at the cell's 256² nothing
    changes."""
    c = run.config
    d = c["d_octaves"]
    while d > 1 and c["size"] < 3 << d:
        d -= 1
    if d != c["d_octaves"]:
        print(f"perfbench: {c['size']}x{c['size']} images admit {d} k4/s2 discriminator "
              f"layers, not {c['d_octaves']}", file=sys.stderr)
        run.config = {**c, "d_octaves": d}


class Driver(gan_train.Driver):
    """``gan_train``'s driver with this configuration's weights, readings and
    reference."""

    def __init__(self, run):
        from gan_class_transfer2_tpu_torch.train import gan

        fit_patchgan(run)
        cfg = run.port_cfg(batch_size=run.params["batch"])
        if getattr(cfg, "generator", None) != "resnet" or not cfg.image_pool:
            raise SystemExit("perfbench: the program has no ResNet generator or image pool "
                             "(Config.generator, Config.image_pool); no result")
        p, dev = run.params, run.device
        self.run = run
        self.images, self.sync_every = 2 * p["batch"], p["sync_every"]
        self.pools, self.orders = gan_train.inputs(run)
        self.state = gan.init_gan_state(cfg, feed.generator(dev, run.seed, 0), device=dev)
        weights = seeded_weights(run, dev)
        for net in NETS:
            feed.load_into(getattr(self.state, net), gan_train._net(weights, net))
        del weights
        run.phase("state and weights")
        self.step = gan.make_gan_train_step(cfg)
        self.gen = feed.generator(dev, run.seed, feed.DRAWS)
        self.metrics = None
        self.idx = []

        def checked():
            idx = [o.next().clone() for o in self.orders]
            self.idx.append(idx)
            self._step(idx)
            return self.metrics

        def named():
            return [(f"{net}.{k}", v) for net in NETS
                    for k, v in getattr(self.state, net).named_parameters()]

        self.readings = feed.drive_checked_steps(
            checked, named, lambda: [self.state.g_opt, self.state.d_opt], p["checked_steps"],
            lambda m: (float(m["g_loss"]), float(m["d_loss"])))
        scale = (1.0 - FEED_B1) / (1.0 - cfg.adam_b1)
        self.readings.grad_norms = {k: v * scale for k, v in self.readings.grad_norms.items()}
        run.phase("checked steps")
        for _ in range(p["warm_steps"]):
            self.unit()
        self.sync()
        run.phase("warm-up")

    def count(self):
        count_flops(self.run, self.images // 2)

    def check(self):
        return gan_train.compare_readings(self.run, self.readings,
                                          reference(self.run, self.raws()))


def calibrate(run, control=None):
    """As ``gan_train.calibrate``: the checked steps' checks, no window."""
    fit_patchgan(run)
    if control is None:
        drv = Driver(run)
        got, raws = drv.readings, drv.raws()
        drv.free()
    else:
        pools, orders = gan_train.inputs(run)
        raws = [[pool.index_select(0, o.next()) for pool, o in zip(pools, orders)]
                for _ in range(run.params["checked_steps"])]
        got = reference(run, raws, ops=control)
    ref_readings = reference(run, raws)
    run.extra["readings"] = got, ref_readings
    return gan_train.compare_readings(run, got, ref_readings)


def calibrate_many(run, seeds, fault=""):
    """``calibrate`` for each seed with ``fault`` planted: this cell runs
    ``gan_train``'s step, so ``faults.py``'s faults of ``gan_train`` are
    its own. The worst leaves of each reading go to stderr."""
    from perfbench.calibrate import worst_leaves

    out = []
    for seed in seeds:
        r = session.Run(argparse.Namespace(seed=seed, seconds=0, trace=0), run.root, run.bench,
                        run.cell, run.config, run.device, time.time())
        with faults.FAULTS[fault]("gan_train") if fault else contextlib.nullcontext():
            out.append(calibrate(r))
        print(json.dumps({"seed": seed, "fault": fault,
                          "worst": worst_leaves(*r.extra["readings"])}), file=sys.stderr)
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def count_flops(run, batch):
    """The reference's FLOPs of one G/D step at the cell's batch, and the
    calls of its forwards (the 156 norms the B3 roofline counts at two
    octaves and nine blocks)."""
    rcfg = run.ref_cfg()
    rec = ref_model.Recorder()
    sh = shapes(rcfg)
    names = [f"{net}.{k}" for net in NETS for k in sh[net]]
    all_shapes = [sh[net][k] for net in NETS for k in sh[net]]

    def step(a, b, *leaves):
        w = dict(zip(names, leaves))

        def gen(name, x):
            return ref.generator(rcfg, gan_train._net(w, name), x, rec=rec)

        def disc(name, x, const=False):
            d = gan_train._net(w, name)
            if const:
                d = {k: v.detach() for k, v in d.items()}
            return ref.discriminator(rcfg, d, x, rec=rec)

        fb, fa = gen("g_ab", a), gen("g_ba", b)
        g_loss = (ref.lsgan(disc("d_b", fb, True), True) + ref.lsgan(disc("d_a", fa, True), True)
                  + ref.l1(gen("g_ba", fb), a) + ref.l1(gen("g_ab", fa), b)
                  + ref.l1(gen("g_ab", b), b) + ref.l1(gen("g_ba", a), a))
        torch.autograd.grad(g_loss, [v for k, v in w.items() if k.startswith("g_")])
        fa, fb = fa.detach(), fb.detach()
        d_loss = (ref.lsgan(disc("d_a", a), True) + ref.lsgan(disc("d_a", fa), False)
                  + ref.lsgan(disc("d_b", b), True) + ref.lsgan(disc("d_b", fb), False))
        torch.autograd.grad(d_loss, [v for k, v in w.items() if k.startswith("d_")])

    leaves = [torch.empty(s, device="meta", requires_grad=True) for s in all_shapes]
    x = torch.empty((batch, 3, rcfg.size, rcfg.size), device="meta")
    run.extra["flops_per_unit"] = counts.count_flops(step, x, x.clone(), *leaves)
    run.extra["calls_per_unit"] = list(rec)


def reference(run, raws, ops=None):
    dev = run.device
    t = ref.CycleGANTrainer(run.ref_cfg(), seeded_weights(run, dev),
                            feed.generator(dev, run.seed, feed.DRAWS), ops=ops,
                            block=run.params["ref_block"])
    for a, b in raws:
        t.step(a, b)
    return t.readings()


def setup(run):
    return Driver(run)
