"""Cycle-GAN training on one card: the port's G/D step
(``train/gan.make_gan_train_step``) on two seeded uint8 pools on the card,
one a class, each batch cropped, flipped and normalised by the step.

Parameters: ``batch`` images a class; ``pool`` images a class of
``pool_side``² pixels; ``sync_every``, ``checked_steps``, ``warm_steps`` as
for ``train``. A unit is one step: ``2·batch`` images.

Readings: each checked step's generator and discriminator losses, the
first step's gradient by leaf of all four networks, each leaf's change over
the checked steps; the reference is ``reference/steps.CycleGANTrainer``.
"""

from __future__ import annotations

import torch

from perfbench.harness import compare, counts, feed
from perfbench.reference import model as ref_model
from perfbench.reference import steps as ref_steps

NETS = ("g_ab", "g_ba", "d_a", "d_b")


def shapes(rcfg):
    g = ref_model.denoiser_shapes(rcfg, normed=rcfg.g_norm == "instance")
    d = ref_model.discriminator_shapes(rcfg)
    return {"g_ab": g, "g_ba": g, "d_a": d, "d_b": d}


def _net(weights: dict, net: str) -> dict:
    """One network's entries of a four-network dict, its prefix cut."""
    return {k[len(net) + 1:]: v for k, v in weights.items() if k.startswith(net + ".")}


def seeded_weights(run, dev):
    """``g_ab.octaves.0.down.kernel``-style names over the four nets."""
    out = {}
    for tag, (net, sh) in enumerate(shapes(run.ref_cfg()).items()):
        for k, v in feed.weights(sh, dev, run.seed, tag).items():
            out[f"{net}.{k}"] = v
    return out


class Driver:
    def __init__(self, run):
        from gan_class_transfer2_tpu_torch.train import gan

        p = run.params
        dev = run.device
        self.run = run
        self.images, self.sync_every = 2 * p["batch"], p["sync_every"]
        cfg = run.port_cfg(batch_size=p["batch"])
        self.pools, self.orders = inputs(run)
        self.state = gan.init_gan_state(cfg, feed.generator(dev, run.seed, 0), device=dev)
        weights = seeded_weights(run, dev)
        for net in NETS:
            feed.load_into(getattr(self.state, net), _net(weights, net))
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
        run.phase("checked steps")
        for _ in range(p["warm_steps"]):
            self.unit()
        self.sync()
        run.phase("warm-up")

    def count(self):
        """The readers' counts, after the window (not set-up's work)."""
        count_flops(self.run, self.images // 2)

    def _step(self, idx):
        a, b = (pool.index_select(0, i) for pool, i in zip(self.pools, idx))
        self.state, self.metrics = self.step(self.state, a, b, self.gen)

    def unit(self):
        self._step([o.next() for o in self.orders])

    def sync(self):
        float(self.metrics["g_loss"])

    def free(self):
        self.state = self.step = self.metrics = None

    def raws(self):
        return [[pool.index_select(0, i) for pool, i in zip(self.pools, idx)] for idx in self.idx]

    def check(self):
        return compare_readings(self.run, self.readings, reference(self.run, self.raws()))


def inputs(run):
    """A seeded pool on the card a class, and the orders of their batches."""
    p = run.params
    return ([feed.pool(p["pool"], p["pool_side"], run.device, run.seed, c) for c in (0, 1)],
            [feed.Order(p["pool"], p["batch"], run.device, run.seed, c) for c in (0, 1)])


def calibrate(run, control=None):
    """As ``train.calibrate``: the checked steps' checks, no window."""
    if control is None:
        drv = Driver(run)
        got, raws = drv.readings, drv.raws()
        drv.free()
    else:
        pools, orders = inputs(run)
        raws = [[pool.index_select(0, o.next()) for pool, o in zip(pools, orders)]
                for _ in range(run.params["checked_steps"])]
        got = reference(run, raws, ops=control)
    ref = reference(run, raws)
    run.extra["readings"] = got, ref
    return compare_readings(run, got, ref)


def count_flops(run, batch):
    """The reference's FLOPs of one G/D step at the cell's batch, and the
    calls of its forwards (the norms the B3 roofline counts)."""
    rcfg = run.ref_cfg()
    rec = ref_model.Recorder()
    sh = shapes(rcfg)
    names = [f"{net}.{k}" for net in NETS for k in sh[net]]
    all_shapes = [sh[net][k] for net in NETS for k in sh[net]]

    def step(a, b, *leaves):
        w = dict(zip(names, leaves))

        def gen(name, x):
            return ref_model.denoiser(rcfg, _net(w, name), x, rec=rec,
                                      norm=rcfg.g_norm == "instance")

        def disc(name, x, const=False):
            d = _net(w, name)
            if const:
                d = {k: v.detach() for k, v in d.items()}
            return ref_model.discriminator(rcfg, d, x, rec=rec)

        fb, fa = gen("g_ab", a), gen("g_ba", b)
        g_loss = disc("d_b", fb, True).mean() + disc("d_a", fa, True).mean() + (
            gen("g_ba", fb) - a).abs().mean() + (gen("g_ab", fa) - b).abs().mean() + (
            gen("g_ab", b) - b).abs().mean() + (gen("g_ba", a) - a).abs().mean()
        g_leaves = [v for k, v in w.items() if k.startswith("g_")]
        torch.autograd.grad(g_loss, g_leaves)
        fa, fb = fa.detach(), fb.detach()
        d_loss = disc("d_a", a).mean() + disc("d_a", fa).mean() + disc("d_b", b).mean() + (
            disc("d_b", fb).mean())
        torch.autograd.grad(d_loss, [v for k, v in w.items() if k.startswith("d_")])

    leaves = [torch.empty(s, device="meta", requires_grad=True) for s in all_shapes]
    x = torch.empty((batch, 3, rcfg.size, rcfg.size), device="meta")
    run.extra["flops_per_unit"] = counts.count_flops(step, x, x.clone(), *leaves)
    run.extra["calls_per_unit"] = list(rec)


def reference(run, raws, ops=None):
    dev = run.device
    t = ref_steps.CycleGANTrainer(run.ref_cfg(), seeded_weights(run, dev),
                                  feed.generator(dev, run.seed, feed.DRAWS), ops=ops)
    losses = [t.step(a, b) for a, b in raws]
    return t.readings([(g, d) for g, d in zip(losses, t.losses_d)])


def compare_readings(run, got, ref):
    """The generator's and the discriminator's losses of each checked step
    count as the losses compared."""
    return compare.training_checks(got, ref, run.limits,
                                   [x for pair in got.losses for x in pair],
                                   [x for pair in ref.losses for x in pair])


def setup(run):
    return Driver(run)
