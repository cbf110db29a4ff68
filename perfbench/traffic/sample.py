"""Reverse-diffusion sampling on one card: the port's
``sample/sampler.sample`` (``cfg.steps`` denoiser calls) on batches of seeded
noise, the final images kept on the card.

Parameters: ``batch`` images a sampler call; ``checked_calls`` calls of the
window, drawn from the seed once it has closed, compared image by image
with the plain reference's sampler from the same noise.

A unit is one sampler call; the window syncs after each, so it spans whole
calls, start of the first to end of the last.
"""

from __future__ import annotations

import math
import random

import torch

from perfbench.harness import compare, counts, feed
from perfbench.reference import model as ref_model
from perfbench.reference import steps as ref_steps


def noise(run, k: int, gen):
    """The noise of the window's k-th call (k = −1: the warm-up's), drawn on
    the card."""
    c = run.ref_cfg()
    gen.manual_seed(feed.sub_seed(run.seed, feed.NOISE, k + 1))
    return torch.randn((run.params["batch"], c.size, c.size, 3), generator=gen,
                       device=run.device)


class Driver:
    def __init__(self, run):
        from gan_class_transfer2_tpu_torch.models import api
        from gan_class_transfer2_tpu_torch.sample import sampler

        p = run.params
        dev = self.dev = run.device
        self.run, self.sampler = run, sampler
        self.images, self.sync_every = p["batch"], 1
        cfg = self.cfg = run.port_cfg(batch_size=p["batch"])
        rcfg = run.ref_cfg()
        shapes = ref_model.denoiser_shapes(rcfg)
        self.model = api.build_denoiser(cfg).to(dev).requires_grad_(False)
        feed.load_into(self.model, feed.weights(shapes, dev, run.seed))
        run.phase("state and weights")
        self.gen = torch.Generator(device=dev)
        self.outputs = []
        sampler.sample(cfg, self.model, noise(run, -1, self.gen), snapshots=False)
        run.phase("warm-up")
        self.shapes = shapes

    def count(self):
        """The readers' counts, after the window (not set-up's work)."""
        count_flops(self.run, self.shapes, self.run.ref_cfg(), self.images)

    def unit(self):
        k = len(self.outputs)
        out = self.sampler.sample(self.cfg, self.model, noise(self.run, k, self.gen),
                                  snapshots=False).images
        self.outputs.append(out)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def free(self):
        self.model = None

    def check(self):
        run = self.run
        picks = sorted(random.Random(run.seed).sample(range(len(self.outputs)),
                                                      min(run.params["checked_calls"],
                                                          len(self.outputs))))
        got = {k: self.outputs[k] for k in picks}
        self.outputs = None
        return compare_images(run, got, reference(run, picks))


def calibrate(run, control=None):
    """The checks of the first ``checked_calls`` calls, no window: the
    program's, or the reference computed in ``control``'s rounding."""
    picks = list(range(run.params["checked_calls"]))
    if control is None:
        drv = Driver(run)
        for _ in picks:
            drv.unit()
        got = dict(enumerate(drv.outputs))
        drv.free()
    else:
        got = reference(run, picks, ops=control)
    return compare_images(run, got, reference(run, picks))


def count_flops(run, shapes, rcfg, batch):
    """One sampler call's FLOPs: ``steps`` forwards of the reference's
    denoiser at the cell's batch, and one forward's calls for the readers."""
    rec = ref_model.Recorder()

    def forward(x, *leaves):
        with torch.no_grad():
            ref_model.denoiser(rcfg, dict(zip(shapes, leaves)), x, rec=rec)

    leaves = [torch.empty(s, device="meta") for s in shapes.values()]
    x = torch.empty((batch, 3, rcfg.size, rcfg.size), device="meta")
    per_call = counts.count_flops(forward, x, *leaves)
    run.extra["flops_per_unit"] = rcfg.steps * per_call
    run.extra["calls_per_unit"] = list(rec) * rcfg.steps
    run.extra["analytic_flops_per_unit"] = rcfg.steps * batch * counts.model_flops_per_image(rcfg)


def reference(run, picks, ops=None):
    """The plain sampler's final images for the noise of calls ``picks``."""
    rcfg = run.ref_cfg()
    weights = feed.weights(ref_model.denoiser_shapes(rcfg), run.device, run.seed)
    gen = torch.Generator(device=run.device)
    return {k: ref_steps.sample(rcfg, weights, noise(run, k, gen), ops) for k in picks}


def image_gaps(got: dict, ref: dict) -> list:
    """Each image's RMS difference over the reference image's RMS."""
    gaps = []
    for k, r in ref.items():
        g = got.get(k)
        if g is None:
            return [float("inf")]
        d = torch.sqrt(torch.mean(torch.square(g.float() - r), dim=(1, 2, 3)))
        s = torch.sqrt(torch.mean(torch.square(r), dim=(1, 2, 3)))
        gaps += [x if math.isfinite(x) else float("inf") for x in (d / s).tolist()]
    return gaps


def compare_images(run, got, ref):
    return [compare.check("image_gap", max(image_gaps(got, ref)), run.limits["image_gap"])]


def setup(run):
    return Driver(run)
