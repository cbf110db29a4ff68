"""Diffusion training on one card: the port's train step
(``train/trainer.make_train_step``) on batches of a seeded uint8 pool on the
card, cropped, flipped and normalised by the step itself.

Parameters (``workloads/<cell>.json``, ``params``): ``batch``; ``pool``
images of ``pool_side``² pixels; ``sync_every`` steps between loss
fetches; ``checked_steps`` compared with the reference; ``warm_steps``
further steps before the window; ``ref_block`` rows a reference block.

Set-up builds one train state from the seed, drives it through the checked
steps with the window's own call and feed (all rows of those steps
differ), takes the readings, warms up and hands the same state to the
window. The check runs the plain reference over the same steps after the
window, with the program freed.
"""

from __future__ import annotations

import torch

from perfbench.harness import compare, counts, feed
from perfbench.reference import model as ref_model
from perfbench.reference import steps as ref_steps


class Driver:
    """``mesh``: a data-parallel mesh of the port (``parallel/mesh``); the
    batches drawn are then the global batch's, and each rank steps on its
    rows (``traffic/train_dp.py``)."""

    def __init__(self, run, mesh=None):
        from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
        from gan_class_transfer2_tpu_torch.train import trainer

        p = run.params
        dev = run.device
        self.run = run
        self.images, self.sync_every = p["batch"], p["sync_every"]
        cfg = run.port_cfg(batch_size=p["batch"])
        rcfg = run.ref_cfg()
        self.shapes = ref_model.denoiser_shapes(rcfg)
        self.pool, self.order = inputs(run)
        weights = feed.weights(self.shapes, dev, run.seed)
        init = feed.generator(dev, run.seed, 0)
        if mesh is None:
            self.state = trainer.init_state(cfg, init, device=dev)
            self.step = trainer.make_train_step(cfg)
        else:
            self.state = mesh_lib.init_sharded_state(cfg, mesh, init)[0]
            self.step = mesh_lib.make_parallel_train_step(cfg, mesh)
        self.rows = lambda idx: mesh_lib.local_rows(idx, mesh)
        feed.load_into(self.state.model, weights)
        del weights
        run.phase("state and weights")
        self.gen = feed.generator(dev, run.seed, feed.DRAWS)
        self.loss = None
        self.idx = []

        def checked():
            self.idx.append(self.order.next().clone())
            self._step(self.idx[-1])
            return self.loss

        self.readings = feed.drive_checked_steps(
            checked, self.state.model.named_parameters, lambda: [self.state.opt_state],
            p["checked_steps"], float)
        run.phase("checked steps")
        for _ in range(p["warm_steps"]):
            self.unit()
        self.sync()
        run.phase("warm-up")

    def count(self):
        """The readers' counts, after the window (not set-up's work)."""
        count_flops(self.run, self.shapes, self.run.ref_cfg(), self.images)
        self.run.extra["param_numel"] = sum(q.numel() for q in self.state.model.parameters())

    def _step(self, idx):
        raw = self.pool.index_select(0, self.rows(idx))
        self.state, self.loss = self.step(self.state, raw, self.gen)

    def unit(self):
        self._step(self.order.next())

    def sync(self):
        float(self.loss)

    def free(self):
        self.state = self.step = self.loss = self.rows = None

    def raws(self):
        return [self.pool.index_select(0, i) for i in self.idx]

    def check(self):
        return compare_readings(self.run, self.readings, reference(self.run, self.raws()))


def inputs(run):
    """The seeded pool on the card and the order its batches are drawn in."""
    p = run.params
    return (feed.pool(p["pool"], p["pool_side"], run.device, run.seed),
            feed.Order(p["pool"], p["batch"], run.device, run.seed))


def calibrate(run, control=None):
    """The checks of the checked steps alone, no window: the program's, or
    with ``control`` (a rounding of ``reference/lowp.py``) the reference
    computed in it, put in the program's place."""
    if control is None:
        drv = Driver(run)
        got, raws = drv.readings, drv.raws()
        drv.free()
    else:
        pool, order = inputs(run)
        raws = [pool.index_select(0, order.next()) for _ in range(run.params["checked_steps"])]
        got = reference(run, raws, ops=control)
    ref = reference(run, raws)
    run.extra["readings"] = got, ref
    return compare_readings(run, got, ref)


def count_flops(run, shapes, rcfg, batch):
    """The reference's FLOPs of one train step (forward and backward) at the
    cell's batch, and the calls of its forward, for the readers."""
    rec = ref_model.Recorder()

    def step(x, *leaves):
        w = dict(zip(shapes, leaves))
        pred = ref_model.denoiser(rcfg, w, x, rec=rec)
        loss = torch.mean(torch.square(pred - x[:, :3]))
        torch.autograd.grad(loss, leaves)

    leaves = [torch.empty(s, device="meta", requires_grad=True) for s in shapes.values()]
    x = torch.empty((batch, 3, rcfg.size, rcfg.size), device="meta")
    run.extra["flops_per_unit"] = counts.count_flops(step, x, *leaves)
    run.extra["calls_per_unit"] = list(rec)
    run.extra["analytic_flops_per_unit"] = 3 * batch * counts.model_flops_per_image(rcfg)


def reference(run, raws, ops=None, ranks=1):
    """The plain reference over the checked steps: same weights, same draws
    from a generator seeded as the program's; ``ranks`` data ranks noise
    their rows as data parallelism does."""
    dev = run.device
    rcfg = run.ref_cfg()
    weights = feed.weights(ref_model.denoiser_shapes(rcfg), dev, run.seed)
    t = ref_steps.DiffusionTrainer(rcfg, weights, feed.generator(dev, run.seed, feed.DRAWS),
                                   ops=ops, block=run.params["ref_block"], ranks=ranks)
    for raw in raws:
        t.step(raw)
    return t.readings()


def compare_readings(run, got, ref):
    return compare.training_checks(got, ref, run.limits)


def setup(run):
    return Driver(run)
