"""Pipeline parallelism over the U-Net's octave bands — counterpart of
gan_class_transfer2_tpu/parallel/pipeline.py.

Stages own contiguous octave bands, so every skip connection stays
stage-local and only the boundary activation crosses a stage::

    stage 0:   pre_block · octaves [0, k₁) · post_block · head · loss
    stage s:   octaves [kₛ, kₛ₊₁)
    stage S-1: its band + middle

One microbatch visits 0 → 1 → … → S-1 → … → 1 → 0. The forward of every
microbatch runs first, without autograd, and stashes each stage's input and
its stage-local skips; the backward runs in reverse microbatch order, each
stage recomputing its forward under autograd and calling
``torch.autograd.grad`` with the cotangents from downstream (GPipe remat,
as JAX's ``jax.vjp`` inside each jitted stage VJP), once for all of its
replicas. The recompute holds its own ``unet.ieee_fp32`` region: it runs
outside the forward's.

Semantics: exactly the one-process ``trainer.train_step`` at the same
global batch. The draws are made once for the full batch on stage 0's
device by the same helpers (``trainer.fold_and_augment``,
``trainer.draw_and_diffuse``) from the run's generator, so a pipeline run
and a one-process run from one generator state draw the same t and ε (and
B1 runs once a step); microbatch losses are equally weighted means with
cotangent 1/M; the global-norm clip is taken across stages (pre-scaled by
``clip/max(‖g‖, clip)``, after which each stage's clip is a no-op); each
stage applies its own optimizer update (B2 on its leaves under
``adam_fused``) and blends its EMA.

The state is a plain ``trainer.TrainState``, so checkpoints interchange with
the one-process path. ``place_state`` moves each stage's submodules of the
Denoiser to the stage's device (in place) and every list the length of the
parameter list (EMA, Adam's moments, a momentum trace) entry by entry after
its parameter; scalar leaves (counts) live on stage 0's device and are
copied to each stage for its update, stage 0's result kept.

Devices: stage s runs on ``devices[s·dp:(s+1)·dp]``, from
``parallel/mesh.local_devices``; one device (one card, the CPU) holds every
stage. A boundary activation (an ``(h, skip)`` pair under
``concat_elision``) moves to the next stage's device with a non-blocking
copy. PP × DP (``mesh_data`` > 1): JAX gives each stage a data mesh of its
own in one process; here each stage has in-process replicas on its ``dp``
devices (as ``LocalMesh`` serves), each microbatch's rows split over them.
Each stage's gradients are summed onto its first device before the
update, and the updated weights are copied back to the replicas. Batch
norms (``g_norm="batch"``) take their statistics over the whole
microbatch, as JAX's stage program over its data devices does: each
replica runs in a thread of its own with its device current (threads
kept while the trainer lives, so each keeps its cuDNN plans), and the
replicas sum each norm's per-channel sums, count and centred squares
between them (``ops/norm.ReplicaGroup``, the two-pass formula of
``batch_norm`` over ranks). The threads take turns on the host, one at a
time from one norm to the next, so only their devices' work overlaps.
That sum is a plain differentiable op, so the one ``autograd.grad`` of a
stage program, called from the calling thread, carries its adjoint as a
graph edge: no replica waits for another inside the backward, which on
the card runs on autograd's one thread a device and would deadlock
replicas sharing one. Without batch norm the replicas run in turn from
the calling thread (threads measured no faster on one card; PERF.md §6).
Single-process, as JAX's.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import queue
import threading
import weakref
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..models import unet
from ..models.api import resolve_device
from ..ops import adam_kernel
from ..ops import norm as norm_ops
from . import mesh as mesh_lib
from . import multihost

# --------------------------------------------------------------------- plan


def octave_costs(cfg, in_channels: int = 3) -> Tuple[int, List[int], int]:
    """(outer_macs, per_octave_macs, middle_macs) — MACs per image
    (pipeline.py:74): octave i owns its down conv, block_in, block_out, up
    conv (and the residual skip dense); 'outer' the pre/post blocks and the
    head."""

    def block(spatial, cin, filters, depth):
        m, c = 0, cin
        for _ in range(depth):
            m += spatial * spatial * 9 * c * filters
            c = filters
        return m, c

    outer, c = block(cfg.size, in_channels, cfg.pixel_size, cfg.block_depth)
    per = [0] * cfg.octaves
    skip = []
    for i in range(cfg.octaves):
        f = cfg.octave_filters(i)
        skip.append(c)
        s_half = cfg.size >> (i + 1)
        per[i] += s_half * s_half * 16 * c * f  # down 4×4/s2
        m, c = block(s_half, f, f, cfg.block_depth)
        per[i] += m
    mid, c = block(cfg.size >> cfg.octaves, c, cfg.middle_filters(), cfg.block_depth)
    for i in reversed(range(cfg.octaves)):
        f = cfg.octave_filters(i)
        u = cfg.octave_up_filters(i)
        s_half = cfg.size >> (i + 1)
        m, c = block(s_half, c, f, cfg.block_depth)
        per[i] += m
        per[i] += s_half * s_half * 16 * c * u  # up convT 4×4/s2
        c = u
        if cfg.skip_mode == "concat":
            c += skip[i]
        elif cfg.skip_mode == "residual":
            per[i] += (cfg.size >> i) ** 2 * c * skip[i]
            c = skip[i]
    m, c = block(cfg.size, c, cfg.pixel_size, cfg.block_depth)
    outer += m
    outer += cfg.size * cfg.size * c * cfg.out_channels()  # head dense
    return outer, per, mid


def plan_stages(cfg, n_stages: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous octave bands minimising the max per-stage MACs
    (pipeline.py:118): ((0, k₁), (k₁, k₂), …, (k_{S-1}, octaves)), by brute
    force over the cut placements. ``cfg.pipeline_cuts`` pins the cuts."""
    if not 1 <= n_stages <= cfg.octaves:
        raise ValueError(
            f"pipeline_stages={n_stages} needs 1 <= stages <= octaves={cfg.octaves}")
    if cfg.pipeline_cuts:
        cuts = tuple(int(c) for c in cfg.pipeline_cuts.split(","))
        if len(cuts) != n_stages - 1:
            raise ValueError(
                f"pipeline_cuts={cfg.pipeline_cuts!r} has {len(cuts)} cuts; "
                f"{n_stages} stages need {n_stages - 1}")
        bounds = (0,) + cuts + (cfg.octaves,)
        return tuple((bounds[s], bounds[s + 1]) for s in range(n_stages))
    outer, per, mid = octave_costs(cfg)
    best, best_cost = None, None
    for cuts in itertools.combinations(range(1, cfg.octaves), n_stages - 1):
        bounds = (0,) + cuts + (cfg.octaves,)
        cost = 0
        for s in range(n_stages):
            c = sum(per[bounds[s]:bounds[s + 1]])
            if s == 0:
                c += outer
            if s == n_stages - 1:
                c += mid
            cost = max(cost, c)
        if best_cost is None or cost < best_cost:
            best, best_cost = bounds, cost
    return tuple((best[s], best[s + 1]) for s in range(n_stages))


# ------------------------------------------------------ stage views of lists


def stage_of(name: str, plan) -> int:
    """The stage that owns the Denoiser parameter ``name`` (its
    ``named_parameters`` name): the outer blocks and the head stage 0, the
    middle the last stage, ``octaves.i.…`` the stage whose band holds i."""
    head = name.split(".", 1)[0]
    if head in ("pre_block", "post_block", "head"):
        return 0
    if head == "middle":
        return len(plan) - 1
    i = int(name.split(".")[1])
    for s, (lo, hi) in enumerate(plan):
        if lo <= i < hi:
            return s
    raise ValueError(f"octave {i} is in no stage of {plan}")


def stage_indices(model: nn.Module, plan) -> List[List[int]]:
    """Per stage, the indices into ``model.parameters()`` of the parameters
    it owns, ascending: the stage view of every list parallel to the
    parameters (EMA, Adam's moments)."""
    out: List[List[int]] = [[] for _ in plan]
    for i, (name, _) in enumerate(model.named_parameters()):
        out[stage_of(name, plan)].append(i)
    return out


def tree_stage_view(index, tree: list, s: int) -> list:
    """Stage s's entries of a list parallel to the parameters
    (pipeline.py:162); the tensors are referenced, not copied."""
    return [tree[i] for i in index[s]]


def tree_stage_merge(index, full: list, s: int, sub: list) -> list:
    """Inverse of ``tree_stage_view``: a new list with stage s's entries
    replaced by ``sub``'s."""
    out = list(full)
    for i, v in zip(index[s], sub):
        out[i] = v
    return out


def _rewrite_state(obj, n: int, list_fn, leaf_fn):
    """Walk an optimizer state (NamedTuples, tuples, lists): ``list_fn`` on
    every list of ``n`` entries (one per parameter), ``leaf_fn`` on every
    other leaf (counts, ints)."""
    if isinstance(obj, list) and len(obj) == n:
        return list_fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_rewrite_state(v, n, list_fn, leaf_fn) for v in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rewrite_state(v, n, list_fn, leaf_fn) for v in obj)
    return leaf_fn(obj)


def _merge_opt(full, stage, index, s: int, take_scalar: bool):
    """A stage's updated optimizer state merged into the full one
    (pipeline.py:727): its lists' entries through ``tree_stage_merge``;
    scalar leaves (counts, which every stage advances alike) from stage 0
    only."""
    n = sum(len(ix) for ix in index)
    if isinstance(full, list) and len(full) == n:
        return tree_stage_merge(index, full, s, stage)
    if isinstance(full, tuple) and hasattr(full, "_fields"):
        return type(full)(*[_merge_opt(f, g, index, s, take_scalar)
                            for f, g in zip(full, stage)])
    if isinstance(full, (tuple, list)):
        return type(full)(_merge_opt(f, g, index, s, take_scalar) for f, g in zip(full, stage))
    return stage if take_scalar else full


class Stage(nn.Module):
    """Stage s's part of a Denoiser: the Denoiser's own submodules (not
    copies), registered in its order, so ``parameters()`` lists them as
    ``tree_stage_view`` does."""

    def __init__(self, model, plan, s: int):
        super().__init__()
        lo, hi = plan[s]
        first, last = s == 0, s == len(plan) - 1
        if first:
            self.pre_block = model.pre_block
        self.octaves = nn.ModuleList(list(model.octaves[lo:hi]))
        if last:
            self.middle = model.middle
        if first:
            self.post_block = model.post_block
            self.head = model.head


# ----------------------------------------------------------- stage programs


def _stage_down(cfg, sm: Stage, h, first: bool):
    """(h_out, skips) of a stage's descent; stage 0 casts to the compute
    dtype and applies pre_block first (unet_apply's head)."""
    dtype = unet.DTYPES[cfg.compute_dtype]
    if first:
        h = unet._conv_relu(sm.pre_block, h.to(dtype), dtype)
    skips = []
    for level in sm.octaves:
        h, inp = unet.octave_down(cfg, level, h, dtype)
        skips.append(inp)
    return h, skips


def _stage_mid(cfg, sm: Stage, h):
    """The last stage: its band's descents, the middle block and its
    band's ascents in one program."""
    dtype = unet.DTYPES[cfg.compute_dtype]
    h, skips = _stage_down(cfg, sm, h, first=False)
    h = unet._conv_relu(sm.middle, h, dtype)
    return _stage_up(cfg, sm, h, skips)


def _stage_up(cfg, sm: Stage, h, skips):
    dtype = unet.DTYPES[cfg.compute_dtype]
    for level, inp in zip(reversed(list(sm.octaves)), reversed(skips)):
        h = unet.octave_up(cfg, level, h, inp, dtype)
    return h


def _stage_loss(cfg, sm: Stage, h, skips, target, pred_scale, t_b):
    """Stage 0's ascent, head and loss: the tail of
    ``trainer.diffusion_loss``, the float32 mean over the rows given."""
    from ..train import trainer

    dtype = unet.DTYPES[cfg.compute_dtype]
    h = _stage_up(cfg, sm, h, skips)
    pred = unet.unet_head(cfg, sm, h, t_b, dtype)
    return trainer.compute_loss(cfg, target, pred.to(torch.float32) * pred_scale)


# ------------------------------------------------------------ tree helpers


def _flat(h) -> list:
    return list(h) if isinstance(h, (tuple, list)) else [h]


def _like(h, leaves):
    return tuple(leaves) if isinstance(h, tuple) else leaves[0]


def _to(h, device):
    """``h`` (a tensor, an ``(h, skip)`` pair, or a Python number) on
    ``device``: a non-blocking copy across devices, ``h`` itself on its
    own (no host sync: the step's pace stays the cards')."""
    if not isinstance(h, (torch.Tensor, tuple)):
        return h
    return _like(h, [x.to(device, non_blocking=True) for x in _flat(h)])


def _leaf(h, grad: bool):
    """``h`` detached, as autograd inputs of a stage's recompute."""
    return _like(h, [x.detach().requires_grad_(grad) for x in _flat(h)])


def _on(device):
    """``device`` current for the launches of the block (the kernels'
    ctypes wrappers launch on the current stream of the tensor's device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _ReplicaThreads:
    """One thread a replica, kept while its trainer lives: the PyTorch
    state a thread keeps for itself (cuDNN's execution plans among it)
    then serves every step, where threads made afresh for each stage
    program would build it again each time."""

    def __init__(self, n: int):
        self._inbox = [queue.SimpleQueue() for _ in range(n)]
        self._done: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = [threading.Thread(target=self._serve, args=(r,), name=f"replica-{r}",
                                          daemon=True) for r in range(n)]
        for t in self._threads:
            t.start()

    def _serve(self, r: int):
        while True:
            job = self._inbox[r].get()
            if job is None:
                return
            job(r)
            # hold nothing of the step while waiting: the job's closure
            # reaches the trainer, which must stay free to go
            job = None
            self._done.put(r)

    def run(self, job):
        """``job(r)`` handed to every replica's thread; returns when all
        have ended (``job`` keeps its own errors)."""
        for q in self._inbox:
            q.put(job)
        for _ in self._inbox:
            self._done.get()

    def stop(self):
        """End the threads (when the trainer goes, or at exit; a collection
        that a replica's own thread runs leaves that thread to end alone)."""
        for q in self._inbox:
            q.put(None)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()


def _each_replica(fn, n: int, group, threads) -> list:
    """``[fn(r) for r in range(n)]``: on ``threads`` (a ``_ReplicaThreads``),
    each replica on its own thread under the caller's grad mode, in
    ``group``'s statistics (``ops/norm.over_replicas``: the threads take
    turns between the norms' sums), the caller waiting for all; without,
    in turn from the caller's thread. A replica that raises breaks the
    group's waits, and the first error (not a broken wait) is raised
    here."""
    if threads is None:
        return [fn(r) for r in range(n)]
    grad = torch.is_grad_enabled()
    out, errors = [None] * n, [None] * n

    def job(r):
        try:
            with torch.set_grad_enabled(grad), norm_ops.over_replicas(group, r):
                out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            errors[r] = e

    threads.run(job)
    if group is not None:
        group.clear()
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return out


@contextlib.contextmanager
def _recompute(device):
    """A stage's recompute and backward on ``device``: autograd on, in IEEE
    float32 of its own (the no-grad forward's region has closed)."""
    with _on(device), torch.enable_grad(), unet.ieee_fp32(torch.float32, device):
        yield


# ------------------------------------------------------------------- trainer


def _validate(cfg) -> None:
    """JAX's refusals (pipeline.py:289-328), word for word."""
    if cfg.pipeline_stages < 2:
        raise ValueError("PipelineTrainer needs pipeline_stages >= 2")
    if multihost.process_count() > 1:
        raise ValueError(
            "pipeline parallelism is single-process (stage meshes need "
            "locally addressable devices); use DP/ZeRO-1 across hosts")
    if cfg.num_classes > 0:
        raise ValueError("pipeline parallelism supports the unconditional "
                         "Denoiser only (num_classes == 0)")
    if cfg.mesh_model != 1 or cfg.mesh_slice != 1:
        raise ValueError("pipeline_stages > 1 composes with neither TP nor "
                         "multi-slice meshes (mesh_model = mesh_slice = 1)")
    if cfg.zero1:
        raise ValueError("pipeline_stages > 1 already partitions optimizer "
                         "state by stage; zero1 is unsupported")
    if cfg.grad_accum > 1:
        raise ValueError("pipeline microbatching IS gradient accumulation; "
                         "use pipeline_microbatches, not grad_accum")
    if cfg.dynamic_loss_scale or cfg.loss_scale > 0:
        raise ValueError("loss scaling is unsupported on the pipeline path "
                         "(bf16 on TPU needs none)")
    m = cfg.pipeline_microbatches or cfg.pipeline_stages
    if cfg.batch_size % m != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} not divisible by "
            f"pipeline_microbatches={m}")
    dp = max(cfg.mesh_data, 1)
    if dp > 1 and (cfg.batch_size // m) % dp != 0:
        raise ValueError(
            f"PP x DP needs the microbatch (batch_size={cfg.batch_size} / "
            f"microbatches={m} = {cfg.batch_size // m}) divisible by "
            f"mesh_data={dp}")


class PipelineTrainer:
    """The stage plan, the stage devices and the step (pipeline.py:331).

    ``step(state, batch, generator) -> (state, loss)`` with the one-process
    train-step semantics; ``state`` is a ``trainer.TrainState`` whose
    leaves live on the stage devices (``place_state`` after a restore;
    ``gather_params`` before the sampler, which needs one device)."""

    def __init__(self, cfg, devices: Sequence | None = None, device="cuda"):
        from ..train import trainer

        cfg.validate()
        _validate(cfg)
        self.cfg = cfg
        self.n_stages = cfg.pipeline_stages
        self.n_micro = cfg.pipeline_microbatches or cfg.pipeline_stages
        self.plan = plan_stages(cfg, self.n_stages)
        self.dp = max(cfg.mesh_data, 1)
        # of the last step: rows each replica's stage forward ran
        # ([stage][replica]), autograd.grad calls, the replica group's sums
        # (two a batch norm)
        self.counts: dict = {}
        self._threads = None  # the replicas' threads, made at their first use
        need = self.n_stages * self.dp
        if devices is None:
            devices = mesh_lib.local_devices(resolve_device(device))
        devices = [mesh_lib._indexed(resolve_device(d)) for d in devices]
        if len(devices) == 1:
            devices = devices * need  # one card (or the CPU) holds every stage
        if len(devices) < need:
            raise ValueError(
                f"pipeline_stages={self.n_stages} x mesh_data={self.dp} "
                f"needs {need} devices, have {len(devices)}")
        self.stage_devices = [devices[s * self.dp:(s + 1) * self.dp]
                              for s in range(self.n_stages)]
        self.devices = [row[0] for row in self.stage_devices]
        self.optimizer = trainer.make_optimizer(cfg)
        self._model = None
        self._stages: list = []  # [stage][replica] -> Stage
        self._index: list = []

    # ------------------------------------------------------------- placement
    def _bind(self, model) -> None:
        """Stage views of ``model`` and their replicas (copies of the
        stage's current weights on its other devices, which autograd may
        differentiate)."""
        self._model = model
        self._index = stage_indices(model, self.plan)
        self._stages = []
        for s in range(self.n_stages):
            primary = Stage(model, self.plan, s)
            reps = [copy.deepcopy(primary).to(d) for d in self.stage_devices[s][1:]]
            self._stages.append([primary] + reps)

    def place_state(self, state):
        """Every leaf of ``state`` on its stage's first device: each stage's
        submodules of the model moved in place, each list parallel to the
        parameters (EMA, optimizer moments) entry by entry, scalar leaves
        on stage 0's device; the replicas copied afresh from the weights."""
        from ..train import trainer

        model = state.model
        index = stage_indices(model, self.plan)
        with torch.no_grad():
            for s in range(self.n_stages):
                Stage(model, self.plan, s).to(self.devices[s])
        n = sum(len(ix) for ix in index)
        dev_of = [0] * n
        for s, ix in enumerate(index):
            for i in ix:
                dev_of[i] = self.devices[s]

        def place_list(lst):
            return [t.to(d) for t, d in zip(lst, dev_of)]

        def place_leaf(leaf):
            return leaf.to(self.devices[0]) if isinstance(leaf, torch.Tensor) else leaf

        opt = _rewrite_state(state.opt_state, n, place_list, place_leaf)
        ema = place_list(state.ema_params) if state.ema_params is not None else None
        self._bind(model)
        return trainer.TrainState(state.step, model, opt, ema, state.scale_state)

    def init_state(self, generator: torch.Generator | None = None):
        """``trainer.init_state`` (weights from ``generator``, a CPU
        generator seeded with ``cfg.seed`` by default, as one process draws
        them), placed."""
        from ..train import trainer

        return self.place_state(trainer.init_state(self.cfg, generator, device=self.devices[0]))

    def gather_params(self, tree, device=None):
        """A params tree whole on one device (stage 0's first by default):
        a module, itself when every parameter already lives there (one
        card, the CPU), else a copy; a list parallel to the parameters, its
        tensors there."""
        dev = torch.device(device) if device is not None else self.devices[0]
        if isinstance(tree, nn.Module):
            if all(p.device == dev for p in tree.parameters()):
                return tree
            return copy.deepcopy(tree).to(dev)
        return [t.to(dev) for t in tree]

    # ------------------------------------------------------------------ prep
    def _prep(self, batch, generator):
        """Full-batch draws, forward diffusion and target on stage 0's first
        device through the one-process step's own helpers
        (``trainer.fold_and_augment``, ``trainer.draw_and_diffuse``), so the
        draws are the one-process step's: ``(noised, target float32,
        pred_scale (a float, or a float32 tensor), t (B,))``."""
        from ..train import trainer

        cfg = self.cfg
        batch = trainer._image(batch).to(self.devices[0])
        batch = trainer.fold_and_augment(cfg, batch, generator)
        noised, target, pred_scale, t_int = trainer.draw_and_diffuse(cfg, batch, generator)
        return noised, target.to(torch.float32), pred_scale, t_int[:, 0, 0, 0]

    # ------------------------------------------------------------------ step
    def step(self, state, batch, generator):
        """One optimizer step: ``(new_state, loss)``, the loss a float32
        tensor on stage 0's first device (no host sync)."""
        return self.step_from_draws(state, *self._prep(batch, generator))

    def step_from_draws(self, state, noised, target, pred_scale, t_b):
        """The step after the draws: ``noised``, ``target``, ``pred_scale``
        and ``t_b`` as ``_prep`` returns them (or as JAX's
        ``PipelineTrainer._prep`` does, for parity)."""
        from ..train import trainer

        cfg = self.cfg
        S, M, D = self.n_stages, self.n_micro, self.dp
        dev0 = self.devices[0]
        noised, target, t_b = noised.to(dev0), target.to(dev0), t_b.to(dev0)
        if isinstance(pred_scale, torch.Tensor):  # a Python float stays one: no copy
            pred_scale = pred_scale.to(dev0, torch.float32)
        b = noised.shape[0]
        if b == 0 or b % M:
            raise ValueError(
                f"pipeline step needs the batch ({b}) divisible by "
                f"pipeline_microbatches={M}")
        if (b // M) % D:
            raise ValueError(
                f"PP x DP needs the microbatch ({b // M}) divisible by mesh_data={D}")
        if state.model is not self._model:
            self._bind(state.model)
        stages, index = self._stages, self._index
        rows = b // (M * D)
        # batch norm's statistics span a microbatch's replicas: their
        # threads sum them at each norm
        group = norm_ops.ReplicaGroup(D) if D > 1 and cfg.g_norm == "batch" else None
        if group is not None and self._threads is None:
            self._threads = _ReplicaThreads(D)
            weakref.finalize(self, self._threads.stop)
        threads = None if group is None else self._threads
        counts = self.counts = {"rows": [[0] * D for _ in range(S)], "grads": 0}

        def part(x, m, r):  # microbatch m's rows on replica r
            if not isinstance(x, torch.Tensor) or x.ndim == 0:
                return x
            i = (m * D + r) * rows
            return x[i:i + rows]

        def dev(s, r):
            return self.stage_devices[s][r]

        def each(fn):
            return _each_replica(fn, D, group, threads)

        # ---- forward: every microbatch's chain, without autograd; stash
        # each stage's inputs and its stage-local skips
        x_in = [[[None] * D for _ in range(S)] for _ in range(M)]
        skips = [[[None] * D for _ in range(S)] for _ in range(M)]
        h_up = [[[None] * D for _ in range(S)] for _ in range(M)]

        def forward(r):
            for m in range(M):
                h = _to(part(noised, m, r), dev(0, r))
                for s in range(S - 1):
                    x_in[m][s][r] = h
                    counts["rows"][s][r] += h.shape[0]
                    with _on(dev(s, r)):
                        h, skips[m][s][r] = _stage_down(cfg, stages[s][r], h, s == 0)
                    h = _to(h, dev(s + 1, r))
                x_in[m][S - 1][r] = h
                counts["rows"][S - 1][r] += h.shape[0]
                with _on(dev(S - 1, r)):
                    h = _stage_mid(cfg, stages[S - 1][r], h)
                for s in range(S - 2, -1, -1):
                    h_up[m][s][r] = h = _to(h, dev(s, r))
                    if s > 0:
                        with _on(dev(s, r)):
                            h = _stage_up(cfg, stages[s][r], h, skips[m][s][r])

        with torch.no_grad(), unet.ieee_fp32(torch.float32, dev0):
            each(forward)

        # ---- backward in reverse microbatch order: each stage recomputes
        # its forward under autograd, every replica's, and one
        # ``autograd.grad`` from this thread takes the gradients of all the
        # replicas' parameters and inputs for the cotangents from downstream
        # (under batch norm the replicas' graphs meet at the norms' sums)
        g: list = [None] * S
        losses = []

        def acc(s, grads):
            grads = [None if x is None else _to(x, self.devices[s]) for x in grads]
            if g[s] is None:
                g[s] = grads
            else:
                g[s] = [a if x is None else (x if a is None else a + x)
                        for a, x in zip(g[s], grads)]

        def grad(s, outputs, inputs, cts):
            """``outputs``, ``inputs`` and ``cts``: a list for each replica;
            returns the inputs' gradients, a list for each replica."""
            params = [list(stages[s][r].parameters()) for r in range(D)]
            # an output that needs no gradient (stage 0's first skip without
            # a pre_block: the noised input itself) passes no cotangent
            live = [(o, torch.zeros_like(o) if c is None else c)
                    for r in range(D) for o, c in zip(outputs[r], cts[r]) if o.requires_grad]
            wrt = [x for r in range(D) for x in params[r] + inputs[r]]
            with _recompute(dev(s, 0)):
                out = torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                          allow_unused=True)
            counts["grads"] += 1
            ins, k = [], 0
            for r in range(D):
                n = len(params[r])
                acc(s, out[k:k + n])
                ins.append(list(out[k + n:k + n + len(inputs[r])]))
                k += n + len(inputs[r])
            return ins

        ct = torch.full((), 1.0 / (M * D), dtype=torch.float32, device=dev0)
        h_ct = [None] * D
        for m in range(M - 1, -1, -1):
            def loss_program(r):
                d0 = dev(0, r)
                with _recompute(d0):
                    hi = _leaf(h_up[m][0][r], True)
                    si = [_leaf(x, True) for x in skips[m][0][r]]
                    loss = _stage_loss(cfg, stages[0][r], hi, si, _to(part(target, m, r), d0),
                                       _to(part(pred_scale, m, r), d0), _to(part(t_b, m, r), d0))
                return hi, si, loss

            rec = each(loss_program)
            outs = grad(0, [[loss] for _, _, loss in rec], [_flat(hi) + si for hi, si, _ in rec],
                        [[_to(ct, dev(0, r))] for r in range(D)])
            loss_m = [_to(loss.detach(), dev0) for _, _, loss in rec]
            losses.append(sum(loss_m[1:], loss_m[0]) / D)
            sk_ct = [[None] * S for _ in range(D)]
            for r, (hi, _, _) in enumerate(rec):
                nh = len(_flat(hi))
                h_ct[r], sk_ct[r][0] = _like(hi, outs[r][:nh]), outs[r][nh:]
            for s in range(1, S - 1):
                def up_program(r, s=s):
                    with _recompute(dev(s, r)):
                        hi = _leaf(h_up[m][s][r], True)
                        si = [_leaf(x, True) for x in skips[m][s][r]]
                        return hi, si, _stage_up(cfg, stages[s][r], hi, si)

                rec = each(up_program)
                outs = grad(s, [_flat(ho) for _, _, ho in rec],
                            [_flat(hi) + si for hi, si, _ in rec],
                            [_flat(_to(h_ct[r], dev(s, r))) for r in range(D)])
                for r, (hi, _, _) in enumerate(rec):
                    nh = len(_flat(hi))
                    h_ct[r], sk_ct[r][s] = _like(hi, outs[r][:nh]), outs[r][nh:]

            def mid_program(r):
                with _recompute(dev(S - 1, r)):
                    x = _leaf(x_in[m][S - 1][r], True)
                    return x, _stage_mid(cfg, stages[S - 1][r], x)

            rec = each(mid_program)
            outs = grad(S - 1, [_flat(ho) for _, ho in rec], [[x] for x, _ in rec],
                        [_flat(_to(h_ct[r], dev(S - 1, r))) for r in range(D)])
            x_ct = [o[0] for o in outs]
            for s in range(S - 2, -1, -1):
                def down_program(r, s=s):
                    with _recompute(dev(s, r)):
                        x = _leaf(x_in[m][s][r], s > 0)
                        return x, _stage_down(cfg, stages[s][r], x, s == 0)

                rec = each(down_program)
                outs = grad(s, [[ho, *so] for _, (ho, so) in rec],
                            [[x] if s > 0 else [] for x, _ in rec],
                            [[_to(x_ct[r], dev(s, r)), *sk_ct[r][s]] for r in range(D)])
                if s > 0:
                    x_ct = [o[0] for o in outs]
            # this microbatch's stash is dead once its backward has drained
            x_in[m] = skips[m] = h_up[m] = None
        counts["sums"] = 0 if group is None else group.sums

        grads = [[torch.zeros_like(p) if x is None else x
                  for x, p in zip(g[s], stages[s][0].parameters())] for s in range(S)]

        # ---- the global-norm clip across stages (pipeline.py:439-461)
        if cfg.grad_clip_norm > 0:
            sq = sum(sum(torch.sum(x * x) for x in grads[s]).to(dev0) for s in range(S))
            clip = cfg.grad_clip_norm
            factor = clip / torch.sqrt(sq).clamp(min=clip)  # clip / max(‖g‖, clip)
            grads = [[x * factor.to(self.devices[s], x.dtype) for x in grads[s]]
                     for s in range(S)]

        # ---- one optimizer update per stage, then its EMA and replicas
        n = sum(len(ix) for ix in index)
        fused = adam_kernel.fused_adam_ok(cfg)
        new_opt, ema = state.opt_state, state.ema_params
        for s in range(S):
            d = self.devices[s]
            params = list(stages[s][0].parameters())
            opt_s = _rewrite_state(
                state.opt_state, n, lambda lst, s=s: tree_stage_view(index, lst, s),
                lambda leaf, d=d: leaf.to(d) if isinstance(leaf, torch.Tensor) else leaf)
            with _on(d):
                if fused:
                    new_o = adam_kernel.fused_adam_apply(
                        cfg, params, opt_s, [x.contiguous() for x in grads[s]])
                else:
                    new_o = trainer.update_params(self.optimizer, opt_s, params, grads[s])
            new_opt = _merge_opt(new_opt, new_o, index, s, take_scalar=(s == 0))
            with torch.no_grad():
                if ema is not None:
                    k = cfg.ema_decay
                    blended = [e * k + p * (1.0 - k)
                               for e, p in zip(tree_stage_view(index, ema, s), params)]
                    ema = tree_stage_merge(index, ema, s, blended)
                for rep in stages[s][1:]:
                    for pr, p in zip(rep.parameters(), params):
                        pr.copy_(p, non_blocking=True)
        loss = sum(losses[1:], losses[0]) / M
        return trainer.TrainState(state.step + 1, state.model, new_opt, ema, None), loss
