"""The data-parallel mesh, ZeRO-1 and the parallel steps — counterpart of
the data-parallel half of gan_class_transfer2_tpu/parallel/mesh.py.

JAX builds a device mesh and lets XLA insert the collectives from sharding
annotations. Here each process is one rank with one device (the
``parallel/multihost`` process group), the mesh's ``data`` extent is the
world size, and the collectives are written out:

  * every rank holds the whole parameters; the batch is split by rows
    (``batch_sharding``: rank r holds rows ``r·b … (r+1)·b − 1`` of the
    global batch). The step's draws (t, ε, augment and DiffAugment
    parameters, cGAN targets) are made for the global batch from a
    generator that is alike on every rank, and each rank takes its rows
    (``global_rows``, ``local_rows``): a two-rank step is the one-process
    step on the same global batch and generator state. On the fused
    diffusion path each rank runs B1s with the rank as its position;
  * gradients, from ``torch.autograd.grad``, are averaged by an explicit
    ``all_reduce`` of one flat buffer (``multihost.all_reduce_mean``),
    together with the step's metrics, so every rank returns the global
    loss and takes the same non-finite and loss-scale decisions.
    ``DistributedDataParallel`` is not used: its reducer hooks
    ``.backward()``, which the port never calls;
  * ZeRO-1 (``zero1``) is the port's own, over its optax-form transforms:
    each rank keeps the slice ``_zero1_spec`` gives it of every leaf under
    an optimizer-state field (``OPT_STATE_FIELDS``), the last axis when it
    divides and is at least twice the world size, whole otherwise; it
    updates its slice of each parameter and all-gathers the slices
    (``zero1_update``). ``state_shardings`` records the split of each leaf
    by name, so a checkpoint gathers the full moments on save and slices
    them on restore (``utils/checkpoint.py``);
  * the sampler and single-forward evals split their batch over the ranks,
    zero-padded, and gather the result (``shard_sample_batch``,
    ``make_data_parallel_apply``, ``sampler_eval``).

Serving runs in one process over the host's devices, as JAX serves over
``make_mesh(devices=jax.local_devices())`` (serve/server.py:1233-1241):
``make_mesh(devices=[...])`` gives a ``LocalMesh`` of in-process replicas,
no process group. ``replicate`` puts a copy of a module on each of its
devices (the first may be the module itself), and ``shard_sample_batch``,
``gather_rows`` and ``make_data_parallel_apply`` split rows over the
replicas, zero-padded to the extent, run each block on its replica's
device and gather the blocks onto the first device. The blocks run one
after another from the calling thread, each with its device current: the
launches are asynchronous, so separate cards run their blocks together,
and threads of their own would only contend for the GIL (on four H100s
they made /sample slower, tools/serve_replicas_torch.py). A batch of fewer
rows than replicas is not padded up to the mesh: it runs whole on the
first replica, since a small batch is paced by its launches and more
replicas would only add launches. Two replicas may name the same device
(how one card and the CPU hold the code): each is still a copy of its
own.

Tensor, pipeline and spatial parallelism (the ``model`` and ``slice`` axes)
are not ported: a mesh is ``data`` × 1.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from typing import NamedTuple

import torch
from torch import nn

from ..models.api import resolve_device
from . import multihost


class Mesh:
    """The ranks of the process group as a ``data`` × ``model`` mesh (the
    model extent is 1): ``size`` ranks, this process's ``rank`` and its
    ``device``."""

    axis_names = ("data", "model")

    def __init__(self, data: int, rank: int, device):
        self.size = data
        self.rank = rank
        self.device = torch.device(device)
        self.shape = {"data": data, "model": 1}

    def __repr__(self):
        return f"Mesh(data={self.size}, rank={self.rank}, device={self.device})"


class LocalMesh:
    """In-process replicas over local ``devices`` as a ``data`` × 1 mesh
    (serving): ``size`` replicas, the first device ``device``, where
    gathered results land."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a local mesh needs at least one device")
        self.size = len(self.devices)
        self.device = self.devices[0]
        self.shape = {"data": self.size, "model": 1}

    def __repr__(self):
        return f"LocalMesh({[str(d) for d in self.devices]})"


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:<i>``, as a module's parameters
    report it; any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Sharding(NamedTuple):
    """A partition of an array over ``mesh``: ``spec`` names the mesh axis
    each leading dim is split over (``("data",)`` for a batch, ``()``
    whole); ``device`` is the rank's."""

    mesh: Mesh
    spec: tuple

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def make_mesh(cfg=None, device="cuda", data: int = 0, model: int = 1, slices: int = 1,
              devices=None):
    """The data-parallel mesh of this process group on ``device`` (this
    rank's card under ``multihost``'s rule for ``cuda``). ``data`` (or
    ``cfg.mesh_data``) is 0 for the world size, or must equal it.

    ``devices``: a ``LocalMesh`` of in-process replicas on those devices
    instead (serving; ``data`` 0 or their count)."""
    if cfg is not None:
        data, model, slices = cfg.mesh_data, cfg.mesh_model, cfg.mesh_slice
    if max(model, 1) > 1 or max(slices, 1) > 1:
        raise NotImplementedError(
            "make_mesh: the model and slice axes (tensor and multi-slice parallelism) are "
            "not ported to PyTorch yet; the port's mesh is data x 1")
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if data not in (0, len(devices)):
            raise ValueError(f"mesh 1x{data}x1 over {len(devices)} local devices: data must "
                             f"be 0 or {len(devices)}")
        return LocalMesh(devices)
    world = multihost.process_count()
    if data <= 0:
        data = world
    if data != world:
        raise ValueError(f"mesh 1x{data}x1 needs {data} processes (one device each), the "
                         f"process group has {world}; mesh_data must be 0 or {world}")
    dev = multihost.local_device(resolve_device(device))
    return Mesh(data, multihost.process_index(), dev)


def local_devices(device="cuda") -> list:
    """This host's devices of ``device``'s type: every card for ``cuda``
    (``torch.cuda.device_count()``), the one CPU for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def replicate(module, mesh):
    """``module`` placed over ``mesh``: itself without a mesh or on a mesh
    of one device; on a ``LocalMesh`` a list of one replica a device, the
    first ``module`` itself when it lives on the first device, the others
    copies that take no gradient."""
    if mesh is None or mesh.size <= 1:
        return module
    first = module if next(module.parameters()).device == mesh.devices[0] else (
        copy.deepcopy(module).to(mesh.devices[0]).requires_grad_(False))
    return [first] + [copy.deepcopy(module).to(d).requires_grad_(False)
                      for d in mesh.devices[1:]]


def data_axis_size(mesh: Mesh) -> int:
    """The data-parallel extent of the mesh."""
    return mesh.shape["data"]


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def global_rows(n_local: int, mesh) -> int:
    """The global batch of which a rank holds ``n_local`` rows."""
    return n_local * (mesh.size if mesh is not None else 1)


def local_rows(x, mesh):
    """This rank's rows of ``x``, a global batch (``x`` itself on a mesh of
    one rank or without one)."""
    if mesh is None or mesh.size == 1:
        return x
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


# ------------------------------------------------------------------ ZeRO-1


def _zero1_spec(leaf, mesh: Mesh) -> tuple:
    """The ZeRO-1 split of an optimizer-state leaf (mesh.py:77): its last
    axis over ``data`` when that divides and is at least 2·data, else
    whole (``()``); whole on a mesh of one rank."""
    data = data_axis_size(mesh)
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0 or data <= 1:
        return ()
    last = leaf.shape[-1]
    if last % data == 0 and last >= 2 * data:
        return (None,) * (leaf.ndim - 1) + ("data",)
    return ()


# The optimizer-state fields of the state NamedTuples (TrainState.opt_state,
# GANState.g_opt/d_opt, ConditionalGANState.g_opt/d_opt): an exact match of
# the top-level field name, so a field that merely contains "opt" is never
# sliced. A new state type with moments lists its field here.
OPT_STATE_FIELDS = frozenset({"opt_state", "g_opt", "d_opt"})


def _is_opt_state_path(path) -> bool:
    return bool(path) and path[0] in OPT_STATE_FIELDS


def _leaves(node, path=()):
    """(path, tensor) of every tensor of a state: NamedTuples by field,
    lists and tuples by index, dicts by key, modules by their state_dict
    names, as ``utils/checkpoint`` names them."""
    if isinstance(node, torch.Tensor):
        yield path, node
    elif isinstance(node, nn.Module):
        for k, v in node.state_dict(keep_vars=True).items():
            yield path + (k,), v
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from _leaves(v, path + (f,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))


def _name(path) -> str:
    return ".".join(map(str, path))


def state_shardings(state, mesh: Mesh, zero1: bool = False) -> dict:
    """{leaf name: partition spec} of a state in its full form (mesh.py:109):
    under ``zero1`` every leaf under a registered optimizer-state field gets
    ``_zero1_spec``; everything else is whole (``()``)."""
    return {_name(path): _zero1_spec(leaf, mesh) if zero1 and _is_opt_state_path(path) else ()
            for path, leaf in _leaves(state)}


def _slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's part of ``x`` split on its last axis (a view)."""
    k = x.shape[-1] // mesh.size
    return x.narrow(-1, mesh.rank * k, k)


def shard_state(state, shardings: dict, mesh: Mesh):
    """``state`` (full) with each split optimizer-state leaf replaced by this
    rank's slice of it (a tensor of its own)."""
    def one(path, leaf):
        if any(e is not None for e in shardings.get(_name(path), ())):
            return _slice(leaf, mesh).contiguous().clone()
        return leaf

    return multihost.tree_map(one, state)


def _sharded(full, mesh: Mesh, zero1: bool):
    shardings = state_shardings(full, mesh, zero1)
    return shard_state(full, shardings, mesh), shardings


def init_sharded_state(cfg, mesh: Mesh, generator=None):
    """``(state, shardings)``: ``trainer.init_state`` on the mesh's device
    (the same weights on every rank, from ``cfg.seed``), with the optimizer
    state sliced under ``cfg.zero1``, and its ``state_shardings``."""
    from ..train import trainer

    return _sharded(trainer.init_state(cfg, generator, device=mesh.device), mesh, cfg.zero1)


def init_sharded_gan_state(cfg, mesh: Mesh, generator=None):
    from ..train import gan

    return _sharded(gan.init_gan_state(cfg, generator, device=mesh.device), mesh, cfg.zero1)


def init_sharded_conditional_gan_state(cfg, mesh: Mesh, generator=None):
    from ..train import conditional_gan as cgan

    return _sharded(cgan.init_conditional_gan_state(cfg, generator, device=mesh.device), mesh,
                    cfg.zero1)


class RankSlices(list):
    """This rank's ZeRO-1 views of a parameter list, as the optimizer's
    ``params``; ``global_sum`` sums per-leaf partial sums over the ranks,
    a whole (unsplit) leaf counted once (``clip_by_global_norm``)."""

    def __init__(self, views, split, mesh):
        super().__init__(views)
        self.split = split
        self.mesh = mesh

    def global_sum(self, values):
        n = self.mesh.size
        local = sum(v if s else v / n for v, s in zip(values, self.split))
        return multihost.all_reduce_sum(local)


@torch.no_grad()
def zero1_update(optimizer, opt_state, params, grads, mesh: Mesh, finite=None):
    """The optimizer step on this rank's ZeRO-1 slices: each split
    parameter's slice of the averaged gradient goes through
    ``optimizer.update`` with the sliced state, the slice of the parameter
    is updated in place (only where ``finite``, when given), and one
    ``all_gather`` of the updated slices rebuilds every parameter on every
    rank. Whole leaves are updated alike on every rank. Returns the new
    (sliced) optimizer state."""
    split = [bool(_zero1_spec(p, mesh)) for p in params]
    views = RankSlices([_slice(p, mesh) if s else p for p, s in zip(params, split)], split, mesh)
    g_local = [_slice(g, mesh) if s else g for g, s in zip(grads, split)]
    updates, new_state = optimizer.update(g_local, opt_state, views)
    for v, u in zip(views, updates):
        if finite is None:
            v.add_(u.to(v.dtype))
        else:
            v.copy_(torch.where(finite, v + u.to(v.dtype), v))
    mine = [v for v, s in zip(views, split) if s]
    if mine:
        parts = multihost.all_gather(torch.cat([v.reshape(-1) for v in mine]))
        for r, part in enumerate(parts):
            if r == mesh.rank:
                continue
            i = 0
            for p, v in zip((p for p, s in zip(params, split) if s), mine):
                k = v.numel()
                p.narrow(-1, r * v.shape[-1], v.shape[-1]).copy_(part[i:i + k].view(v.shape))
                i += k
    return new_state


def opt_state_bytes(state) -> int:
    """Bytes of the tensors under the optimizer-state fields this rank
    holds."""
    return sum(t.numel() * t.element_size() for path, t in _leaves(state)
               if _is_opt_state_path(path))


# ------------------------------------------------------------------ steps


def warn_misaligned_batch(cfg, mesh: Mesh, backend: str = None) -> None:
    """JAX's warning (mesh.py:135) when the per-chip batch is not a multiple
    of 8 on a TPU, which pads it to the next multiple. ``backend`` defaults
    to the mesh's device type: the port runs on CUDA and the CPU, where no
    such padding was measured, so it warns only for ``backend="tpu"``."""
    if backend is None:
        backend = mesh.device.type
    n = data_axis_size(mesh)
    per_chip, rem = divmod(cfg.batch_size, n)
    if backend != "tpu" or rem:  # indivisible batches error elsewhere
        return
    if per_chip >= 1 and per_chip % 8:
        pad = -(-per_chip // 8) * 8
        print(f"warning: per-chip batch {per_chip} is not a multiple of 8 — the TPU pads it "
              f"to {pad} ({1 - per_chip / pad:.0%} of each step is wasted padding); consider "
              f"a global batch of {pad * n}", file=sys.stderr)


def make_parallel_train_step(cfg, mesh: Mesh):
    """``step(state, batch, generator) -> (state, loss)`` over the mesh:
    ``batch`` is this rank's rows of the global batch, the loss the global
    one (mesh.py:161)."""
    from ..train import trainer

    warn_misaligned_batch(cfg, mesh)
    optimizer = trainer.make_optimizer(cfg)

    def step(state, batch, generator):
        return trainer.train_step(cfg, optimizer, state, batch, generator, mesh=mesh)

    return step


def make_parallel_gan_train_step(cfg, mesh: Mesh):
    """``step(state, batch_a, batch_b, generator) -> (state, metrics)`` over
    the mesh, both class batches split by rows (mesh.py:196)."""
    from ..train import gan

    warn_misaligned_batch(cfg, mesh)
    g_opt, d_opt = gan.make_optimizer(cfg), gan._d_optimizer(cfg)

    def step(state, batch_a, batch_b, generator):
        return gan.gan_train_step(cfg, g_opt, d_opt, state, batch_a, batch_b, generator,
                                  mesh=mesh)

    return step


def make_parallel_conditional_gan_train_step(cfg, mesh: Mesh):
    """``step(state, batch, generator, targets=None) -> (state, metrics)``
    over the mesh, the labeled batch split by rows (mesh.py:249);
    ``targets``, when injected, are this rank's rows."""
    from ..train import conditional_gan as cgan
    from ..train import gan

    warn_misaligned_batch(cfg, mesh)
    g_opt, d_opt = gan.make_optimizer(cfg), gan._d_optimizer(cfg)

    def step(state, batch, generator, targets=None):
        return cgan.conditional_gan_train_step(cfg, g_opt, d_opt, state, batch, generator,
                                               targets=targets, mesh=mesh)

    return step


# ------------------------------------------------------------- sampling


def shard_sample_batch(batch, mesh):
    """This rank's rows of ``batch`` zero-padded to a multiple of the data
    extent (mesh.py:289), and the real count: the sampler's batch runs
    split over the ranks instead of whole on each; ``gather_rows`` puts
    the result back together. Padded rows run on zeros and are cut off.
    On a ``LocalMesh``: the list of every replica's block, each on its
    replica's device."""
    n = batch.shape[0]
    if mesh is None or mesh.size <= 1:
        return batch, n
    pad = (-n) % mesh.size
    if pad:
        batch = torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))], 0)
    if isinstance(mesh, LocalMesh):
        return [block.to(d) for block, d in zip(batch.chunk(mesh.size), mesh.devices)], n
    return local_rows(batch, mesh), n


def gather_rows(local, mesh, n: int, dim: int = 0):
    """Every rank's ``local`` block concatenated along ``dim`` in rank
    order, cut to ``n`` rows there (a collective on a mesh of more than one
    rank). On a ``LocalMesh``, ``local`` is the list of the replicas'
    blocks, gathered onto the first device."""
    if isinstance(mesh, LocalMesh) and mesh.size > 1:
        local = torch.cat([b.to(mesh.device) for b in local], dim)
    elif mesh is not None and mesh.size > 1:
        local = torch.cat(multihost.all_gather(local.contiguous()), dim)
    return local.narrow(dim, 0, n)


def _on_replicas(mesh: LocalMesh, fn, args: list) -> list:
    """``[fn(*args[i]) for each replica i]`` in turn from the calling
    thread, each with its replica's device current (the kernels' launches
    then switch no device)."""
    outs = []
    for dev, a in zip(mesh.devices, args):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            outs.append(fn(*a))
    return outs


def make_data_parallel_apply(mesh, fn):
    """``fn(params, batch, *extras)`` with the leading-axis batch split over
    the ranks (mesh.py:315): the batch and each extra whose leading dim
    matches it (a class vector) are zero-padded to the data extent, each
    rank applies ``fn`` to its rows, and the rows are gathered and cut back
    (each tensor of a tuple ``fn`` returns). ``fn`` itself on a mesh of one
    rank. On a ``LocalMesh``, ``params`` is ``replicate``'s list and each
    replica in turn applies ``fn`` to its block on its device; a batch of
    fewer rows than replicas runs whole on the first."""
    if mesh is None or mesh.size <= 1:
        return fn

    def wrapped(params, batch, *extras):
        n = batch.shape[0]
        split = [isinstance(e, torch.Tensor) and e.ndim >= 1 and e.shape[0] == n for e in extras]
        if isinstance(mesh, LocalMesh) and n < mesh.size:
            dev = mesh.device
            return fn(params[0], batch.to(dev), *(e.to(dev) if s else e
                                                  for e, s in zip(extras, split)))
        local, real = shard_sample_batch(batch, mesh)
        ex = [shard_sample_batch(e, mesh)[0] if s else e for e, s in zip(extras, split)]
        if isinstance(mesh, LocalMesh):  # each output as the list of the replicas' blocks
            outs = _on_replicas(mesh, fn, [
                (params[i], local[i], *(e[i] if s else e for e, s in zip(ex, split)))
                for i in range(mesh.size)])
            out = tuple(map(list, zip(*outs))) if isinstance(outs[0], tuple) else outs
        else:
            out = fn(params, local, *ex)
        if isinstance(out, tuple):
            return tuple(gather_rows(o, mesh, real) for o in out)
        return gather_rows(out, mesh, real)

    return wrapped


def make_parallel_eval_fn(cfg, mesh: Mesh):
    """The per-epoch eval program over the mesh (mesh.py:347):
    ``sampler_eval``."""
    return sampler_eval(cfg, mesh)


def sampler_eval(cfg, mesh: Mesh | None = None):
    """``eval_fn(model, example_image, noise_bank, dictionary)`` → the
    reference's TensorBoard artifacts (mesh.py:362): the preview and the
    inversion on every rank, the (2 + 4·B)-image sampler batch split over
    the ranks and gathered, so every rank returns the whole result."""
    from ..sample import sampler

    @torch.inference_mode()
    def eval_fn(model, example_image, noise_bank, dictionary):
        preview_noise = noise_bank[:1].expand(example_image.shape)
        denoised, rmse = sampler.preview(cfg, model, example_image, preview_noise)
        _, epsilon_theta = sampler.invert(cfg, model, example_image)
        batch = sampler.edit_noise(cfg, epsilon_theta, dictionary, noise_bank)
        local, n = shard_sample_batch(batch, mesh)
        result = sampler.sample(cfg, model, local)
        snaps = gather_rows(result.snapshots, mesh, n, dim=1)
        return {
            "denoised": denoised,
            "example_loss": rmse,
            "fake": gather_rows(result.images, mesh, n),
            "step_1": snaps[0],
            "step_0.75": snaps[1],
            "step_0.5": snaps[2],
            "step_0.25": snaps[3],
        }

    return eval_fn
