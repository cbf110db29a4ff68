"""The device mesh, tensor parallelism, ZeRO-1 and the parallel steps —
counterpart of gan_class_transfer2_tpu/parallel/mesh.py.

JAX builds a device mesh and lets XLA insert the collectives from sharding
annotations. Here each process is one rank with one device (the
``parallel/multihost`` process group), and the collectives are written
out. ``make_mesh`` lays the ranks out as JAX lays devices out,
``reshape(slices, data, model)`` (mesh.py:47-51), the model axis fastest:
rank r has ``model = r % M``, ``data = (r // M) % D`` and
``slice = r // (M·D)``. It makes the subgroups of the ranks that differ in
one axis (``model``, ``data``, ``slice``) and of those that hold different
rows of a batch (``batch``: slice × data, indexed by the data coordinate
``slice·D + data``) once, every rank calling ``new_group`` for every group
in one order, and registers them with ``multihost``.

  * The batch is split by rows over ``('slice', 'data')``
    (``batch_sharding``): the rank at data coordinate c holds rows
    ``c·b … (c+1)·b − 1`` of the global batch, and every model rank of a
    data group holds the same rows. The step's draws (t, ε, augment and
    DiffAugment parameters, cGAN targets) are made for the global batch
    from a generator that is alike on every rank, and each rank takes its
    rows (``global_rows``, ``local_rows``): a step over the grid is the
    one-process step on the same global batch and generator state. On the
    fused diffusion path each rank runs B1s with its data coordinate as
    its position (JAX folds only the batch spec's axes, kernels.py:247-259);
  * tensor parallelism (``model`` > 1): ``_leaf_spec`` (mesh.py:64) splits
    the last (output-channel) axis of every 4-D kernel that divides by the
    model extent and is at least twice it; everything else is whole
    (biases, dense kernels, norms, embeddings). A rank's module holds its
    slice of each split kernel, and the conv layer is marked with the axis
    (``shard_state``): its convs run through ``parallel/tensor``, which
    gathers the output channels, so every layer after a conv sees whole
    activations. Gradients of split leaves are the rank's own; those of
    whole leaves come out the same on every model rank;
  * gradients, from ``torch.autograd.grad``, are averaged over the batch
    axis (the ranks with this rank's model coordinate) by an explicit
    ``all_reduce`` of one flat buffer (``multihost.all_reduce_mean``),
    together with the step's metrics, so every rank returns the global
    loss and takes the same non-finite and loss-scale decisions. They are
    never summed over a model group. ``DistributedDataParallel`` is not
    used: its reducer hooks ``.backward()``, which the port never calls;
  * ZeRO-1 (``zero1``) is the port's own, over its optax-form transforms:
    each rank keeps the slice ``_zero1_spec`` gives it of every leaf under
    an optimizer-state field (``OPT_STATE_FIELDS``): the last axis over
    ``data`` when it divides and is at least twice the data extent, whole
    otherwise, and a kernel that tensor parallelism splits over
    ``('model', 'data')`` when its last axis divides by both. It updates
    its slice of each parameter and all-gathers the slices over ``data``
    (``sharded_update``). ``state_shardings`` records the split of each
    leaf by name, so a checkpoint gathers the full leaves on save and
    slices them on restore (``utils/checkpoint.py``): a checkpoint is a
    one-process checkpoint whatever the grid that wrote it. Two
    departures from JAX, both because a rank can update only the
    parameters it holds: the stacked split is model-major where JAX's
    ``('data', 'model')`` is data-major, and a split kernel whose last
    axis does not divide by both stays on ``model`` where JAX moves it to
    ``data``. Like JAX's, the split never runs over ``slice``;
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

Pipeline parallelism is ``parallel/pipeline`` (one process, stages on
local devices); spatial sharding is ``parallel/spatial_train``.
"""

from __future__ import annotations

import contextlib
import copy
import math
import sys
from typing import NamedTuple

import torch
from torch import nn

from ..models.api import resolve_device
from . import multihost
from .multihost import Axis


class Grid:
    """The ranks of the process group as a grid of named axes: ``sizes``
    ({axis: extent}, major first, the last axis fastest), so rank r's
    coordinates are its digits in that mixed radix. ``size`` ranks, this
    process's ``rank``, its ``coords`` and its ``device``; ``batch`` names
    the axes a batch's rows are split over (their linear index is the data
    coordinate). ``groups`` ({axis name: process group}, from
    ``grid_groups``) are the subgroups of its axes; a grid built without
    them is a layout only (the rank's slices, no collectives), as the tests
    build one."""

    def __init__(self, sizes: dict, rank: int, device, batch: tuple, groups=None):
        self._sizes = dict(sizes)
        self.size = math.prod(self._sizes.values())
        self.rank = rank
        self.device = torch.device(device)
        self.coords = _digits(rank, self._sizes)
        self._batch = tuple(batch)
        self._groups = dict(groups or {})

    @property
    def data_index(self) -> int:
        """The data coordinate: the block of a batch this rank holds."""
        return self.axis("batch").index

    def axis(self, name: str) -> Axis:
        """``multihost.Axis`` of ``name``, or of ``batch``: the ranks that
        hold different rows of a batch, indexed by the data coordinate."""
        if name == "batch":
            if len(self._batch) == 1:
                return self.axis(self._batch[0])
            k, lin = 1, 0
            for a in self._batch:
                k, lin = k * self._sizes[a], lin * self._sizes[a] + self.coords[a]
            return Axis(self._groups.get(name), k, lin)
        return Axis(self._groups.get(name), self._sizes.get(name, 1), self.coords.get(name, 0))

    def __repr__(self):
        grid = "x".join(f"{k}={v}" for k, v in self.shape.items())
        return f"{type(self).__name__}({grid}, rank={self.rank}, device={self.device})"


def _digits(rank: int, sizes: dict) -> dict:
    out = {}
    for name in reversed(list(sizes)):
        out[name] = rank % sizes[name]
        rank //= sizes[name]
    return out


class Mesh(Grid):
    """The process group as a (``slice`` ×) ``data`` × ``model`` grid,
    ``model`` fastest, rows over ``('slice', 'data')``; ``shape`` names the
    axes as JAX's mesh does (no ``slice`` axis without slices)."""

    AXES = {"slice": ("slice",), "data": ("data",), "model": ("model",),
            "batch": ("slice", "data")}

    def __init__(self, data: int, rank: int, device, model: int = 1, slices: int = 1,
                 groups=None):
        super().__init__({"slice": slices, "data": data, "model": model}, rank, device,
                         ("slice", "data"), groups)
        self.shape = ({"data": data, "model": model} if slices == 1
                      else {"slice": slices, "data": data, "model": model})
        self.axis_names = tuple(self.shape)


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
    """The mesh of this process group on ``device`` (this rank's card under
    ``multihost``'s rule for ``cuda``): ``slices`` × ``data`` × ``model``
    ranks (or ``cfg.mesh_slice``/``mesh_data``/``mesh_model``), ``data`` 0
    for the rest of the world. The grid must be the world: a rank outside
    it would have nothing to compute. Makes the axes' subgroups (a
    collective call of ``new_group`` on every rank) and registers them
    with ``multihost``.

    ``devices``: a ``LocalMesh`` of in-process replicas on those devices
    instead (serving; ``data`` 0 or their count)."""
    if cfg is not None:
        data, model, slices = cfg.mesh_data, cfg.mesh_model, cfg.mesh_slice
    model, slices = max(model, 1), max(slices, 1)
    if devices is not None:
        if model > 1 or slices > 1:
            raise ValueError("make_mesh(devices=...): in-process replicas serve over data "
                             "only; the model and slice axes run over a process group")
        devices = [resolve_device(d) for d in devices]
        if data not in (0, len(devices)):
            raise ValueError(f"mesh 1x{data}x1 over {len(devices)} local devices: data must "
                             f"be 0 or {len(devices)}")
        return LocalMesh(devices)
    world = multihost.process_count()
    if data <= 0:
        data = max(world // (model * slices), 1)
    n = slices * data * model
    if n != world:
        raise ValueError(f"mesh {slices}x{data}x{model} needs {n} devices, have {world} "
                         f"(one process a device): the grid must take the whole process "
                         f"group; mesh_data must be 0 or {world // (model * slices)}")
    dev = multihost.local_device(resolve_device(device))
    rank = multihost.process_index()
    groups = grid_groups({"slice": slices, "data": data, "model": model}, rank, Mesh.AXES)
    mesh = Mesh(data, rank, dev, model, slices, groups)
    multihost.set_axes({name: mesh.axis(name) for name in Mesh.AXES})
    return mesh


_GROUPS: dict = {}


def grid_groups(sizes: dict, rank: int, axes: dict) -> dict:
    """{axis: the process group of this rank's ranks along it} on a grid of
    ``sizes`` (major first), for each entry of ``axes`` ({name: the grid
    axes it spans}) of more than one rank and fewer than the world (None:
    the world itself). Every rank calls ``new_group`` for every group of
    every axis, in one order (a rank that skipped one would hang the job);
    made once a grid and process group."""
    import torch.distributed as dist

    world = math.prod(sizes.values())
    if world == 1:
        return {}
    key = (id(dist.distributed_c10d._get_default_group()), tuple(sizes.items()),
           tuple(axes.items()))
    if key in _GROUPS:
        return _GROUPS[key]
    out = {}
    for name, varying in axes.items():
        k = math.prod(sizes[a] for a in varying)
        if k in (1, world):
            continue
        members: dict = {}
        for r in range(world):
            fixed = tuple(c for a, c in _digits(r, sizes).items() if a not in varying)
            members.setdefault(fixed, []).append(r)
        for ranks in members.values():
            group = dist.new_group(ranks)
            if rank in ranks:
                out[name] = group
    _GROUPS[key] = out
    return out


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
    """The data-parallel extent of the mesh (slice × data, mesh.py:281; 1
    on a spatial mesh, which has no data axis)."""
    return mesh.shape.get("data", 1) * mesh.shape.get("slice", 1)


def model_axis_size(mesh) -> int:
    """The tensor-parallel extent (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Rows over ``('slice', 'data')`` (over ``data`` without slices)."""
    if "slice" in mesh.shape:
        return Sharding(mesh, (("slice", "data"),))
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def global_rows(n_local: int, mesh) -> int:
    """The global batch of which a rank holds ``n_local`` rows."""
    return n_local * (data_axis_size(mesh) if mesh is not None else 1)


def norm_stats(mesh):
    """The context in which a step or program over ``mesh`` runs its norms:
    batch norm's statistics over the ``batch`` axis (``ops/norm.stats_over``),
    as JAX's jit over the mesh takes them over the global batch, on a
    process-group mesh of more than one rank; nothing otherwise (no mesh, a
    ``LocalMesh``, one rank)."""
    from ..ops import norm

    if mesh is None or isinstance(mesh, LocalMesh) or mesh.size <= 1:
        return contextlib.nullcontext()
    return norm.stats_over("batch")


def local_rows(x, mesh):
    """This rank's rows of ``x``, a global batch: the block at its data
    coordinate (``x`` itself on a data extent of one or without a mesh)."""
    if mesh is None or data_axis_size(mesh) == 1:
        return x
    b = x.shape[0] // data_axis_size(mesh)
    i = mesh.data_index
    return x[i * b:(i + 1) * b]


# ------------------------------------------------- tensor parallelism, ZeRO-1


def _leaf_spec(leaf, model_size: int) -> tuple:
    """The tensor-parallel rule (mesh.py:64): the last (output-channel) axis
    of a 4-D kernel over ``model`` when it divides by the model extent and
    is at least twice it; everything else whole (``()``)."""
    if model_size <= 1 or not isinstance(leaf, torch.Tensor):
        return ()
    last = leaf.shape[-1] if leaf.ndim else 0
    if leaf.ndim == 4 and last % model_size == 0 and last >= 2 * model_size:
        return (None, None, None, "model")
    return ()


def _zero1_spec(leaf, mesh: Mesh) -> tuple:
    """The ZeRO-1 split of an optimizer-state leaf (mesh.py:77): a kernel
    that ``_leaf_spec`` splits over ``model`` splits over ``('model',
    'data')`` when its last axis divides by both extents, else over
    ``model`` alone; any other leaf's last axis over ``data`` when that
    divides and is at least 2·data, else whole. ``_leaf_spec`` on a data
    extent of one. (JAX stacks ``('data', 'model')`` and moves the
    non-dividing kernel to ``data``: the module docstring says why the
    port does not.)"""
    data, model = mesh.shape["data"], mesh.shape["model"]
    tp = _leaf_spec(leaf, model)
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0 or data <= 1:
        return tp
    last = leaf.shape[-1]
    if tp:
        if last % (data * model) == 0:
            return (None,) * (leaf.ndim - 1) + (("model", "data"),)
        return tp
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
    every leaf under a registered optimizer-state field gets
    ``_zero1_spec`` under ``zero1``; everything else ``_leaf_spec``."""
    model = model_axis_size(mesh)

    def spec(path, leaf):
        if zero1 and _is_opt_state_path(path):
            return _zero1_spec(leaf, mesh)
        return _leaf_spec(leaf, model)

    return {_name(path): spec(path, leaf) for path, leaf in _leaves(state)}


def _split(spec) -> bool:
    return any(e is not None for e in (spec or ()))


def shard_state(state, shardings: dict, mesh: Mesh):
    """``state`` (full) with every split leaf replaced by this rank's part
    of it (a tensor of its own). A module's split parameters are replaced
    in place (``param.data``), and each conv layer whose kernel was split
    over ``model`` is marked ``tp = "model"`` for ``parallel/tensor``."""
    def part(leaf, spec):
        return multihost.local_part(leaf, spec, mesh.axis).contiguous().clone()

    def one(path, leaf):
        spec = shardings.get(_name(path), ())
        return part(leaf, spec) if _split(spec) else leaf

    def modules(node, path=()):
        if isinstance(node, nn.Module):
            yield path, node
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                yield from modules(v, path + (node._fields[i] if hasattr(node, "_fields")
                                              else i,))

    with torch.no_grad():
        for path, module in modules(state):
            for k, p in module.named_parameters():
                spec = shardings.get(_name(path + tuple(k.split("."))), ())
                if _split(spec):
                    p.data = part(p.data, spec)
                    if "model" in multihost._entry_axes(spec[-1]):
                        module.get_submodule(k.rsplit(".", 1)[0]).tp = "model"
    return multihost.tree_map(one, state)


def _sharded(full, mesh: Mesh, zero1: bool):
    shardings = state_shardings(full, mesh, zero1)
    return shard_state(full, shardings, mesh), shardings


def init_sharded_state(cfg, mesh: Mesh, generator=None):
    """``(state, shardings)``: ``trainer.init_state`` on the mesh's device
    (the same full weights on every rank, from ``cfg.seed``, as one process
    draws them), then this rank's part of every split leaf: its kernel
    slices under tensor parallelism, its optimizer-state slices under
    ``cfg.zero1``; and its ``state_shardings``."""
    from ..train import trainer

    return _sharded(trainer.init_state(cfg, generator, device=mesh.device), mesh, cfg.zero1)


def init_sharded_gan_state(cfg, mesh: Mesh, generator=None):
    from ..train import gan

    return _sharded(gan.init_gan_state(cfg, generator, device=mesh.device), mesh, cfg.zero1)


def init_sharded_conditional_gan_state(cfg, mesh: Mesh, generator=None):
    from ..train import conditional_gan as cgan

    return _sharded(cgan.init_conditional_gan_state(cfg, generator, device=mesh.device), mesh,
                    cfg.zero1)


def _owner(module, name: str):
    return module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module


def _tp_split_name(module, name: str) -> bool:
    return name.endswith("kernel") and getattr(_owner(module, name), "tp", None) == "model"


class Params(list):
    """The parameters of modules in ``parameters()`` order, with ``tp``:
    for each, whether it holds this rank's output channels of a kernel
    split over ``model`` (its layer is marked by ``shard_state``)."""

    def __init__(self, modules):
        params, tp = [], []
        for m in modules:
            for k, p in m.named_parameters():
                params.append(p)
                tp.append(_tp_split_name(m, k))
        super().__init__(params)
        self.tp = tp


def params_of(*modules) -> Params:
    return Params(modules)


class RankSlices(list):
    """This rank's views of a parameter list, as the optimizer's ``params``;
    ``global_sum`` sums per-leaf partial sums over the ranks, each leaf
    weighted by the reciprocal of the ranks that hold the same part of it,
    so every part counts once (``clip_by_global_norm``)."""

    def __init__(self, views, weights, mesh):
        super().__init__(views)
        self.weights = weights
        self.mesh = mesh

    def global_sum(self, values):
        local = sum(v * w for v, w in zip(values, self.weights))
        return multihost.all_reduce_sum(local)


def _data_splits(p, tp: bool, mesh: Mesh) -> bool:
    """Whether ZeRO-1 splits this rank's (local) parameter over ``data``."""
    data, last = mesh.shape["data"], p.shape[-1] if p.ndim else 0
    if data <= 1 or p.ndim == 0:
        return False
    if tp:
        return p.ndim == 4 and last % data == 0
    return last % data == 0 and last >= 2 * data


def _data_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's part of ``x`` split on its last axis over ``data`` (a
    view)."""
    k = x.shape[-1] // mesh.shape["data"]
    return x.narrow(-1, mesh.coords["data"] * k, k)


def needs_sharded_update(mesh, zero1: bool) -> bool:
    """Whether an update over ``mesh`` goes through ``sharded_update``:
    under ZeRO-1 or tensor parallelism, on more than one rank."""
    return mesh is not None and mesh.size > 1 and (zero1 or model_axis_size(mesh) > 1)


@torch.no_grad()
def sharded_update(optimizer, opt_state, params, grads, mesh: Mesh, zero1: bool, finite=None):
    """The optimizer step on this rank's parts of the parameters
    (``params`` a ``Params``, or a plain list of whole ones): each
    parameter ZeRO-1 splits over ``data`` (``zero1``) takes its slice of
    the averaged gradient through ``optimizer.update`` with the sliced
    state, the slice is updated in place (only where ``finite``, when
    given), and one ``all_gather`` over ``data`` of the updated slices
    rebuilds every parameter on every rank. Kernel slices of tensor
    parallelism are updated as they are. The clip's global norm counts
    every part once (``RankSlices``). Returns the new optimizer state."""
    tp = getattr(params, "tp", [False] * len(params))
    split = [zero1 and _data_splits(p, t, mesh) for p, t in zip(params, tp)]
    model = model_axis_size(mesh)
    weights = [(model if t else 1) * (mesh.shape["data"] if s else 1) / mesh.size
               for t, s in zip(tp, split)]
    views = RankSlices([_data_slice(p, mesh) if s else p for p, s in zip(params, split)],
                       weights, mesh)
    g_local = [_data_slice(g, mesh) if s else g for g, s in zip(grads, split)]
    updates, new_state = optimizer.update(g_local, opt_state, views)
    for v, u in zip(views, updates):
        if finite is None:
            v.add_(u.to(v.dtype))
        else:
            v.copy_(torch.where(finite, v + u.to(v.dtype), v))
    mine = [v for v, s in zip(views, split) if s]
    if mine:
        me = mesh.coords["data"]
        parts = multihost.all_gather(torch.cat([v.reshape(-1) for v in mine]),
                                     mesh.axis("data"))
        for r, part in enumerate(parts):
            if r == me:
                continue
            i = 0
            for p, v in zip((p for p, s in zip(params, split) if s), mine):
                k = v.numel()
                p.narrow(-1, r * v.shape[-1], v.shape[-1]).copy_(part[i:i + k].view(v.shape))
                i += k
    return new_state


@torch.no_grad()
def whole_module(module, mesh, out=None):
    """``module`` with its split kernels gathered over ``model`` (a
    collective on every rank of the model group): a copy whose layers are
    whole, as one process holds them; ``out``, when given, a whole copy to
    overwrite. ``module`` itself when nothing is split."""
    if not any(tp for tp in Params([module]).tp):
        return module
    if out is None:
        out = copy.deepcopy(module).requires_grad_(False)
        for m in out.modules():
            if hasattr(m, "tp"):
                del m.tp
    mine = dict(module.named_parameters())
    for k, p in out.named_parameters():
        src = mine[k]
        full = src.detach()
        if _tp_split_name(module, k):
            full = multihost.gather_split(full, (None,) * (src.ndim - 1) + ("model",), mesh.axis)
        if full.shape != p.shape:
            p.data = full.clone()
        else:
            p.copy_(full)
    return out


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


def share_batch(batch, mesh):
    """``batch`` (a tensor or a dict of them) as model rank 0 of this rank's
    data group holds it: under tensor parallelism one broadcast a tensor
    over the model group, so every model rank computes on the same rows (a
    data pipeline whose decode threads order a batch differently on each
    rank would otherwise feed one group different rows, and the gathered
    activations would mix them). ``batch`` itself otherwise."""
    if model_axis_size(mesh) <= 1:
        return batch
    import torch.distributed as dist

    ax = mesh.axis("model")
    src = mesh.rank - mesh.coords["model"]

    def one(_, t):
        t = t.contiguous()
        dist.broadcast(t, src, group=ax.group)
        return t

    return multihost.tree_map(one, batch)


def make_parallel_train_step(cfg, mesh: Mesh):
    """``step(state, batch, generator) -> (state, loss)`` over the mesh:
    ``batch`` is this rank's rows of the global batch (model rank 0's
    under tensor parallelism, ``share_batch``), the loss the global one
    (mesh.py:161)."""
    from ..train import trainer

    warn_misaligned_batch(cfg, mesh)
    optimizer = trainer.make_optimizer(cfg)

    def step(state, batch, generator):
        batch = share_batch(batch, mesh)
        return trainer.train_step(cfg, optimizer, state, batch, generator, mesh=mesh)

    return step


def make_parallel_gan_train_step(cfg, mesh: Mesh):
    """``step(state, batch_a, batch_b, generator) -> (state, metrics)`` over
    the mesh, both class batches split by rows (mesh.py:196)."""
    from ..train import gan

    if model_axis_size(mesh) > 1:
        cfg.refuse_published_cyclegan("tensor")
    warn_misaligned_batch(cfg, mesh)
    g_opt, d_opt = gan.make_optimizer(cfg), gan._d_optimizer(cfg)

    def step(state, batch_a, batch_b, generator):
        batch_a, batch_b = share_batch(batch_a, mesh), share_batch(batch_b, mesh)
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
        batch = share_batch(batch, mesh)
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
    batch = pad_rows(batch, data_axis_size(mesh))
    if isinstance(mesh, LocalMesh):
        return [block.to(d) for block, d in zip(batch.chunk(mesh.size), mesh.devices)], n
    return local_rows(batch, mesh), n


def pad_rows(batch, extent: int):
    """``batch`` with zero rows appended up to a multiple of ``extent``."""
    pad = (-batch.shape[0]) % extent
    if not pad:
        return batch
    return torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))], 0)


def gather_rows(local, mesh, n: int, dim: int = 0):
    """Every data coordinate's ``local`` block concatenated along ``dim`` in
    order, cut to ``n`` rows there (a collective over the batch axis on a
    mesh of more than one rank). On a ``LocalMesh``, ``local`` is the list
    of the replicas' blocks, gathered onto the first device."""
    if isinstance(mesh, LocalMesh) and mesh.size > 1:
        local = torch.cat([b.to(mesh.device) for b in local], dim)
    elif mesh is not None and mesh.size > 1:
        local = torch.cat(multihost.all_gather(local.contiguous(), mesh.axis("batch")), dim)
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
            with norm_stats(mesh):  # JAX normalises the padded batch whole
                out = fn(params, local, *ex)
        if isinstance(out, tuple):
            return tuple(gather_rows(o, mesh, real) for o in out)
        return gather_rows(out, mesh, real)

    return wrapped


def make_padded_apply(extent: int, fn):
    """``fn(params, batch, *extras)`` run whole on the batch zero-padded to a
    multiple of ``extent`` (and each extra whose leading dim matches it),
    each output cut back to the real rows: the rows JAX's
    ``make_data_parallel_apply`` runs over ``extent`` data devices
    (mesh.py:315), where a batch norm's statistics span the padded batch.
    ``fn`` itself for an extent of 1."""
    if extent <= 1:
        return fn

    def wrapped(params, batch, *extras):
        n = batch.shape[0]
        ex = [pad_rows(e, extent) if isinstance(e, torch.Tensor) and e.ndim >= 1
              and e.shape[0] == n else e for e in extras]
        out = fn(params, pad_rows(batch, extent), *ex)
        if isinstance(out, tuple):
            return tuple(o[:n] for o in out)
        return out[:n]

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
        with norm_stats(mesh):  # the padded batch's statistics, as JAX's
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
