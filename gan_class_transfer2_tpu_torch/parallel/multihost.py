"""Multi-process support — counterpart of
gan_class_transfer2_tpu/parallel/multihost.py.

Each process is one rank of a ``torch.distributed`` process group and owns
one device. Where JAX assembles a logically global array from each host's
shard, a rank here keeps its local batch on its own device, and the
collectives are explicit:

  * ``initialize()`` — ``init_process_group`` over TCP from the coordinator's
    address, the world size and the rank (no-op without an address or when
    already initialised); failures raise: a rank never trains alone without
    saying so;
  * ``host_fetch(tree, spec)`` — the full value of leaves split across the
    ranks, by an ``all_gather`` on every rank (a collective: every rank calls
    it at the same point);
  * ``all_reduce_mean`` — the mean over the ranks of a list of tensors, one
    flat ``all_reduce`` (the data-parallel gradient average);
  * ``is_coordinator`` / ``shard_files_for_host`` / ``host_local_batch_size``
    as in JAX.

Backend and device, by rule, decided before any collective runs
(``backend_and_device``): on the CPU, gloo; on the card, nccl when every
local rank has a card of its own (device ``cuda:{local_rank}``), gloo when
ranks share a card (device ``cuda:{local_rank % device_count}``), since
nccl refuses two ranks on one device. gloo takes CUDA tensors in
``all_reduce``, ``broadcast`` and ``all_gather`` itself, over the world
and over subgroups (it copies them through host memory; checked on an
H100 with torch 2.11, tools/gloo_cuda_probe.py), so no path here stages
them. Its ``send``/``recv`` and ``batch_isend_irecv`` do not take them
(the same probe: ``writev ... Bad address``, and a rank killed), so no
path here sends point to point: the halos of ``parallel/spatial`` ride an
``all_gather``. The ranks of a job run on one host: the local rank is the
rank.

Axes. ``parallel/mesh.make_mesh`` lays the ranks out as a grid of named
axes (``slice``, ``data``, ``model``; ``parallel/spatial_train`` adds
``spatial``) and registers each here (``set_axes``): the subgroup of the
ranks that differ only in that axis, its size and this rank's index along
it, plus ``batch``, the ranks that hold different rows of a batch (the
``slice`` × ``data`` extent, indexed by the data coordinate). Every
collective below takes an optional ``axis`` and then runs over that
subgroup; a partition spec names the axes a dim is split over, and
``host_fetch``, ``local_part`` and ``is_cross_process_sharded`` read the
axes from it. Without a registered grid, ``data`` and ``batch`` are the
world and any other axis has size 1.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


def process_count() -> int:
    """The world size (1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class CommStats:
    """Calls and bytes sent of the collectives of the tensor-parallel convs
    (``gather``, ``reduce``; the spatial step's height gather is a
    ``gather`` too), the halo exchanges (``halo``), the norms' statistics
    across ranks (``norm``) and the gradient all-reduces (``grad``), by
    kind. Counting costs a dict update, under a lock: a recompute in the
    backward counts from autograd's device thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.calls, self.bytes = {}, {}

    @contextlib.contextmanager
    def record(self, kind: str, t: torch.Tensor):
        """Count the collective of ``t`` that the block makes."""
        with self._lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + t.numel() * t.element_size()
        yield


comm = CommStats()


class Axis(NamedTuple):
    """One axis of the rank grid: ``group`` the subgroup of the ranks that
    differ only along it (None: the whole world), its ``size`` and this
    rank's ``index`` along it."""

    group: object
    size: int
    index: int


_AXES: dict = {}


def set_axes(axes: dict) -> None:
    """Register the rank grid's axes ({name: Axis}) for the collectives and
    specs of this module (``parallel/mesh.make_mesh`` does); replaces the
    axes of the same names."""
    _AXES.update(axes)


def axis(name: str) -> Axis:
    """The registered axis ``name``; without one, ``data`` and ``batch`` are
    the world and any other axis is this rank alone."""
    got = _AXES.get(name)
    if got is not None:
        return got
    if name in ("data", "batch"):
        return Axis(None, process_count(), process_index())
    return Axis(None, 1, 0)


def _resolve(ax) -> tuple:
    """(group, size) of an axis given by name, as an ``Axis``, or None (the
    world)."""
    if ax is None:
        return None, process_count()
    if isinstance(ax, str):
        ax = axis(ax)
    return ax.group, ax.size


def data_count() -> int:
    """The ranks that hold different rows of a batch (slice × data)."""
    return axis("batch").size


def data_index() -> int:
    """This rank's data coordinate: ``slice·data + data``, the block of a
    batch it holds; the model ranks of one data group share it."""
    return axis("batch").index


def _entry_axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def backend_and_device(device_type: str, local_rank: int, local_world: int,
                       device_count: int) -> tuple:
    """(backend, device) of one rank: ``("gloo", "cpu")`` on the CPU;
    ``("nccl", "cuda:{local_rank}")`` when each of the ``local_world`` ranks
    has a card of its own; ``("gloo", "cuda:{local_rank % device_count}")``
    when ranks share the ``device_count`` cards."""
    if device_type == "cpu":
        return "gloo", "cpu"
    if device_type != "cuda":
        raise ValueError(f"no process-group rule for device type {device_type!r}")
    if device_count < 1:
        raise RuntimeError("device 'cuda' requested but no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    if local_world <= device_count:
        return "nccl", f"cuda:{local_rank}"
    return "gloo", f"cuda:{local_rank % device_count}"


def _device_count(device_type: str) -> int:
    return torch.cuda.device_count() if device_type == "cuda" else 0


def local_device(device="cuda") -> torch.device:
    """This rank's device under ``backend_and_device``'s rule (``cpu`` stays
    ``cpu``; ``cuda`` becomes this rank's card)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    _, name = backend_and_device("cuda", process_index(), process_count(),
                                 _device_count("cuda"))
    return torch.device(name)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> int:
    """Join the job's process group: ``init_process_group`` with
    ``init_method="tcp://<coordinator_address>"``, ``num_processes`` ranks,
    this one ``process_id``, the backend of ``backend_and_device`` for
    ``device``; on the card the rank's device becomes the current one.
    Without an address (one process) nothing happens. Errors propagate:
    a failed join must not leave the rank training alone. Returns the
    rank."""
    if coordinator_address is None:
        return process_index()
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator address needs num_processes and "
                         "process_id (--num-processes, --process-id)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    dev_type = torch.device(device).type
    backend, name = backend_and_device(dev_type, process_id, num_processes,
                                       _device_count(dev_type))
    if dev_type == "cuda":
        torch.cuda.set_device(torch.device(name))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier()


def host_local_batch_size(global_batch: int) -> int:
    """This rank's rows of a global batch: it over the data extent (the
    model ranks of one data group load the same rows)."""
    n = data_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n


def tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over the tensors of dicts, lists, tuples and
    NamedTuples, the containers rebuilt; other leaves (ints, modules) pass
    through. ``path`` is the tuple of keys, fields and indices down to the
    leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, path + (f,)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return tree


def global_batch_from_host_local(local_batch, sharding):
    """This rank's batch (a tensor or numpy array, or a dict of them, e.g.
    the labeled ``{"image", "label"}`` batches) on the device of
    ``sharding`` (``parallel/mesh.batch_sharding``). JAX assembles the
    global array from every host's part; here each rank keeps its part, and
    the step's collectives stand for the global array."""
    device = sharding.device
    return tree_map(lambda _, x: x.to(device), _as_tensors(local_batch))


def _as_tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return tree


def is_cross_process_sharded(spec) -> bool:
    """True when a leaf with partition ``spec`` (a tuple of axis names or
    None per dim, from ``parallel/mesh``) is split across the ranks, so that
    its full value takes a collective (``host_fetch``): ZeRO-1 moments, a
    batch. The one definition of this test: ``host_fetch``, the
    checkpoint's save and restore and the runners' save gates all route on
    it."""
    return process_count() > 1 and any(
        axis(name).size > 1 for e in (spec or ()) for name in _entry_axes(e))


def any_cross_process_sharded(shardings) -> bool:
    """True when any spec of ``shardings`` ({name: spec}) is split."""
    return any(is_cross_process_sharded(s) for s in (shardings or {}).values())


def gather_split(x: torch.Tensor, spec, axes=None) -> torch.Tensor:
    """The full value of ``x``, this rank's part of a tensor split by
    ``spec`` (one entry per dim: None, an axis name or a tuple of names,
    the first the major one): every split dim all-gathered over its axes,
    the minor axis first. A collective over those axes. ``axes``: a
    function of an axis name to its ``Axis`` (a mesh's ``axis``), the
    registered axes by default."""
    axes = axes or axis
    for dim, entry in enumerate(spec or ()):
        for name in reversed(_entry_axes(entry)):
            if axes(name).size > 1:
                if dim >= x.ndim:
                    raise ValueError(f"spec {spec} does not fit a leaf of shape "
                                     f"{tuple(x.shape)}")
                x = torch.cat(all_gather(x, axes(name)), dim)
    return x


def local_part(full: torch.Tensor, spec, axes=None) -> torch.Tensor:
    """This rank's part of ``full`` under ``spec`` (a view): each split dim
    cut into the product of its axes' sizes, the block at this rank's
    linear index over them (the first axis the major one). ``axes`` as
    ``gather_split``'s."""
    axes = axes or axis
    for dim, entry in enumerate(spec or ()):
        k, lin = 1, 0
        for name in _entry_axes(entry):
            a = axes(name)
            k, lin = k * a.size, lin * a.size + a.index
        if k > 1:
            n = full.shape[dim] // k
            full = full.narrow(dim, lin * n, n)
    return full


def host_fetch(tree, spec=None):
    """A CPU copy of ``tree`` whose split leaves hold their full value on
    every rank. ``spec``: None (every leaf whole), one partition spec for
    every leaf (e.g. ``("data",)`` for a batch), or {name: spec} by the
    leaf's dotted path (``parallel/mesh.state_shardings``). A split leaf is
    all-gathered along its split dim — a COLLECTIVE: every rank calls this
    at the same point, and only the coordinator need use the result."""
    def one(path, leaf):
        s = spec.get(".".join(map(str, path))) if isinstance(spec, dict) else spec
        if is_cross_process_sharded(s):
            leaf = gather_split(leaf.detach(), s)
        return leaf.detach().to("cpu", copy=True)

    return tree_map(one, _as_tensors(tree))


def all_reduce_mean(tensors: list, axis_name=None, mean: bool = True) -> list:
    """The mean (or, ``mean=False``, the sum) over the ranks of ``axis_name``
    (an axis's name or ``Axis``; the world when None) of each tensor of
    ``tensors``, through one ``all_reduce`` of a flat float32 buffer; each
    result keeps its tensor's shape and dtype. The inputs themselves on an
    axis of one rank."""
    group, n = _resolve(axis_name)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    with comm.record("grad", flat):
        dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(n)
    out, i = [], 0
    for t in tensors:
        k = t.numel()
        out.append(flat[i:i + k].view(t.shape).to(t.dtype))
        i += k
    return out


def all_reduce_sum(t: torch.Tensor, axis_name=None) -> torch.Tensor:
    """The sum over the ranks of ``axis_name`` (as ``all_reduce_mean``'s)
    of ``t`` (a new tensor)."""
    out = t.detach().clone()
    group, n = _resolve(axis_name)
    if n > 1:
        dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, axis_name=None) -> list:
    """Every rank's ``t`` (all of one shape and dtype) over ``axis_name``
    (as ``all_reduce_mean``'s), in the order of the axis's index."""
    group, n = _resolve(axis_name)
    if n == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def is_coordinator() -> bool:
    """True on the process that writes checkpoints, events and PNGs (rank
    0). Every runner gates its file outputs on it; every rank computes, so
    collectives stay aligned; every rank restores (shared filesystem)."""
    return process_index() == 0


def shard_files_for_host(files: list) -> list:
    """This rank's share of a file list (round robin by data coordinate), so
    each data group decodes 1/N of the data and the model ranks of a group
    read the same files."""
    n = data_count()
    if n == 1:
        return files
    shard = files[data_index()::n]
    if not shard:
        raise ValueError(f"host {data_index()}/{n} got no files "
                         f"(dataset has only {len(files)})")
    return shard
