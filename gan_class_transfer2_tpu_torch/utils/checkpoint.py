"""Checkpoint / resume — counterpart of gan_class_transfer2_tpu/utils/checkpoint.py,
in a torch format.

Layout (the JAX module's, with the orbax directory replaced):

    <dir>/step_<N:09d>/state.pt        one torch.save file: plain tensors + ints
    <dir>/step_<N:09d>.extra.json      sidecar (the data-stream position)
    <dir>/step_<N:09d>.extra.host<k>.json  rank k's own sidecar (multi-process runs)
    <dir>/config.json                  the run's Config + checkpoint_format_version
    <dir>/best/                        keep_best: a checkpoint dir of its own + best.json

``state.pt`` holds ``{"format": 1, "step": N, "tensors": {name: tensor},
"ints": {name: int}}``, read back with ``torch.load(weights_only=True)``.
The names are the state's structure flattened: a ``TrainState`` gives
``model.<param>``, ``opt_state.<i>.mu.<j>``, ``ema_params.<j>``,
``scale_state.scale``; a ``GANState`` gives ``g_ab.<param>`` …, a
``ConditionalGANState`` ``generator.<param>``, ``discriminator.<param>``
…; the optional ``generator`` entry is the Runner's ``torch.Generator``
state (a ``ConditionalGANState``'s module of that name is
``generator.<param>``, so the two never collide).

What differs from the JAX package, and why:

  * The port updates parameters and Adam moments in place (B2, and
    ``apply_updates``), so nothing decouples a saved state from the next
    step the way JAX's ``device_get`` does. ``host_complete`` copies every
    tensor to the CPU before it returns; ``AsyncSaver.submit`` takes that
    copy, so the next step cannot change what is being written.
  * ``restore`` copies the saved values into the live tensors
    (``Tensor.copy_``): each keeps its device and dtype (bfloat16 moments
    stay bfloat16) and the lists that B2 walks stay the same objects.
    Python ints (steps, MultiSteps counters) come back in a rebuilt state.
  * Multi-process runs (``parallel/multihost``): every rank restores;
    only the coordinator writes the step, but every rank writes its own
    ``step_<N>.extra.host<k>.json`` first (the ranks read different file
    shards, so their data positions are their own), and ``load_extra(host=k)``
    prefers it. Under ZeRO-1 a state's optimizer leaves are this rank's
    slices: ``host_complete(..., shardings)`` gathers them (a collective,
    run on every rank) so the file holds the full moments, and ``restore(...,
    shardings)`` slices them again, so a checkpoint moves between world
    sizes.

Each save writes ``step_<N>.tmp`` and renames it into place, so a
``step_<N>`` directory that exists is complete.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import re
import shutil
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import Config
from ..parallel import multihost

# stamped into config.json; bump when the layout above changes
CHECKPOINT_FORMAT_VERSION = 1
STATE_FILE = "state.pt"


class Snapshot(NamedTuple):
    """A state's values on the CPU, detached from the live tensors."""

    step: int
    tensors: dict
    ints: dict


class Subset:
    """A state to restore in part: ``restore(ckpt_dir, Subset(state))``
    fills the tensors and ints that ``state`` holds (its None fields hold
    nothing) from a checkpoint that may hold more — a server's serving
    modules out of a whole train state's checkpoint."""

    def __init__(self, state):
        self.state = state


def _walk(node, prefix: str, out: dict):
    """Flatten a state into ``out``: {name: tensor or int}, in a fixed order."""
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        out[prefix] = node
    elif isinstance(node, nn.Module):
        for k, v in node.state_dict(keep_vars=True).items():
            out[f"{prefix}.{k}"] = v
    elif isinstance(node, bool) or not isinstance(node, (int, tuple, list)):
        raise TypeError(f"checkpoint: cannot store {prefix!r} of type {type(node).__name__}")
    elif isinstance(node, int):
        out[prefix] = node
    elif hasattr(node, "_fields"):
        for field, value in zip(node._fields, node):
            _walk(value, f"{prefix}.{field}" if prefix else field, out)
    else:
        for i, value in enumerate(node):
            _walk(value, f"{prefix}.{i}", out)


def host_complete(state, generator: Optional[torch.Generator] = None,
                  shardings: Optional[dict] = None) -> Snapshot:
    """A CPU copy of ``state`` (a ``TrainState`` or ``GANState``) and of
    ``generator``'s state, complete when this returns. ``shardings``
    ({name: spec}, ``parallel/mesh.state_shardings``): leaves split across
    the ranks are gathered to their full value (``multihost.host_fetch``,
    a collective: every rank calls this)."""
    flat: dict = {}
    _walk(state, "", flat)
    tensors = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}
    tensors = multihost.host_fetch(tensors, {k: (shardings or {}).get(k) for k in tensors})
    ints = {k: int(v) for k, v in flat.items() if not isinstance(v, torch.Tensor)}
    if generator is not None:
        tensors["generator"] = generator.get_state()
        ints["generator_is_cuda"] = int(generator.device.type == "cuda")
    return Snapshot(int(state.step), tensors, ints)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:09d}")


def _write_json(path: str, obj, **kw) -> None:
    with open(path + ".tmp", "w") as fh:
        json.dump(obj, fh, **kw)
    os.rename(path + ".tmp", path)


def save(ckpt_dir: str, state, cfg: Config, step: Optional[int] = None,
         extra: Optional[dict] = None, generator: Optional[torch.Generator] = None) -> str:
    """Save ``state`` (live, or a ``Snapshot`` from ``host_complete``) and
    the config at ``<ckpt_dir>/step_<N>``; returns that path. ``extra``: a
    JSON sidecar written after the step commits. ``cfg.checkpoint_keep >
    0`` prunes all but the newest N step dirs, never the one just written.
    A step that already exists is left as it is."""
    snap = state if isinstance(state, Snapshot) else host_complete(state, generator)
    step = snap.step if step is None else int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    keep = cfg.checkpoint_keep
    if os.path.exists(path):
        if keep > 0:
            prune(ckpt_dir, keep, protect=step)
        return path
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)  # stale partial write from a crashed save
    os.makedirs(tmp)
    torch.save({"format": CHECKPOINT_FORMAT_VERSION, "step": step,
                "tensors": snap.tensors, "ints": snap.ints}, os.path.join(tmp, STATE_FILE))
    os.rename(tmp, path)
    if extra is not None:
        save_host_extra(ckpt_dir, step, extra)
    meta = json.loads(cfg.to_json())
    meta["checkpoint_format_version"] = CHECKPOINT_FORMAT_VERSION
    _write_json(os.path.join(ckpt_dir, "config.json"), meta, indent=2, sort_keys=True)
    if keep > 0:
        prune(ckpt_dir, keep, protect=step)
    return path


class AsyncSaver:
    """Single-worker background checkpoint writer (``Config.checkpoint_async``).

    The caller snapshots the state to the CPU first (``host_complete``):
    the next step updates the live tensors in place. Serialising, the
    rename, the sidecars and retention run here on one thread, so saves
    commit in submission order. A failed save is re-raised on the next
    ``submit()``/``wait()``. ``submit`` blocks while ``max_pending`` saves
    are queued, so a slow disk cannot pile up host copies of the state."""

    def __init__(self, max_pending: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gct2-ckpt")
        self._pending: list = []
        self._max_pending = max(1, max_pending)

    def _reap(self, block: bool = False) -> None:
        err, still = None, []
        for f in self._pending:
            if block or f.done():
                exc = f.exception()
                if exc is not None and err is None:
                    err = exc
            else:
                still.append(f)
        self._pending = still
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    def submit(self, ckpt_dir: str, host_state: Snapshot, cfg: Config,
               step: Optional[int] = None, extra: Optional[dict] = None) -> str:
        """Queue a save of a ``Snapshot``; returns the step path it commits to."""
        self._reap()
        while len(self._pending) >= self._max_pending:
            exc = self._pending.pop(0).exception()  # waits for the oldest save
            if exc is not None:
                raise RuntimeError("async checkpoint save failed") from exc
        n = host_state.step if step is None else int(step)
        self._pending.append(self._pool.submit(save, ckpt_dir, host_state, cfg, n, extra))
        return _step_path(ckpt_dir, n)

    def wait(self) -> None:
        """Drain the queue; re-raise the first background failure."""
        self._reap(block=True)

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def all_steps(ckpt_dir: str) -> list:
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", name)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def prune(ckpt_dir: str, keep: int, protect: Optional[int] = None) -> int:
    """Delete all but the newest ``keep`` step dirs and their sidecars;
    returns how many were removed. ``protect`` names a step that is never
    deleted (it still counts toward ``keep``). Leftover ``.json.tmp``
    sidecars of steps older than the newest are swept too."""
    steps = all_steps(ckpt_dir)
    removed = 0
    for s in steps[:-keep] if keep > 0 else []:
        if s == protect:
            continue
        path = _step_path(ckpt_dir, s)
        shutil.rmtree(path, ignore_errors=True)
        for pat in (".extra*.json", ".extra*.json.tmp"):
            for extra in globlib.glob(globlib.escape(path) + pat):
                os.remove(extra)
        removed += 1
    if steps:
        # leftover .tmp sidecars, and orphan rank sidecars: a rank writes
        # its own before the coordinator commits the step, so a crashed save
        # leaves one with no step dir; only steps older than the newest
        # committed one are swept (a newer one may belong to a save in flight)
        have = set(all_steps(ckpt_dir))
        root = globlib.escape(os.path.abspath(ckpt_dir))
        for pattern, orphans_only in (("step_*.extra*.json.tmp", False),
                                      ("step_*.extra.host*.json", True)):
            for extra in globlib.glob(os.path.join(root, pattern)):
                m = re.match(r"step_(\d+)\.extra", os.path.basename(extra))
                if m and int(m.group(1)) < steps[-1] and not (
                        orphans_only and int(m.group(1)) in have):
                    os.remove(extra)
    return removed


def save_best(ckpt_dir: str, state, cfg: Config, *, metric: str, value: float,
              epoch: int) -> str:
    """Persist ``state`` as the best so far under ``<ckpt_dir>/best`` (a
    checkpoint dir of its own, so ``--checkpoint-dir ckpt/best`` reads it),
    with ``best.json`` recording the metric, its value, the step, the epoch
    and the feature extractor."""
    best_dir = os.path.join(ckpt_dir, "best")
    path = save(best_dir, state, cfg)
    step = state.step
    _write_json(os.path.join(best_dir, "best.json"), {
        "metric": metric, "value": float(value), "step": int(step), "epoch": int(epoch),
        # values are comparable only under the same feature extractor
        "fid_extractor": cfg.fid_extractor,
    })
    prune(best_dir, keep=1, protect=int(step))
    return path


def read_best(ckpt_dir: str) -> Optional[dict]:
    """The ``best.json`` record written by ``save_best`` (None when absent)."""
    path = os.path.join(ckpt_dir, "best", "best.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def _extra_path(ckpt_dir: str, step: int, host: Optional[int] = None) -> str:
    suffix = ".extra.json" if host is None else f".extra.host{host}.json"
    return _step_path(ckpt_dir, step) + suffix


def save_host_extra(ckpt_dir: str, step: int, extra: dict, host: Optional[int] = None) -> str:
    """Write the JSON sidecar of ``step_<N>`` atomically; returns its path.
    ``host=None``: the coordinator's ``.extra.json``, written after the
    step commits (a crash in between costs only the data position);
    ``host=k``: rank k's own ``.extra.host<k>.json`` (JAX
    checkpoint.py:229-250), one file a rank, so ranks never race."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _extra_path(ckpt_dir, int(step), host)
    _write_json(path, extra)
    return path


def load_extra(ckpt_dir: str, step: Optional[int] = None,
               host: Optional[int] = None) -> Optional[dict]:
    """The JSON sidecar of ``step_<N>`` (the latest step by default), or
    None. ``host``: prefer that rank's own sidecar, falling back to the
    coordinator's (valid as a fallback: the ranks' streams advance in
    lockstep)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    for path in ([_extra_path(ckpt_dir, step, host)] if host is not None else []) + [
            _extra_path(ckpt_dir, step)]:
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
    return None


def load_state_file(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The raw contents of ``step_<N>/state.pt`` (latest step by default)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(_step_path(ckpt_dir, step), STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: is step_{step:09d} a JAX orbax checkpoint? "
            "tools/convert_orbax_checkpoint.py converts one")
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore(ckpt_dir: str, like, step: Optional[int] = None,
            generator: Optional[torch.Generator] = None, shardings: Optional[dict] = None):
    """Restore into ``like`` (a live state of the same structure, e.g. from
    ``trainer.init_state``, or a ``Subset`` of one): every tensor is
    overwritten in place, and the state is returned with its ints (steps,
    counters) from the file. With ``generator``, its state is restored too
    when the checkpoint holds one from a generator on the same kind of
    device. ``shardings`` ({name: spec}): a leaf split across the ranks
    (a ZeRO-1 moment, a kernel under tensor parallelism) takes this rank's
    part of the saved full value, by its coordinates on the registered
    grid (``multihost.local_part``)."""
    partial = isinstance(like, Subset)
    if partial:
        like = like.state
    data = load_state_file(ckpt_dir, step)
    live: dict = {}
    _walk(like, "", live)
    saved = dict(data["tensors"])
    saved.update(data["ints"])
    gen_state = saved.pop("generator", None)
    gen_cuda = saved.pop("generator_is_cuda", None)
    missing, unknown = sorted(set(live) - set(saved)), sorted(set(saved) - set(live))
    if missing or (unknown and not partial):
        raise ValueError(
            f"checkpoint in {ckpt_dir} does not match the state's structure (was it "
            f"written under another optimizer or model config?): missing {missing[:5]}, "
            f"unexpected {unknown[:5]}")
    for name, value in live.items():
        if isinstance(value, torch.Tensor):
            src = saved[name]
            spec = (shardings or {}).get(name)
            if multihost.is_cross_process_sharded(spec):
                src = multihost.local_part(src, spec)
            if src.shape != value.shape:
                raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)}, the state "
                                 f"has {tuple(value.shape)}")
            value.copy_(src)
    if generator is not None and gen_state is not None:
        if bool(gen_cuda) == (generator.device.type == "cuda"):
            generator.set_state(gen_state)
        else:
            print("checkpoint: its generator state is from another kind of device; the "
                  "run's generator keeps its fresh seed")
    return _rebuild(like, "", saved)


def _rebuild(node, prefix: str, saved: dict):
    """``node`` with its ints taken from ``saved`` (tensors already copied)."""
    if node is None or isinstance(node, (torch.Tensor, nn.Module)):
        return node
    if isinstance(node, int):
        return int(saved[prefix])
    if hasattr(node, "_fields"):
        return type(node)(*(_rebuild(v, f"{prefix}.{f}" if prefix else f, saved)
                            for f, v in zip(node._fields, node)))
    if isinstance(node, list):
        node[:] = [_rebuild(v, f"{prefix}.{i}", saved) for i, v in enumerate(node)]
        return node
    return type(node)(_rebuild(v, f"{prefix}.{i}", saved) for i, v in enumerate(node))


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as fh:
        return Config.from_json(fh.read())
