"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/<name>-<hash>.so`` beside the package (``build/`` is git-ignored),
for ``sm_90a``, with a plain C interface: no PyTorch headers, so a build
takes seconds. The hash covers the source and the flags, so an edited source
is never served from a stale library. ``build_all`` starts every missing
build at once and waits for all of them; ``load`` builds at first use.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"{name}-{digest}.so"


def build_all(names=None) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    current library, one ``nvcc`` each, all started together. Returns
    ``{name: ptxas report}`` for the sources it compiled."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = stdout + stderr
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current CUDA stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
    building a Stream object on every launch (4.5 µs a call on the card's
    host, PERF.md Findings)."""
    return torch._C._cuda_getCurrentRawStream(index)
