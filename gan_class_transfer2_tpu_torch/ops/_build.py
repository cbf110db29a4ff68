"""Builds the port's CUDA sources and its C++ host library, and loads them
with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/<name>-<hash>.so`` beside the package (``build/`` is git-ignored),
for ``sm_90a``, with a plain C interface: no PyTorch headers, so a build
takes seconds. The hash covers the source and the flags, so an edited source
is never served from a stale library. ``build_all`` starts every missing
build at once and waits for all of them; ``load`` builds at first use.
``load_host`` does the same for a C++ source run on the host (the native
data loader, ``data/native/dataloader.cc``) with the host's ``g++``.
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
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-Wall", "-pthread")

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


def load_host(source: Path, libs=()) -> ctypes.CDLL:
    """The loaded library of the C++ file ``source``, compiled first if
    needed with ``g++ -O3 -fPIC -std=c++17 -shared`` and linked with
    ``libs``. The build writes a file of its own and moves it into place,
    so processes that build at once never load half a library. Raises
    RuntimeError with the compiler's message when the build fails."""
    digest = hashlib.sha1(source.read_bytes() + " ".join((*HOST_FLAGS, *libs)).encode())
    path = BUILD / f"{source.stem}-{digest.hexdigest()[:12]}.so"
    lib = _loaded.get(str(path))
    if lib is None:
        if not path.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *HOST_FLAGS, "-o", str(tmp), str(source), *libs]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"C++ build of {source.name} failed: {e}") from None
            if proc.returncode != 0:
                raise RuntimeError(f"C++ build of {source.name} failed (exit "
                                   f"{proc.returncode}):\n{proc.stderr or proc.stdout}")
            os.replace(tmp, path)
        lib = _loaded[str(path)] = ctypes.CDLL(str(path))
    return lib


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current CUDA stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
    building a Stream object on every launch (4.5 µs a call on the card's
    host, PERF.md Findings)."""
    return torch._C._cuda_getCurrentRawStream(index)
