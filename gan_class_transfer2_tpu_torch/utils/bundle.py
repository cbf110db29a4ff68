"""Compiled model bundles — counterpart of
gan_class_transfer2_tpu/utils/bundle.py: self-contained inference artifacts
with the trained weights inside, which load and run without the model's
code being rebuilt.

Each inference program (the sampler, the raw denoiser forward, the
inversion, the denoise preview, a GAN transfer) is traced once with
``torch.export.export(..., strict=False)`` under ``torch.no_grad()``, over
a symbolic batch ``Dim("b")``, with the weights (the EMA where kept) as the
program's parameters, and saved as ``<name>.pt2``. Bundles are:

- **batch-polymorphic** — one artifact serves any batch size;
- **multi-platform** — ``platforms`` lists the devices a bundle may run on
  (``cuda,cpu`` by default); programs are saved with their weights on the
  CPU and moved to the caller's device when they load
  (``torch.export.passes.move_to_device_pass``, which also rewrites the
  devices that ``torch.export`` records in the graph, such as those of
  ``_assert_tensor_metadata``), so a bundle exported on the card runs on the
  CPU and back;
- **self-describing** — ``manifest.json`` records the config, model kind,
  train step, program signatures (``"b"`` for the batch) and the torch
  version, with the JAX manifest's keys (``torch_version`` in place of
  ``jax_version``).

The kernels stay in the graph by name: B4 and B3 are ``torch.library``
custom ops (``gct2::down_conv_k4s2``, ``gct2::instance_norm``) that the
model code calls while ``torch.compiler.is_exporting()``, so a bundle run on
the card launches the same hand-written kernels as the in-process path, and
no ``aten.convolution`` stands in for a conv that B4's gate admits.

The loops. ``torch.export`` unrolls a Python loop, and the sampler at
``sample_stride=1`` and the inversion run T = 200 denoiser calls: an unrolled
program would be 200 copies of the U-Net, slow to export, save and load.
``sample`` and ``invert`` are therefore exported as ONE step body each,
``(x̂, ε̂, t[, class]) → (x̂, ε̂)`` with the timestep a 0-d float32 tensor
input (``sampler.step``), and the manifest carries the fixed visit list
(``"timesteps"``) that ``Bundle.call`` runs, as the in-process sampler
does: the same op order, one program call per timestep.

Layout::

    bundle/
      manifest.json
      sample.pt2
      denoise.pt2
      ...

CLI: ``export-model --checkpoint-dir C --out bundle/`` writes one;
``sample --bundle bundle/`` and ``serve --bundle bundle/`` consume one.
Library: :func:`export_bundle` / :func:`load_bundle`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

FORMAT_VERSION = 1

# program name -> bundle file name
_PROGRAM_FILE = "{name}.pt2"
_MANIFEST = "manifest.json"


class _Program(torch.nn.Module):
    """A program as a module: ``fn(*inputs)`` over ``nets`` (registered, so
    their weights are the exported program's parameters)."""

    def __init__(self, fn, **nets):
        super().__init__()
        self.nets = torch.nn.ModuleDict(nets)
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.nets, *args)


def _diffusion_programs(cfg):
    """Program table for a diffusion checkpoint: name -> (fn, signature,
    visit list or None). Signature entries: ``("image", C)`` for a
    (b, size, size, C) float32 input, ``("ivec",)`` for a (b,) int32 one,
    ``("t",)`` for the 0-d float32 timestep of a step body. A program with a
    visit list is a step body that ``Bundle.call`` runs over it."""
    from ..models import api as model_api
    from ..models.unet import DTYPES
    from ..sample import sampler

    conditional = cfg.num_classes > 0
    cls = [("ivec",)] if conditional else []

    def denoise(nets, x, t, *c):
        return model_api.apply_denoiser(cfg, nets["model"], x.to(DTYPES[cfg.compute_dtype]), t,
                                        class_idx=c[0] if c else None).float()

    def step(nets, x_theta, epsilon_theta, t, *c):
        return sampler.step(cfg, nets["model"], x_theta, epsilon_theta, t,
                            c[0] if c else None)

    def preview(nets, image, noise, *c):
        # the /denoise serving surface; returns the denoised image only
        return sampler.preview(cfg, nets["model"], image, noise,
                               class_idx=c[0] if c else None)[0]

    step_sig = [("image", 3), ("image", 3), ("t",)] + cls
    return {
        "denoise": (denoise, [("image", 3), ("ivec",)] + cls, None),
        "sample": (step, step_sig, [int(t) for t in sampler.sample_timesteps(cfg)]),
        "invert": (step, step_sig, list(range(1, cfg.steps + 1))),
        "preview": (preview, [("image", 3), ("image", 3)] + cls, None),
    }


def _gan_programs(cfg):
    from ..train import gan as gan_lib

    def transfer(nets, x):
        return gan_lib._generate(cfg, nets["g"], x)

    return {f"transfer_{d}": (transfer, [("image", 3)], None) for d in ("ab", "ba")}


def _cgan_programs(cfg):
    from ..models import conditional as cond_lib

    def transfer(nets, x, target_class):
        return cond_lib.conditional_unet_apply(cfg, nets["g"], x, target_class)

    return {"transfer": (transfer, [("image", 3), ("ivec",)], None)}


def _nets(model_kind: str, state):
    """program name -> the modules it runs: the EMA weights where kept (one
    copy of the denoiser's EMA for all four diffusion programs)."""
    if model_kind == "diffusion":
        from ..train import trainer as trainer_lib

        nets = {"model": trainer_lib.eval_model(state)}
        return lambda name: nets
    if model_kind == "gan":
        from ..train import gan as gan_lib

        return lambda name: {"g": gan_lib.select_generator(state, name[len("transfer_"):])}
    from ..train import conditional_gan as cgan_lib

    return lambda name: {"g": cgan_lib.select_generator(state)}


def _spec_json(kind, size: int) -> Dict[str, Any]:
    """An input or output as JAX's manifest gives it: dims as strings."""
    if kind[0] == "image":
        return {"shape": ["b", str(size), str(size), str(kind[1])], "dtype": "float32"}
    return {"shape": ["b"], "dtype": "int32"}


def _example(kind, size: int, device):
    if kind[0] == "image":
        return torch.zeros((2, size, size, kind[1]), device=device)
    if kind[0] == "ivec":
        return torch.zeros((2,), dtype=torch.int32, device=device)
    return torch.ones((), device=device)


def _program_table(cfg, model: str = "diffusion"):
    """The program table of a model kind: name -> (fn, signature, visit
    list or None)."""
    if model == "diffusion":
        return _diffusion_programs(cfg)
    if model == "gan":
        return _gan_programs(cfg)
    if model == "cgan":
        return _cgan_programs(cfg)
    raise ValueError(f"unknown model kind {model!r}")


def _export_program(cfg, fn, sig, nets: dict, device):
    """``torch.export`` of ``fn`` over ``nets`` on ``device``, batch
    symbolic, under ``torch.no_grad()``; returns the ExportedProgram with
    its weights moved to the CPU (the saved form)."""
    from torch.export import Dim, export
    from torch.export.passes import move_to_device_pass

    batch = Dim("b")
    args = tuple(_example(k, cfg.size, device) for k in sig)
    dynamic = tuple(None if k[0] == "t" else {0: batch} for k in sig)
    with torch.no_grad():
        ep = export(_Program(fn, **nets), args, dynamic_shapes={"args": dynamic}, strict=False)
    return move_to_device_pass(ep, "cpu")


def export_bundle(cfg, state, out_dir: str, *, model: str = "diffusion", programs=None,
                  platforms=("cuda", "cpu"), log=None) -> Dict[str, Any]:
    """Export trained ``state`` as a self-contained bundle.

    ``model``: "diffusion" (denoise/sample/invert/preview), "gan"
    (transfer_ab/transfer_ba), or "cgan" (transfer). ``programs``: subset of
    program names to export (default: all for the model kind). The programs
    are traced on the device the state's weights live on. ``log``: called
    with one line per program (export and save seconds, MB). Returns the
    manifest."""
    table = _program_table(cfg, model)
    if programs is not None:
        if not programs:
            raise ValueError(
                f"programs must be non-empty when given; "
                f"available for {model}: {sorted(table)}"
            )
        unknown = set(programs) - set(table)
        if unknown:
            raise ValueError(
                f"unknown programs {sorted(unknown)}; "
                f"available for {model}: {sorted(table)}"
            )
        table = {k: v for k, v in table.items() if k in programs}
    bad = [p for p in platforms if p not in ("cuda", "cpu")]
    if bad or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of ('cuda', 'cpu'), "
                         f"got {tuple(platforms)}")

    os.makedirs(out_dir, exist_ok=True)
    manifest: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "model": model,
        "step": int(state.step),
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "config": json.loads(cfg.to_json()),
        "programs": {},
    }
    nets_of = _nets(model, state)
    for name, (fn, sig, visits) in table.items():
        nets = nets_of(name)
        device = next(next(iter(nets.values())).parameters()).device
        t0 = time.perf_counter()
        ep = _export_program(cfg, fn, sig, nets, device)
        t1 = time.perf_counter()
        fname = _PROGRAM_FILE.format(name=name)
        path = os.path.join(out_dir, fname)
        torch.export.save(ep, path)
        t2 = time.perf_counter()
        if visits is None:
            inputs = [_spec_json(k, cfg.size) for k in sig]
            outputs = [_spec_json(("image", 3), cfg.size)]
        else:
            # the user's signature: the initial state (x̂ = ε̂) and the class
            inputs = [_spec_json(k, cfg.size) for k in sig if k[0] != "t"][1:]
            outputs = [_spec_json(("image", 3), cfg.size)] * (1 if name == "sample" else 2)
        entry = {"file": fname, "inputs": inputs, "outputs": outputs}
        if visits is not None:
            entry["timesteps"] = visits
        manifest["programs"][name] = entry
        if log is not None:
            log(f"  {name}: exported in {t1 - t0:.3f} s on {device.type}, saved in "
                f"{t2 - t1:.3f} s ({os.path.getsize(path) / 1e6:.1f} MB)")
    with open(os.path.join(out_dir, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
    return manifest


class Bundle:
    """A loaded model bundle: ``bundle.call(name, *tensors)``.

    Programs load lazily (one read per program, cached) onto ``device``,
    which must be one of ``manifest["platforms"]``. Inputs are tensors or
    numpy arrays (moved to ``device``); outputs are tensors on ``device``
    (a tuple for ``invert``)."""

    def __init__(self, path: str, manifest: Dict[str, Any], device="cuda"):
        from ..models.api import resolve_device

        self.path = path
        self.manifest = manifest
        dev = resolve_device(device)
        if dev.type not in manifest["platforms"]:
            raise ValueError(f"bundle {path!r} runs on {manifest['platforms']}, not on "
                             f"{dev.type!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._loaded: Dict[str, Any] = {}

    @property
    def programs(self):
        return sorted(self.manifest["programs"])

    def load(self, name: str):
        """The program's module on the bundle's device (loaded at first use)."""
        if name not in self.manifest["programs"]:
            raise KeyError(f"bundle has no program {name!r}; available: {self.programs}")
        if name not in self._loaded:
            from torch.export.passes import move_to_device_pass

            entry = self.manifest["programs"][name]
            ep = torch.export.load(os.path.join(self.path, entry["file"]))
            if self.device.type != "cpu":
                ep = move_to_device_pass(ep, str(self.device))
            ts = [torch.tensor(float(t), dtype=torch.float32, device=self.device)
                  for t in entry.get("timesteps", ())]
            self._loaded[name] = (ep.module(), ts)
        return self._loaded[name]

    def call(self, name: str, *args):
        from ..models.unet import DTYPES, ieee_fp32

        module, ts = self.load(name)
        args = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                for a in args]
        args = [a.to(self.device) for a in args]
        dtype = DTYPES[self.manifest["config"]["compute_dtype"]]
        # float32 convs in IEEE float32, as unet_apply holds them in process:
        # the flags are read when a conv runs, not recorded in the graph
        entry = self.manifest["programs"][name]
        with torch.inference_mode(), ieee_fp32(dtype, self.device):
            if "timesteps" not in entry:
                return module(*args)
            x = eps = args[0]  # the step body over the visit list, from x̂ = ε̂
            for t in ts:
                x, eps = module(x, eps, t, *args[1:])
            return x if len(entry["outputs"]) == 1 else (x, eps)


def load_bundle(path: str, device="cuda") -> Bundle:
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"{path!r} is not a model bundle (no {_MANIFEST})")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"bundle format_version {version} unsupported "
            f"(this build reads {FORMAT_VERSION})"
        )
    return Bundle(path, manifest, device)
