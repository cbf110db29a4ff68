#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an orbax ``step_<N>`` dir, its
``.extra.json`` sidecar and ``config.json``) into the PyTorch port's format
(gan_class_transfer2_tpu_torch/utils/checkpoint.py), so that the port's
``train``/``gan-train`` resume the run and its ``sample``/``edit``/
``export-weights`` read it:

    python tools/convert_orbax_checkpoint.py --src ckpt_jax --dst ckpt_torch \\
        [--model diffusion|gan] [--step N]

The JAX state is restored into the template of the JAX package's
``init_state`` / ``init_gan_state`` and carried by the port's
``utils/weights.from_jax_train_state`` / ``from_jax_gan_state`` (params,
optimizer state, EMA, loss-scale state). The data-position sidecar is
copied. A JAX run's randomness is a key folded with the step; the port's
is a ``torch.Generator``, so the converted checkpoint holds none and the
resumed run seeds a fresh one from ``cfg.seed``. The mesh, pipeline and
ZeRO-1 fields of the config that the port refuses are reset to one card:
they do not change the state's structure.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ONE_CARD = ("mesh_data", "mesh_model", "mesh_slice", "pipeline_stages", "zero1")


def convert(src: str, dst: str, model: str = "diffusion", step=None) -> str:
    """Convert ``src``'s latest (or ``step``) checkpoint into ``dst``;
    returns the port's step path."""
    import jax

    from gan_class_transfer2_tpu.utils import checkpoint as jckpt
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt
    from gan_class_transfer2_tpu_torch.utils import weights

    jcfg = jckpt.load_config(src)
    step = jckpt.latest_step(src) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {src}")
    key = jax.random.PRNGKey(jcfg.seed)
    if model == "diffusion":
        from gan_class_transfer2_tpu.train import trainer

        like = trainer.init_state(jcfg, key)
    else:
        from gan_class_transfer2_tpu.train import gan

        like = gan.init_gan_state(jcfg, key)
    state = jax.device_get(jckpt.restore(src, like, step))

    defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    raw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in defaults}
    reset = {k: defaults[k] for k in _ONE_CARD if raw[k] > 1 or raw[k] is True}
    if reset:
        print(f"config: {sorted(reset)} reset to one card (the state is the same)")
    raw.update(reset, checkpoint_dir=dst, classes=tuple(raw["classes"]))
    cfg = Config(**raw).validate()
    if model == "diffusion":
        port = weights.from_jax_train_state(cfg, state, device="cpu")
    else:
        port = weights.from_jax_gan_state(cfg, state, device="cpu")
    return ckpt.save(dst, port, cfg, step=int(step), extra=jckpt.load_extra(src, step))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="the JAX checkpoint dir")
    p.add_argument("--dst", required=True, help="the port's checkpoint dir to write")
    p.add_argument("--model", choices=("diffusion", "gan"), default="diffusion")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(f"wrote {convert(args.src, args.dst, args.model, args.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
