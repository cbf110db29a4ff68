"""Experiment configuration — the port's own copy of the JAX package's Config.

Field names, defaults and JSON form are those of
``gan_class_transfer2_tpu/config.py``, and five of the port's own (below),
so one ``--config`` file drives both packages. The port imports nothing of
the JAX package, so the dataclass is repeated here. Comments that explain a
field's meaning live beside the JAX copy; this copy adds what the port does
differently:

  * ``validate`` makes the JAX package's checks, and those of the port's
    own fields: every feature is ported. The mesh axes and ``zero1`` run
    over processes (parallel/mesh.py holds the grid to the world size); the
    pipeline's compositional refusals are raised where JAX raises them,
    when ``parallel/pipeline.PipelineTrainer`` is built.
  * The tensor picks the hand-written CUDA kernels, not a field: on the
    card instance norm runs B3 (ops/norm.py), and the convs run B4 where
    its shape gate admits them and the conv epilogue (ops/conv.py). The
    JAX package's field that picks its conv route has no counterpart here:
    ``from_json`` drops it with every key the port does not know, and
    ``to_json`` writes none, so the JAX package reads its default.
  * The port's own fields, for the published CycleGAN (arXiv 1703.10593;
    the authors' pytorch-CycleGAN-and-pix2pix): ``generator`` ("unet", or
    "resnet": models/resnet.py, ``pixel_size`` filters (ngf),
    ``octaves`` down and up convs, ``resnet_blocks`` residual blocks),
    ``d_layout`` ("strided", or "patchgan70": the 70×70 PatchGAN of
    models/discriminator.py, ``d_octaves`` k4/s2 convs, then a k4/s1 conv
    and a k4/s1 head), ``image_pool`` (fakes kept a class for D's
    history, 0 = off; train/image_pool.py) and ``adam_b1`` (Adam's β₁).
    Their defaults are the JAX package's behaviour; ``to_json`` leaves them
    out at their defaults, so a config the JAX package can express writes
    the JAX package's JSON, and the JAX package's ``from_json`` drops them.
    The ResNet generator, the 70×70 PatchGAN and the pool run on one card
    or over data parallelism only.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # ------------------------------------------------------------------ data
    dataset_pattern: str = "data/train/*.png"
    example_image_path: Optional[str] = None
    classes: Tuple[str, ...] = ()
    shuffle_buffer: int = 1000
    cache: bool = False
    native_loader: bool = True
    data_workers: int = 2
    data_hbm: int = 0

    # ----------------------------------------------------------------- model
    size: int = 256
    pixel_size: int = 128
    max_size: int = 512
    block_depth: int = 0
    octaves: int = 6
    skip_mode: str = "concat"  # concat | residual | none
    per_step_output: bool = False

    # ------------------------------------------------------------- diffusion
    steps: int = 200
    num_classes: int = 0
    class_embed_dim: int = 8
    schedule: str = "quadratic"  # quadratic|exponential|rational_exponential|geometric|cosine2|quartic
    parameterization: str = "x"  # x | epsilon | scaled_epsilon | ode
    prediction_weighting: bool = False
    test_step: int = 25
    bits_per_pixel: int = 3
    sample_stride: int = 1

    # ------------------------------------------------------------------ loss
    loss: str = "mse"  # mse | l1 | dct | mse_multiscale

    # ------------------------------------------------------------- optimizer
    optimizer: str = "adam"
    moment_dtype: str = "float32"
    learning_rate: float = 2e-5
    adam_b1: float = 0.9
    warm_up: int = 2_000
    lr_schedule: str = "warmup"
    inverse_time_decay_steps: int = 10_000
    adam_eps: float = 1e-7
    momentum: float = 0.5
    nesterov: bool = True
    weight_decay: float = 0.0
    ema_decay: float = 0.0
    grad_clip_norm: float = 0.0
    grad_accum: int = 1

    # ------------------------------------------------------------- precision
    compute_dtype: str = "float32"  # float32 | bfloat16 | float16
    loss_scale: float = 0.0
    dynamic_loss_scale: bool = False
    loss_scale_growth_interval: int = 2000

    zero1: bool = False

    # -------------------------------------------------------------- training
    batch_size: int = 1
    steps_per_epoch: int = 1000
    epochs: int = 1000
    seed: int = 0

    # ------------------------------------------------------------- GAN mode
    gan_loss: str = "nonsaturating"
    adversarial_weight: float = 1.0
    cycle_weight: float = 10.0
    identity_weight: float = 0.5
    reconstruction_weight: float = 0.0
    d_learning_rate: float = 0.0
    d_pixel_size: int = 0
    d_octaves: int = 0
    patch_discriminator: bool = True
    d_norm: str = "none"
    g_norm: str = "none"
    r1_weight: float = 0.0
    diffaug: str = ""
    cycle_weight_final: float = -1.0
    identity_weight_final: float = -1.0
    loss_anneal_steps: int = 0
    generator: str = "unet"  # unet | resnet
    resnet_blocks: int = 9
    d_layout: str = "strided"  # strided | patchgan70
    image_pool: int = 0

    # ----------------------------------------------------------- performance
    concat_elision: bool = True
    fused_diffusion: bool = True
    remat: bool = False
    donate_state: bool = True
    host_sync_every: int = 64

    # ------------------------------------------------------------- parallelism
    mesh_data: int = 0
    mesh_model: int = 1
    mesh_slice: int = 1
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    pipeline_cuts: str = ""

    # -------------------------------------------------------------------- io
    log_dir: str = "logs"
    checkpoint_dir: Optional[str] = "checkpoints"
    checkpoint_every: int = 1000
    checkpoint_keep: int = 0
    checkpoint_async: bool = False
    keep_best: bool = False
    log_images_every: int = 1
    fid_samples: int = 0
    fid_extractor: str = "auto"
    serve_max_queue: int = 512
    serve_batch_wait_ms: float = 10.0
    serve_max_streams: int = 4

    # ------------------------------------------------------------ derived ---
    def class_patterns(self) -> Tuple[str, ...]:
        return self.classes if self.classes else (self.dataset_pattern,)

    def octave_filters(self, i: int) -> int:
        """Channel width at octave i (reference train.py:181)."""
        return min(self.pixel_size * 2**i, self.max_size)

    def octave_up_filters(self, i: int) -> int:
        """UpShuffle output width at octave i (reference train.py:188)."""
        return min(self.pixel_size * 2**i // 2, self.max_size)

    def middle_filters(self) -> int:
        return min(self.pixel_size * 2**self.octaves, self.max_size)

    def out_channels(self) -> int:
        return 3 * self.steps if self.per_step_output else 3

    @property
    def cycle_term_active(self) -> bool:
        """Whether the cycle term is computed at all: nonzero now, or
        annealing toward a nonzero final (gates two generator forwards)."""
        return self.cycle_weight > 0 or (
            self.loss_anneal_steps > 0 and self.cycle_weight_final > 0
        )

    @property
    def identity_term_active(self) -> bool:
        return self.identity_weight > 0 or (
            self.loss_anneal_steps > 0 and self.identity_weight_final > 0
        )

    @property
    def published_cyclegan_parts(self) -> bool:
        """Whether the ResNet generator, the 70×70 PatchGAN or the image pool
        is asked for: these run on one card or over data parallelism only."""
        return self.generator != "unet" or self.d_layout != "strided" or self.image_pool > 0

    def refuse_published_cyclegan(self, parallelism: str) -> None:
        """Raise if ``published_cyclegan_parts`` under ``parallelism`` (tensor,
        spatial or pipeline), which lays out the U-Net and the strided
        discriminator only."""
        if self.published_cyclegan_parts:
            raise ValueError(
                f"the ResNet generator, the 70x70 PatchGAN and the image pool (here "
                f"generator={self.generator!r}, d_layout={self.d_layout!r}, "
                f"image_pool={self.image_pool}) run on one card or over data parallelism "
                f"(mesh_data) only, not under {parallelism} parallelism")

    def validate(self) -> "Config":
        """The JAX package's checks, and those of the port's own fields."""
        if self.size % (2**self.octaves) != 0:
            raise ValueError(
                f"size={self.size} not divisible by 2**octaves={2**self.octaves}"
            )
        if self.skip_mode not in ("concat", "residual", "none"):
            raise ValueError(f"unknown skip_mode {self.skip_mode!r}")
        if self.parameterization not in ("x", "epsilon", "scaled_epsilon", "ode"):
            raise ValueError(f"unknown parameterization {self.parameterization!r}")
        if self.schedule not in (
            "quadratic", "exponential", "rational_exponential", "geometric",
            "cosine2", "quartic",
        ):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.loss not in ("mse", "l1", "dct", "mse_multiscale"):
            raise ValueError(f"unknown loss {self.loss!r}")
        for knob in (self.d_norm, self.g_norm):
            if knob not in ("none", "instance", "batch"):
                raise ValueError(f"unknown norm {knob!r}")
        for aug in filter(None, self.diffaug.split(",")):
            if aug not in ("color", "translation", "cutout"):
                raise ValueError(
                    f"unknown diffaug policy {aug!r} "
                    "(comma list from color,translation,cutout)"
                )
        if self.generator not in ("unet", "resnet"):
            raise ValueError(f"unknown generator {self.generator!r}")
        if self.d_layout not in ("strided", "patchgan70"):
            raise ValueError(f"unknown d_layout {self.d_layout!r}")
        if self.generator == "resnet" and self.g_norm != "instance":
            raise ValueError("generator='resnet' takes g_norm='instance' (the published one)")
        if self.d_layout == "patchgan70":
            if self.d_norm != "instance" or not self.patch_discriminator:
                raise ValueError("d_layout='patchgan70' takes d_norm='instance' and "
                                 "patch_discriminator (the published one)")
            n = 2 ** (self.d_octaves or self.octaves)
            if self.size % n or self.size < 3 * n:
                raise ValueError(f"d_layout='patchgan70' needs size divisible by {n} and at "
                                 f"least {3 * n} (a 1x1 patch map), got {self.size}")
        if self.generator == "resnet" and self.remat:
            raise ValueError("remat recomputes the U-Net's octaves; generator='resnet' has none")
        if self.resnet_blocks < 0 or self.image_pool < 0:
            raise ValueError(f"resnet_blocks and image_pool must be >= 0, got "
                             f"{self.resnet_blocks}, {self.image_pool}")
        if not 0.0 <= self.adam_b1 < 1.0:
            raise ValueError(f"adam_b1 must be in [0, 1), got {self.adam_b1}")
        if self.mesh_model > 1:
            self.refuse_published_cyclegan("tensor")
        if self.pipeline_stages > 1:
            self.refuse_published_cyclegan("pipeline")
        if self.r1_weight < 0:
            raise ValueError(f"r1_weight must be >= 0, got {self.r1_weight}")
        if self.loss_anneal_steps < 0:
            raise ValueError(
                f"loss_anneal_steps must be >= 0, got {self.loss_anneal_steps}"
            )
        for name, final in (
            ("cycle_weight_final", self.cycle_weight_final),
            ("identity_weight_final", self.identity_weight_final),
        ):
            if final < 0 and final != -1.0:
                raise ValueError(
                    f"{name} must be -1 (no anneal) or >= 0, got {final}"
                )
            if final >= 0 and self.loss_anneal_steps == 0:
                raise ValueError(
                    f"{name}={final} needs loss_anneal_steps > 0 "
                    "(the ramp length)"
                )
        if self.serve_batch_wait_ms < 0:
            raise ValueError(
                f"serve_batch_wait_ms must be >= 0, got {self.serve_batch_wait_ms}"
            )
        if self.serve_max_queue < 0:
            raise ValueError(
                f"serve_max_queue must be >= 0 (0 = unbounded), "
                f"got {self.serve_max_queue}"
            )
        if self.data_hbm < 0 or (self.data_hbm and self.data_hbm < self.size):
            raise ValueError(
                f"data_hbm must be 0 (off) or >= size={self.size}, "
                f"got {self.data_hbm}"
            )
        if self.host_sync_every < 0:
            raise ValueError(
                f"host_sync_every must be >= 0, got {self.host_sync_every}"
            )
        if self.fid_extractor not in ("auto", "trained", "random") and not (
            self.fid_extractor.startswith("inception:")
            or self.fid_extractor.startswith("inception-tv:")
        ):
            raise ValueError(f"unknown fid_extractor {self.fid_extractor!r}")
        if self.moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown moment_dtype {self.moment_dtype!r}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if not 1 <= self.sample_stride <= self.steps:
            raise ValueError(
                f"sample_stride must be in [1, steps], got {self.sample_stride}"
            )
        if self.grad_accum > 1 and self.zero1:
            raise ValueError("grad_accum > 1 is not supported with zero1")
        if self.grad_accum > 1 and self.dynamic_loss_scale:
            raise ValueError(
                "grad_accum > 1 is not supported with dynamic_loss_scale"
            )
        if self.pipeline_stages < 1:
            raise ValueError(
                f"pipeline_stages must be >= 1, got {self.pipeline_stages}"
            )
        if self.pipeline_microbatches < 0:
            raise ValueError(
                f"pipeline_microbatches must be >= 0, got {self.pipeline_microbatches}"
            )
        if self.pipeline_cuts:
            try:
                cuts = [int(c) for c in self.pipeline_cuts.split(",")]
            except ValueError:
                raise ValueError(
                    f"pipeline_cuts must be comma-separated ints, got "
                    f"{self.pipeline_cuts!r}"
                ) from None
            if cuts != sorted(set(cuts)) or not all(
                0 < c < self.octaves for c in cuts
            ):
                raise ValueError(
                    f"pipeline_cuts must be strictly increasing octave "
                    f"positions in (0, {self.octaves}), got {cuts}"
                )
            if self.pipeline_stages > 1 and len(cuts) != self.pipeline_stages - 1:
                raise ValueError(
                    f"pipeline_cuts needs pipeline_stages-1="
                    f"{self.pipeline_stages - 1} cuts, got {len(cuts)}"
                )
        if self.pipeline_stages > 1 and self.pipeline_stages > self.octaves:
            raise ValueError(
                f"pipeline_stages={self.pipeline_stages} cannot exceed "
                f"octaves={self.octaves} (stages own octave bands)"
            )
        return self

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        for name in _PORT_ONLY:
            if raw[name] == _DEFAULTS[name]:
                del raw[name]
        return json.dumps(raw, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        raw = {k: v for k, v in raw.items() if k in _FIELD_NAMES}
        if isinstance(raw.get("classes"), list):
            raw["classes"] = tuple(raw["classes"])
        return cls(**raw).validate()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(Config)}
_PORT_ONLY = ("adam_b1", "generator", "resnet_blocks", "d_layout", "image_pool")


def tiny_test_config(**overrides) -> Config:
    """A minimal config for fast CPU tests (BASELINE.json config-1 scale)."""
    base = dict(
        size=16,
        pixel_size=4,
        max_size=8,
        octaves=2,
        steps=10,
        batch_size=2,
        warm_up=2,
        test_step=2,
        steps_per_epoch=2,
        epochs=1,
        fused_diffusion=False,
        compute_dtype="float32",
    )
    base.update(overrides)
    return Config(**base).validate()
