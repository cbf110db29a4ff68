"""Runner of the diffusion model — counterpart of
gan_class_transfer2_tpu/train/loop.py (the reference's ``__main__``,
train.py:498-523): build the writer, train epochs with the per-epoch
sampling callback, and checkpoint/resume.

What differs from the JAX package, and why:

  * One card (``device``, the card unless the caller asks for the CPU), no
    mesh: the state comes from ``trainer.init_state`` and the step is
    ``trainer.make_train_step``.
  * Randomness is one ``torch.Generator`` on the device, seeded from
    ``cfg.seed`` (through ``step_seed``, so it does not repeat the init's
    draws) and carried in each checkpoint: JAX folds the step number into
    a fixed key, the port's generator advances with each draw, so a
    resumed run draws what an unbroken run draws only with its state
    restored.
  * FID/KID (``fid_samples > 0``, ``quality_scores``): the sample batch's
    initial noise is drawn from that same generator, and the held-out
    reference set and its features are computed once, as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..data import pipeline
from ..models.api import resolve_device
from ..sample import sampler
from ..utils import checkpoint as ckpt_lib
from ..utils import tensorboard as tb
from . import trainer
from .resilience import ResilientRunnerMixin


def step_seed(seed: int, purpose: int) -> int:
    """The seed of a run's step generator, derived from ``cfg.seed`` and a
    purpose tag (17 for the diffusion step and 23 for the GAN step, the
    JAX runners' ``fold_in`` constants), apart from the init's draws."""
    return int(np.random.default_rng((seed, purpose)).integers(0, 2**63))


class Runner(ResilientRunnerMixin):
    """Owns the state, the generator, the data, the writer and the epoch loop."""

    def __init__(self, cfg: Config, dataset=None, log_dir: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(step_seed(cfg.seed, 17))
        self.state = trainer.init_state(cfg, device=self.device)
        if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None:
            self._restore_checkpoint()
        self.train_step = trainer.make_train_step(cfg)
        self.eval_fn = sampler.make_eval_fn(cfg)
        self._ema_model = None

        # held-out eval split (FID hygiene, as in JAX): with FID on and the
        # datasets built here, fid_samples files per class are reserved for
        # the metric and never reach training; only class 0's are the
        # reference set (the sampler draws class 0)
        self._eval_files = None
        self._fid_reference = None
        self._ref_features = None
        if dataset is None:
            files_per_class = None
            if cfg.fid_samples > 0:
                try:
                    splits = [pipeline.held_out_split(p, cfg.fid_samples, seed=cfg.seed + i)
                              for i, p in enumerate(cfg.class_patterns())]
                except FileNotFoundError:
                    splits = None  # make_datasets raises with the pattern
                if splits is not None:
                    files_per_class = [tr for tr, _ in splits]
                    self._eval_files = list(splits[0][1])
            dataset = pipeline.make_datasets(cfg, files_per_class=files_per_class,
                                             device=self.device)[0]
        self.dataset = dataset
        self._restore_data_state()
        self.data_iter = pipeline.DeviceIterator(self.dataset, self.device)

        self.log_dir = log_dir or tb.reference_log_dir(cfg.log_dir)
        self.writer = tb.SummaryWriter(self.log_dir)
        with open(os.path.join(self.log_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())

        # eval fixtures (reference train.py:305-311), the JAX Runner's draws
        fr = np.random.default_rng(cfg.seed + 1)

        def on_device(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

        self.noise_bank = on_device(fr.normal(size=(2, cfg.size, cfg.size, 3)))
        self.dictionary = on_device(
            fr.normal(size=(cfg.size, cfg.size, 2**cfg.bits_per_pixel, 3)))
        if cfg.example_image_path:
            # through the training crop and flip on purpose, as the reference
            # decodes its eval fixture (train.py:305)
            img = pipeline.decode_image(cfg.example_image_path, cfg.size,
                                        np.random.default_rng(0), crop=True)
            self.example_image = on_device(img)[None]
        else:
            self.example_image = on_device(fr.uniform(-1, 1, (1, cfg.size, cfg.size, 3)))

    # ------------------------------------------------------------------ eval
    def log_sample(self, epoch: int):
        """Per-epoch eval with the EMA params when kept: preview, inversion,
        edits and sampling, logged under the reference's TensorBoard tags
        (train.py:323-496)."""
        self._ema_model = trainer.eval_model(self.state, self._ema_model)
        out = self.eval_fn(self._ema_model, self.example_image, self.noise_bank,
                           self.dictionary)
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        self.writer.image("denoised", out["denoised"] * 0.5 + 0.5, epoch)
        self.writer.scalar("example loss", float(out["example_loss"]), epoch)
        for tag in ("step_1", "step_0.25", "step_0.5", "step_0.75"):
            self.writer.image(tag, out[tag] * 0.5 + 0.5, epoch, max_outputs=10)
        self.writer.image("fake", out["fake"] * 0.5 + 0.5, epoch, max_outputs=10)
        if self.cfg.fid_samples > 0:
            scores = self.quality_scores(self._ema_model)
            if scores is not None:  # degenerate eval set: metric skipped
                self.writer.scalar("fid", scores["fid"], epoch)
                self.writer.scalar("kid", scores["kid"], epoch)
                self._maybe_keep_best(scores["fid"], epoch, "fid")

    def compute_fid(self, model=None):
        """FID of fresh reverse-diffusion samples against the held-out set;
        None when the eval set is degenerate (see quality_scores)."""
        scores = self.quality_scores(model)
        return None if scores is None else scores["fid"]

    def quality_scores(self, model=None, init=None):
        """{"fid", "kid"} of one fresh batch of ``fid_samples`` samples
        against the held-out set, or None when either set has < 2 images.
        ``model``: the denoiser (default: the EMA when kept); ``init``: the
        sampler's initial noise (default: drawn from the runner's
        generator)."""
        from ..utils import metrics

        cfg = self.cfg
        n = cfg.fid_samples
        if model is None:
            model = self._ema_model = trainer.eval_model(self.state, self._ema_model)
        ref = self._fid_reference_set(n)
        if n < 2 or len(ref) < 2:
            print(f"quality_scores skipped: need >= 2 samples and reference "
                  f"images (fid_samples={n}, reference={len(ref)})")
            return None
        if init is None:
            init = torch.randn((n, cfg.size, cfg.size, 3), generator=self.generator,
                               device=self.device)
        samples = self._metric_sample(model, init)
        x = metrics.get_extractor(cfg.fid_extractor)
        if self._ref_features is None:
            # the reference set is fixed: its features are extracted once
            self._ref_features = metrics.extract_features(ref, extractor=x, device=self.device)
        return metrics.fid_and_kid(samples, ref, extractor=x, features_b=self._ref_features,
                                   device=self.device)

    def _metric_sample(self, model, init):
        """The sampler's batch for FID/KID: ``len(sample_timesteps(cfg))``
        denoiser calls on ``init``, on the runner's device."""
        return sampler.sample(self.cfg, model, torch.as_tensor(init).to(self.device),
                              snapshots=False).images

    def _fid_reference_set(self, n: int) -> np.ndarray:
        """The fixed comparison set: the held-out files reserved at
        construction (decoded with a fixed crop stream, no flip), or, for
        a dataset passed in, a set drawn once from the training stream."""
        if self._fid_reference is not None:
            return self._fid_reference
        if self._eval_files:
            out = pipeline.decode_eval_set(self._eval_files[:n], self.cfg.size, seed=0)
        else:
            data = []
            while sum(len(d) for d in data) < n:
                data.append(torch.as_tensor(next(self.data_iter)).float().cpu().numpy())
            out = np.concatenate(data, 0)[:n]
        self._fid_reference = out
        return out

    # ----------------------------------------------------------------- train
    def fit(self, epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None,
            on_epoch_begin: Optional[Callable[[int], None]] = None, log_samples: bool = True):
        """``epochs=None`` finishes the configured budget (after a restore,
        completed steps count against it); ``epochs=k`` trains k more."""
        cfg = self.cfg
        budget = epochs is None
        epochs = cfg.epochs if epochs is None else epochs
        steps_per_epoch = cfg.steps_per_epoch if steps_per_epoch is None else steps_per_epoch
        start_epoch, origin = self._epoch_plan(epochs, steps_per_epoch, budget)
        return self._fit_interruptible(self._fit_epochs, epochs, steps_per_epoch,
                                       on_epoch_begin, log_samples, start_epoch, origin)

    def _fit_epochs(self, epochs, steps_per_epoch, on_epoch_begin, log_samples,
                    start_epoch=0, origin=None):
        def step_fn(state, batch, generator):
            state, loss = self.train_step(state, batch, generator)
            return state, {"loss": loss}

        return self._run_epochs(
            epochs=epochs, steps_per_epoch=steps_per_epoch, log_samples=log_samples,
            start_epoch=start_epoch, origin=origin,
            next_batch=lambda: (next(self.data_iter),), step_fn=step_fn,
            summarize=lambda epoch, vals, ips: print(
                f"epoch {epoch}: loss={vals['loss']:.5f} {ips:.1f} images/s", flush=True),
            on_epoch_begin=on_epoch_begin)

    def _data_sources(self) -> dict:
        return {"dataset": self.dataset}

    def _data_iterators(self) -> dict:
        return {"dataset": self.data_iter}

    def close(self):
        self._close_checkpoints()
        self.writer.close()
        if hasattr(self.dataset, "close"):
            self.dataset.close()
