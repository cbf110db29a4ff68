"""Runner of multi-class conditional transfer (BASELINE config 5) —
counterpart of gan_class_transfer2_tpu/train/conditional_gan_loop.py.

One dataset per entry of ``Config.classes``; ``data/pipeline.LabeledDataset``
labels the batches by class index round-robin, and the StarGAN-style step
(``train/conditional_gan.py``, B3 and B4 on the card) draws the target
classes. Each class keeps ``fid_samples`` held-out files out of training;
``log_sample`` writes ``transfer_to_<k>`` for a fixed batch and every
target class and, with ``fid_samples > 0``, the transfer FID/KID of every
ordered class pair (``transfer_scores``), whose mean keeps the best
checkpoint. Checkpoint/resume through ``ResilientRunnerMixin``; the step's
``torch.Generator`` is carried in each checkpoint. Over processes
(``parallel/``) as the diffusion ``Runner``: the mesh's state and step,
the transfers split over the ranks and gathered, the coordinator alone
writing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data import pipeline
from ..models.api import resolve_device
from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from ..utils import checkpoint as ckpt_lib
from ..utils import tensorboard as tb
from . import conditional_gan as cgan
from .loop import step_seed
from .resilience import ResilientRunnerMixin


class ConditionalGANRunner(ResilientRunnerMixin):
    def __init__(self, cfg: Config, datasets=None, log_dir=None, eval_sets=None,
                 device="cuda"):
        """``eval_sets``: optional per-class held-out image arrays for the
        FID metric (with ``datasets`` passed in); built from
        ``cfg.classes``, ``cfg.fid_samples`` files per class are reserved
        and never reach training."""
        cfg.validate()
        # the class count comes from the datasets when given, else the patterns
        n_sources = len(datasets) if datasets is not None else len(cfg.class_patterns())
        if cfg.num_classes == 0:
            cfg = cfg.replace(num_classes=n_sources)
        if cfg.num_classes != n_sources:
            raise ValueError(f"num_classes={cfg.num_classes} but {n_sources} class data "
                             "sources were provided (labels would gather out of range)")
        if cfg.num_classes < 2:
            raise ValueError("conditional transfer needs >= 2 classes")
        self.cfg = cfg
        self.mesh = mesh_lib.make_mesh(cfg, device=resolve_device(device))
        self.device = self.mesh.device
        self.generator = torch.Generator(device=self.device).manual_seed(step_seed(cfg.seed, 31))
        self.state, self.shardings = mesh_lib.init_sharded_conditional_gan_state(cfg, self.mesh)
        if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None:
            self._restore_checkpoint()
        self.train_step = mesh_lib.make_parallel_conditional_gan_train_step(cfg, self.mesh)
        self._transfer_fn = cgan.make_transfer_fn(cfg, self.mesh)

        self._eval_sets = list(eval_sets) if eval_sets is not None else None
        self._eval_files = None
        if datasets is None:
            files, self._eval_files = [], []
            for i, p in enumerate(cfg.class_patterns()):
                tr, ev = pipeline.held_out_split(p, cfg.fid_samples, seed=cfg.seed + i)
                files.append(tr)
                self._eval_files.append(ev)
            datasets = pipeline.make_datasets(cfg, files_per_class=files, device=self.device)
        self.labeled = pipeline.LabeledDataset(datasets)
        self._restore_data_state()
        self.data_iter = pipeline.DeviceIterator(self.labeled, self.device)

        self.log_dir = log_dir or tb.reference_log_dir(cfg.log_dir)
        self.writer = (tb.SummaryWriter(self.log_dir) if multihost.is_coordinator()
                       else tb.NullWriter())
        self._fixed = None
        self._eval_feat_cache = {}

    def _data_sources(self) -> dict:
        return {"labeled": self.labeled}

    def _data_iterators(self) -> dict:
        return {"labeled": self.data_iter}

    def _class_eval_sets(self):
        """The per-class held-out images (decoded once, fixed crop stream,
        no flip; None for a class without any), or None without eval data."""
        if self._eval_sets is None and self._eval_files is not None and self.cfg.fid_samples > 0:
            self._eval_sets = [pipeline.decode_eval_set(ev, self.cfg.size, seed=0) if ev
                               else None for ev in self._eval_files]
        return self._eval_sets

    def log_sample(self, epoch: int):
        """The transfer of one fixed batch (drawn from the training stream at
        the first call, as in JAX) to every class, with the EMA generator
        when kept; with ``fid_samples > 0`` the transfer FID/KID of every
        ordered class pair."""
        if self._fixed is None:  # every rank's rows (a collective on every rank)
            self._fixed = multihost.host_fetch(
                mesh_lib.share_batch(next(self.data_iter)["image"], self.mesh),
                mesh_lib.batch_sharding(self.mesh).spec).to(self.device)
        for target in range(self.cfg.num_classes):
            out = self._transfer(self._fixed, target)
            self.writer.image(f"transfer_to_{target}", out.float().cpu().numpy() * 0.5 + 0.5,
                              epoch, 10)
        if self.cfg.fid_samples > 0 and self._class_eval_sets():
            fids = []
            for src in range(self.cfg.num_classes):
                for tgt in range(self.cfg.num_classes):
                    if src == tgt:
                        continue
                    scores = self.transfer_scores(src, tgt)
                    if scores is None:
                        continue
                    self.writer.scalar(f"transfer_fid_{src}_to_{tgt}", scores["fid"], epoch)
                    self.writer.scalar(f"transfer_kid_{src}_to_{tgt}", scores["kid"], epoch)
                    fids.append(scores["fid"])
            if fids:
                # the mean over the class-pair grid: per-pair FIDs oscillate
                # out of phase late in training
                self._maybe_keep_best(sum(fids) / len(fids), epoch, "transfer_fid_mean")

    def transfer_fid(self, src: int, tgt: int):
        """FID of held-out class-``src`` images transferred to ``tgt``
        against the held-out ``tgt`` set (None without eval sets)."""
        scores = self.transfer_scores(src, tgt)
        return None if scores is None else scores["fid"]

    def transfer_scores(self, src: int, tgt: int):
        """{"fid", "kid"} of one (src → tgt) transfer of the held-out sets,
        or None when an eval set is missing or has < 2 images. The target
        set's features are extracted once."""
        from ..utils import metrics

        sets = self._class_eval_sets()
        if not sets:
            return None
        src_imgs, tgt_imgs = sets[src], sets[tgt]
        if src_imgs is None or tgt_imgs is None or len(src_imgs) < 2 or len(tgt_imgs) < 2:
            return None
        fake = self._transfer(src_imgs, tgt)
        x = metrics.get_extractor(self.cfg.fid_extractor)
        if tgt not in self._eval_feat_cache:
            self._eval_feat_cache[tgt] = metrics.extract_features(
                np.asarray(tgt_imgs), extractor=x, device=self.device)
        return metrics.fid_and_kid(fake, np.asarray(tgt_imgs), extractor=x,
                                   features_b=self._eval_feat_cache[tgt], device=self.device)

    def _transfer(self, images, target: int):
        """The transfer with the runner's (EMA-preferring) generator."""
        images = torch.as_tensor(images).to(self.device)
        tvec = torch.full((images.shape[0],), target, dtype=torch.int32, device=self.device)
        return self._transfer_fn(cgan.select_generator(self.state), images, tvec)

    def fit(self, epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None,
            log_samples: bool = True):
        """``epochs=None`` finishes the configured budget; ``epochs=k`` trains k more."""
        cfg = self.cfg
        budget = epochs is None
        epochs = cfg.epochs if epochs is None else epochs
        steps_per_epoch = cfg.steps_per_epoch if steps_per_epoch is None else steps_per_epoch
        start_epoch, origin = self._epoch_plan(epochs, steps_per_epoch, budget)
        return self._fit_interruptible(self._fit_epochs, epochs, steps_per_epoch, log_samples,
                                       start_epoch, origin)

    def _fit_epochs(self, epochs, steps_per_epoch, log_samples, start_epoch=0, origin=None):
        return self._run_epochs(
            epochs=epochs, steps_per_epoch=steps_per_epoch, log_samples=log_samples,
            start_epoch=start_epoch, origin=origin,
            next_batch=lambda: (next(self.data_iter),),
            step_fn=lambda state, batch, generator: self.train_step(state, batch, generator),
            summarize=lambda epoch, vals, ips: print(
                f"epoch {epoch}: g={vals['g_loss']:.4f} d={vals['d_loss']:.4f} "
                f"cycle={vals['cycle']:.4f} {ips:.1f} img/s", flush=True))

    def close(self):
        self._close_checkpoints()
        self.writer.close()
        self.labeled.close()
