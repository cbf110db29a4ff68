"""GAN-mode runner — counterpart of gan_class_transfer2_tpu/train/gan_loop.py:
two class datasets (A, B), cycle-transfer training through ``train/gan.py``
(B3 and B4 on the card), TensorBoard images of the transfers, and
checkpoint/resume through the same ``ResilientRunnerMixin`` as the
diffusion ``Runner``.

``Config.classes`` names exactly two glob patterns. Each class keeps
``fid_samples`` held-out files out of training, as in JAX; with
``fid_samples > 0`` each ``log_sample`` scores the transfer of one class's
held-out images against the other's (``transfer_scores``: FID and KID, B3
and B4 in the generator on the card). The transfer draws no noise. The
step's ``torch.Generator`` is carried in each checkpoint. Over processes
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
from . import gan
from .loop import step_seed
from .resilience import ResilientRunnerMixin


class GANRunner(ResilientRunnerMixin):
    def __init__(self, cfg: Config, dataset_a=None, dataset_b=None, log_dir=None,
                 device="cuda"):
        cfg.validate()
        if dataset_a is None or dataset_b is None:
            patterns = cfg.class_patterns()
            if len(patterns) != 2:
                raise ValueError("GAN class transfer needs exactly 2 class patterns "
                                 f"(got {len(patterns)}); set Config.classes")
        self.cfg = cfg
        self.mesh = mesh_lib.make_mesh(cfg, device=resolve_device(device))
        self.device = self.mesh.device
        self.generator = torch.Generator(device=self.device).manual_seed(step_seed(cfg.seed, 23))
        self.state, self.shardings = mesh_lib.init_sharded_gan_state(cfg, self.mesh)
        if cfg.checkpoint_dir and ckpt_lib.latest_step(cfg.checkpoint_dir) is not None:
            self._restore_checkpoint()
        self.train_step = mesh_lib.make_parallel_gan_train_step(cfg, self.mesh)
        self._transfer_fn = gan.make_transfer_fn(cfg, self.mesh)

        # held-out eval split: fid_samples files per class never reach training
        self._eval_files = {"a": None, "b": None}
        if dataset_a is None or dataset_b is None:
            files, eval_files = [], []
            for i, p in enumerate(cfg.class_patterns()):
                tr, ev = pipeline.held_out_split(p, cfg.fid_samples, seed=cfg.seed + i)
                files.append(tr)
                eval_files.append(ev)
            built = pipeline.make_datasets(cfg, files_per_class=files, device=self.device)
            dataset_a = dataset_a if dataset_a is not None else built[0]
            dataset_b = dataset_b if dataset_b is not None else built[1]
            self._eval_files = {"a": eval_files[0], "b": eval_files[1]}
        self.dataset_a = dataset_a
        self.dataset_b = dataset_b
        self._restore_data_state()
        self.iter_a = pipeline.DeviceIterator(self.dataset_a, self.device)
        self.iter_b = pipeline.DeviceIterator(self.dataset_b, self.device)

        self.log_dir = log_dir or tb.reference_log_dir(cfg.log_dir)
        self.writer = (tb.SummaryWriter(self.log_dir) if multihost.is_coordinator()
                       else tb.NullWriter())
        self._fixed_a = None
        self._fixed_b = None
        self._eval_cache = {}
        self._eval_feat_cache = {}

    def _data_sources(self) -> dict:
        return {"a": self.dataset_a, "b": self.dataset_b}

    def _data_iterators(self) -> dict:
        return {"a": self.iter_a, "b": self.iter_b}

    def log_sample(self, epoch: int):
        """The transfers of one fixed batch per class (drawn from the
        training streams at the first call, as in JAX) with the EMA
        generators when kept: A→B, B→A and A→B→A."""
        if self._fixed_a is None:  # every rank's rows (a collective on every rank)
            spec = mesh_lib.batch_sharding(self.mesh).spec
            a, b = (mesh_lib.share_batch(next(it), self.mesh) for it in (self.iter_a, self.iter_b))
            self._fixed_a = multihost.host_fetch(a, spec).to(self.device)
            self._fixed_b = multihost.host_fetch(b, spec).to(self.device)
        fake_b = self._transfer(self._fixed_a, "ab")
        fake_a = self._transfer(self._fixed_b, "ba")
        cycled = self._transfer(fake_b, "ba")
        for tag, images in (("transfer_ab", fake_b), ("transfer_ba", fake_a),
                            ("cycle_aba", cycled)):
            self.writer.image(tag, images.float().cpu().numpy() * 0.5 + 0.5, epoch, 10)
        if self.cfg.fid_samples > 0:
            fids = []
            for d in ("ab", "ba"):
                scores = self.transfer_scores(d)
                if scores is None:  # degenerate eval set: metric skipped
                    continue
                self.writer.scalar(f"transfer_fid_{d}", scores["fid"], epoch)
                self.writer.scalar(f"transfer_kid_{d}", scores["kid"], epoch)
                fids.append(scores["fid"])
            if fids:
                # per-direction FID oscillates late in cycle-GAN training:
                # keep_best tracks the mean over directions
                self._maybe_keep_best(sum(fids) / len(fids), epoch, "transfer_fid_mean")

    def _eval_set(self, cls: str) -> np.ndarray:
        """The fixed per-class eval images, disjoint from training: the
        held-out files reserved at construction (fixed crop stream, no
        flip), or, for datasets passed in, a set drawn once from a fresh
        iterator of the class's dataset."""
        if cls in self._eval_cache:
            return self._eval_cache[cls]
        files = self._eval_files[cls]
        n = max(self.cfg.fid_samples, self.cfg.batch_size)
        if files:
            out = pipeline.decode_eval_set(files, self.cfg.size, seed=0)
        else:
            it = iter(self.dataset_a if cls == "a" else self.dataset_b)
            chunks = []
            while sum(len(x) for x in chunks) < n:
                chunks.append(multihost.host_fetch(
                    torch.as_tensor(next(it)).float(),
                    mesh_lib.batch_sharding(self.mesh).spec).numpy())
            out = np.concatenate(chunks, 0)[:n]
        self._eval_cache[cls] = out
        return out

    def transfer_fid(self, direction: str = "ab"):
        """FID of the transferred held-out images against the target class's
        held-out set; None when an eval set is degenerate."""
        scores = self.transfer_scores(direction)
        return None if scores is None else scores["fid"]

    def transfer_scores(self, direction: str = "ab"):
        """{"fid", "kid"} of one transferred held-out batch against the
        target class's held-out set; None when either set has < 2 images."""
        from ..utils import metrics

        src = self._eval_set("a" if direction == "ab" else "b")
        tgt_cls = "b" if direction == "ab" else "a"
        tgt = self._eval_set(tgt_cls)
        if len(src) < 2 or len(tgt) < 2:
            print(f"transfer_scores({direction}) skipped: need >= 2 images "
                  f"per eval set (src={len(src)}, tgt={len(tgt)})")
            return None
        fake = self._transfer(src, direction)
        x = metrics.get_extractor(self.cfg.fid_extractor)
        feats = self._eval_features(tgt_cls, tgt, x)
        return metrics.fid_and_kid(fake, tgt, extractor=x, features_b=feats, device=self.device)

    def _eval_features(self, cls: str, images, extractor):
        """The extractor's features of a class's fixed eval set, computed once."""
        from ..utils import metrics

        if cls not in self._eval_feat_cache:
            self._eval_feat_cache[cls] = metrics.extract_features(images, extractor=extractor,
                                                                  device=self.device)
        return self._eval_feat_cache[cls]

    def _transfer(self, images, direction: str):
        """The transfer with the runner's (EMA-preferring) generator."""
        return self._transfer_fn(gan.select_generator(self.state, direction),
                                 torch.as_tensor(images).to(self.device))

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
            next_batch=lambda: (next(self.iter_a), next(self.iter_b)),
            step_fn=lambda state, a, b, generator: self.train_step(state, a, b, generator),
            summarize=lambda epoch, vals, ips: print(
                f"epoch {epoch}: g={vals['g_loss']:.4f} d={vals['d_loss']:.4f} "
                f"cycle={vals['cycle']:.4f} {ips:.1f} img/s", flush=True))

    def close(self):
        self._close_checkpoints()
        self.writer.close()
        for ds in (self.dataset_a, self.dataset_b):
            if hasattr(ds, "close"):
                ds.close()
