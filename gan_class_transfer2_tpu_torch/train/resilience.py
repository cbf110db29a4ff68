"""Failure recovery shared by the runners — counterpart of
gan_class_transfer2_tpu/train/resilience.py, on one card in one process.

Every runner (the diffusion ``Runner``, ``GANRunner``) mixes this in for:

  * ``fit_resilient`` — on a step failure, restore the last checkpoint and
    continue, up to ``max_restarts``;
  * Ctrl-C checkpointing — ``_fit_interruptible`` saves a final checkpoint
    on KeyboardInterrupt before re-raising;
  * data-stream persistence — each save carries the datasets' positions as
    consumed by training in a JSON sidecar, and a fresh runner restores
    them, so a restart does not replay the first samples of the run;
  * ``_run_epochs``, the epoch loop: the budget after a restore, the step
    loop with the metrics summed on the device (one host sync every
    ``host_sync_every`` steps, one read per metric per epoch), the
    checkpoint cadence and TensorBoard scalars at the global epoch.

Across processes (``parallel/multihost``), as the JAX module's pod
branches: every rank computes and restores; only the coordinator writes
the step, after every rank wrote its own data-position sidecar
(``step_<N>.extra.host<k>.json``); the gather of ZeRO-1 moments
(``host_complete`` with the runner's ``shardings``) is a collective, so it
runs on every rank before the coordinator gate; and a barrier after each
save (after the drain of the async saver, for ``checkpoint_async``) makes
the step durable before any rank goes on. The runner's ``torch.Generator``
(``self.generator``, alike on every rank) is saved and restored with the
state, so a resumed run draws what an unbroken one draws.
"""

from __future__ import annotations

import math
import time

import torch

from ..parallel import multihost
from ..utils import checkpoint as ckpt_lib


class ResilientRunnerMixin:
    """Requires ``self.cfg``, ``self.state``, ``self.generator``,
    ``self.writer``, ``self.fit(**kw)``, ``self.log_sample(epoch)`` and
    ``_data_sources()`` returning {name: dataset}."""

    def _data_sources(self) -> dict:
        return {}

    def _data_iterators(self) -> dict:
        """{name: DeviceIterator} with _data_sources' keys: their
        ``consumed_state`` excludes the prefetched batch."""
        return {}

    def _data_state_extra(self):
        iters = self._data_iterators()
        out = {}
        for name, d in self._data_sources().items():
            it = iters.get(name)
            state = it.consumed_state() if it is not None else None
            if state is None and hasattr(d, "state_dict"):
                state = d.state_dict()  # nothing consumed yet: pristine
            if state is not None:
                out[name] = state
        return {"data": out} if out else None

    def _checkpoint_now(self):
        """Save state, generator and the data-position sidecar; returns the
        step path (None on the ranks that do not write). The CPU snapshot
        is complete before an async save is queued: the next step updates
        the live tensors in place. Every rank calls this at the same step."""
        shardings = getattr(self, "shardings", None)
        snap = None
        if multihost.is_coordinator() or multihost.any_cross_process_sharded(shardings):
            snap = ckpt_lib.host_complete(self.state, self.generator, shardings)
        extra = self._data_state_extra()
        if multihost.process_count() > 1 and extra is not None:
            ckpt_lib.save_host_extra(self.cfg.checkpoint_dir, int(self.state.step), extra,
                                     host=multihost.process_index())
        path = None
        if self.cfg.checkpoint_async:
            if multihost.is_coordinator():
                if getattr(self, "_ckpt_saver", None) is None:
                    self._ckpt_saver = ckpt_lib.AsyncSaver()
                path = self._ckpt_saver.submit(self.cfg.checkpoint_dir, snap, self.cfg,
                                               extra=extra)
            return path
        if multihost.is_coordinator():
            path = ckpt_lib.save(self.cfg.checkpoint_dir, snap, self.cfg, extra=extra)
        multihost.barrier()
        return path

    def _maybe_keep_best(self, value, epoch: int, metric: str):
        """Config.keep_best: save the state under <checkpoint_dir>/best when
        the (lower-is-better) metric improves; the tracker survives restarts
        through best/best.json, whose record is trusted only when it was
        made under the same metric and feature extractor. Returns the saved
        path, or None."""
        cfg = self.cfg
        if not cfg.keep_best or not cfg.checkpoint_dir:
            return None
        if value is None or not math.isfinite(value):
            return None
        prev = getattr(self, "_best_metric", None)
        if prev is None:
            rec = ckpt_lib.read_best(cfg.checkpoint_dir)
            if rec is not None:
                # a record under another metric or extractor is incomparable
                # (repo-local FID 3.2 against Inception units near 280); one
                # without the extractor field is treated as matching
                cur = cfg.fid_extractor
                if rec.get("metric") == metric and rec.get("fid_extractor", cur) == cur:
                    prev = float(rec["value"])
                else:
                    print(f"keep_best: ignoring best.json recorded under metric="
                          f"{rec.get('metric')!r} extractor={rec.get('fid_extractor')!r} "
                          f"(this run: {metric!r}/{cur!r}) — values incomparable, tracker "
                          "restarts fresh")
        if prev is not None and value >= prev:
            self._best_metric = prev
            return None
        self._best_metric = float(value)
        # every rank reaches this with the same value (the eval is
        # replicated); the ZeRO-1 gather inside host_complete is a collective
        shardings = getattr(self, "shardings", None)
        snap = None
        if multihost.is_coordinator() or multihost.any_cross_process_sharded(shardings):
            snap = ckpt_lib.host_complete(self.state, shardings=shardings)
        path = None
        if multihost.is_coordinator():
            path = ckpt_lib.save_best(cfg.checkpoint_dir, snap, cfg, metric=metric,
                                      value=float(value), epoch=epoch)
            print(f"keep_best: {metric}={value:.4f} at step {int(self.state.step)} -> {path}")
        multihost.barrier()
        return path

    def _checkpoint_flush(self):
        """Drain pending async saves (a no-op without checkpoint_async), then
        wait for every rank: the checkpoint directory is consistent only
        after it. Every rank calls this at the same point."""
        saver = getattr(self, "_ckpt_saver", None)
        if saver is not None:
            saver.wait()
        if self.cfg.checkpoint_async:
            multihost.barrier()

    def _close_checkpoints(self):
        """Drain pending async saves and stop the saver's thread (close)."""
        saver = getattr(self, "_ckpt_saver", None)
        if saver is not None:
            saver.close()
            self._ckpt_saver = None

    def _restore_checkpoint(self):
        """Restore the latest checkpoint into the live state and generator;
        on the pipeline path, then placed on the stage devices again (its
        replicas refreshed), as JAX's runner and restart do
        (loop.py:55-62, resilience.py:366-372)."""
        self.state = ckpt_lib.restore(self.cfg.checkpoint_dir, self.state,
                                      generator=self.generator,
                                      shardings=getattr(self, "shardings", None))
        pipeline = getattr(self, "_pipeline", None)
        if pipeline is not None:
            self.state = pipeline.place_state(self.state)

    def _restore_data_state(self):
        """Apply the latest checkpoint's data-position sidecar to the
        datasets. Call after they are built and before a batch is drawn. A
        sidecar written under another input path (its own state format)
        is skipped with a printed line."""
        if not self.cfg.checkpoint_dir:
            return
        host = multihost.process_index() if multihost.process_count() > 1 else None
        extra = ckpt_lib.load_extra(self.cfg.checkpoint_dir, host=host)
        if not extra or "data" not in extra:
            return
        sources = self._data_sources()
        for name, state in extra["data"].items():
            d = sources.get(name)
            if d is not None and hasattr(d, "set_state"):
                try:
                    d.set_state(state)
                except (KeyError, TypeError, ValueError) as e:
                    print(f"data sidecar for {name!r} does not match {type(d).__name__} "
                          f"({type(e).__name__}: {e}); stream position not restored — did "
                          "the input path (data_hbm/cache) change since the checkpoint?")

    def _run_epochs(self, *, epochs, steps_per_epoch, log_samples, start_epoch, origin,
                    next_batch, step_fn, summarize, on_epoch_begin=None):
        """The epoch loop of every runner. ``next_batch() -> tuple`` gives
        the step's inputs between state and generator; ``step_fn(state,
        *args, generator) -> (state, {name: device scalar})``;
        ``summarize(epoch, vals, ips)`` prints the epoch's line."""
        cfg = self.cfg
        if origin is None:
            origin = int(self.state.step)
        for epoch in range(start_epoch, epochs):
            # TensorBoard index: the global epoch, so repeated explicit
            # fit(epochs=1) calls give a monotonic curve
            tb_epoch = origin // steps_per_epoch + epoch if steps_per_epoch > 0 else epoch
            if on_epoch_begin is not None:
                on_epoch_begin(epoch)
            if log_samples and cfg.log_images_every > 0 and epoch % cfg.log_images_every == 0:
                self.log_sample(tb_epoch)
            t0 = time.perf_counter()
            acc = None
            global_step = int(self.state.step)
            # a resumed partial epoch runs only to its step target
            n_steps = max(origin + (epoch + 1) * steps_per_epoch - global_step, 0)
            sync_every = cfg.host_sync_every
            for _ in range(n_steps):
                args = next_batch()
                self.state, metrics = step_fn(self.state, *args, self.generator)
                if acc is None:
                    acc = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                           for k, v in metrics.items()}
                    sync_key = next(iter(acc))
                acc = {k: acc[k] + metrics[k] for k in acc}
                global_step += 1
                if sync_every and global_step % sync_every == 0:
                    # bounded in-flight work: the host waits for the card
                    # every sync_every steps (each queued step pins a batch)
                    float(acc[sync_key])
                if (cfg.checkpoint_dir and cfg.checkpoint_every > 0
                        and global_step % cfg.checkpoint_every == 0):
                    self._checkpoint_now()
            if n_steps == 0:
                continue
            vals = {k: float(v) / n_steps for k, v in acc.items()}  # syncs
            ips = n_steps * cfg.batch_size / (time.perf_counter() - t0)
            for k, v in vals.items():
                self.writer.scalar(k, v, tb_epoch)
            self.writer.scalar("images_per_sec", ips, tb_epoch)
            summarize(epoch, vals, ips)
        self._checkpoint_flush()
        return self.state

    def _epoch_plan(self, epochs, steps_per_epoch, budget):
        """(start_epoch, origin). Budget mode (fit() without epochs)
        anchors at step 0, so a resumed run finishes the original budget,
        a partial first epoch included; explicit fit(epochs=k) anchors at
        the current step and runs k whole epochs."""
        step = int(self.state.step)
        if budget and steps_per_epoch > 0:
            return min(step // steps_per_epoch, epochs), 0
        return 0, step

    def _fit_interruptible(self, fit_body, *args, **kw):
        """Run an epoch loop; on Ctrl-C save a final checkpoint first."""
        try:
            return fit_body(*args, **kw)
        except KeyboardInterrupt:
            if self.cfg.checkpoint_dir:
                path = self._checkpoint_now()
                self._checkpoint_flush()
                print(f"interrupted — checkpoint saved to {path}", flush=True)
            raise

    def fit_resilient(self, max_restarts: int = 3, **fit_kw):
        """On an exception mid-fit, restore the last checkpoint (state and
        generator; in-process datasets keep their live position) and call
        ``fit`` again, up to ``max_restarts`` times. With no checkpoint to
        go back to the exception is re-raised: the failed step may have
        updated parameters in place already."""
        if not self.cfg.checkpoint_dir:
            raise ValueError("fit_resilient requires Config.checkpoint_dir")
        restarts = 0
        while True:
            try:
                return self.fit(**fit_kw)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — any step failure
                restarts += 1
                if restarts > max_restarts:
                    raise
                try:
                    self._checkpoint_flush()
                except Exception as flush_err:  # noqa: BLE001
                    print(f"pending checkpoint save failed during recovery: {flush_err}",
                          flush=True)
                last = ckpt_lib.latest_step(self.cfg.checkpoint_dir)
                if last is None:
                    raise
                print(f"step failed ({type(e).__name__}: {e}); restart "
                      f"{restarts}/{max_restarts} from checkpoint step {last}", flush=True)
                self._restore_checkpoint()
