"""The port's runner (train/loop.Runner, train/resilience.py, cli train)
on the CPU, mirroring tests/test_loop.py for the JAX package: fit end to
end with the reference's TensorBoard tags, the run budget after a resume,
N + restore + N steps equal to 2N steps bit for bit, recovery, the
interrupt save, cadences, keep_best and its guard, the data sidecar, the
CLI; and log_sample against a tiny JAX Runner on the same weights (1e-4
relative on the example loss, one uint8 level on the images: float32
sums in other orders)."""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu.utils import tensorboard as jtb  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data.pipeline import ArrayDataset  # noqa: E402
from gan_class_transfer2_tpu_torch.train.loop import Runner  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)
REF_TAGS = ("example loss", "denoised/image", "fake/image/0", "step_1/image/0",
            "step_0.25/image/0", "step_0.5/image/0", "step_0.75/image/0", "loss",
            "images_per_sec")
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4", "--batch-size", "2", "--warm-up", "2", "--test-step", "2",
        "--fused-diffusion", "false"]


@pytest.fixture
def cfg(tmp_path):
    return tiny_test_config(steps=4, steps_per_epoch=3, epochs=1,
                            log_dir=str(tmp_path / "logs"),
                            checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=3)


def _dataset(cfg, seed=0):
    images = np.random.default_rng(0).integers(0, 256, (8, cfg.size, cfg.size, 3),
                                               dtype=np.uint8)
    return ArrayDataset(images, cfg.batch_size, seed=seed)


def _runner(cfg, **kw):
    kw.setdefault("dataset", _dataset(cfg))
    return Runner(cfg, device="cpu", **kw)


def _tags(path):
    return {e[1] for e in jtb.read_events(path)}


def _params(runner):
    return [p.detach().clone() for p in runner.state.model.parameters()]


def test_runner_fit_end_to_end(cfg):
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3)
    runner.close()
    tags = _tags(runner.writer.path)
    assert set(REF_TAGS) <= tags, tags
    assert os.path.isdir(os.path.join(cfg.checkpoint_dir, "step_000000003"))
    with open(os.path.join(runner.log_dir, "config.json")) as fh:
        assert json.load(fh)["steps_per_epoch"] == 3


def test_runner_resumes_from_checkpoint(cfg):
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    runner.close()
    runner2 = _runner(cfg)
    assert runner2.state.step == 3
    for a, b in zip(_params(runner), _params(runner2)):
        assert torch.equal(a, b)
    runner2.close()


def test_resume_finishes_original_budget_not_more(cfg):
    cfg = cfg.replace(epochs=4, steps_per_epoch=2, checkpoint_every=2)
    r1 = _runner(cfg)
    r1.fit(epochs=2, log_samples=False)  # explicit: 2 more epochs
    assert r1.state.step == 4
    r1.close()
    r2 = _runner(cfg)
    assert r2.state.step == 4
    r2.fit(log_samples=False)  # budget: 2 epochs remain
    assert r2.state.step == 8
    r2.fit(log_samples=False)  # budget spent
    assert r2.state.step == 8
    r2.fit(epochs=1, log_samples=False)  # explicit stays incremental
    assert r2.state.step == 10
    r2.close()


def test_resume_from_unaligned_checkpoint_exact_budget(cfg):
    cfg = cfg.replace(epochs=2, steps_per_epoch=4, checkpoint_every=3)
    r1 = _runner(cfg)
    r1.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    assert r1.state.step == 3
    r1.close()
    r2 = _runner(cfg)
    r2.fit(log_samples=False)  # a partial epoch 0 (1 step), then epoch 1
    assert r2.state.step == 8
    r2.close()


def _losses(runner):
    return dict(e[::3][:2] for e in jtb.read_events(runner.writer.path) if e[1] == "loss")


@pytest.mark.parametrize("source", ["array", "data_hbm"])
def test_n_plus_restore_plus_n_equals_2n_bit_for_bit(tmp_path, source):
    """Two epochs in one run against one epoch, a new Runner on the same
    checkpoint dir and the second epoch: the same epoch losses and the same
    final parameters, Adam moments and EMA, bit for bit — the checkpoint
    carries the generator (t, ε) and the data sidecar the stream position.
    Fused diffusion and fused Adam on, as on the card."""
    files = tmp_path / "files"
    files.mkdir()
    r = np.random.default_rng(1)
    for i in range(5):
        Image.fromarray(r.integers(0, 256, (20, 22, 3), dtype=np.uint8)).save(files / f"{i}.png")

    def run(name, epochs_per_call):
        cfg = tiny_test_config(steps=4, steps_per_epoch=3, epochs=2, checkpoint_every=3,
                               fused_diffusion=True, optimizer="adam_fused", ema_decay=0.9,
                               learning_rate=1e-2, warm_up=1, data_hbm=20 if source == "data_hbm" else 0,
                               dataset_pattern=str(files / "*.png"),
                               log_dir=str(tmp_path / name / "logs"),
                               checkpoint_dir=str(tmp_path / name / "ckpt"))
        losses = {}
        for epochs in epochs_per_call:  # the configured budget, as cli train runs it
            c = cfg.replace(epochs=epochs)
            runner = _runner(c, dataset=_dataset(c) if source == "array" else None)
            runner.fit(log_samples=False)
            losses.update(_losses(runner))
            runner.close()
        return losses, runner.state

    (la, sa), (lb, sb) = run("a", [2]), run("b", [1, 2])
    assert sorted(la) == sorted(lb) == [0, 1]
    assert la == lb
    assert sa.step == sb.step == 6
    flat_a, flat_b = {}, {}
    ckpt_lib._walk(sa, "", flat_a)
    ckpt_lib._walk(sb, "", flat_b)
    for k, v in flat_a.items():
        assert torch.equal(v, flat_b[k]) if isinstance(v, torch.Tensor) else v == flat_b[k], k


def test_fit_resilient_recovers_from_failure(cfg):
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)  # checkpoint at 3
    calls = {"n": 0}
    real = runner.train_step

    def flaky(state, batch, generator):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected fault")
        return real(state, batch, generator)

    runner.train_step = flaky
    runner.fit_resilient(max_restarts=2, epochs=1, steps_per_epoch=3, log_samples=False)
    runner.close()
    assert calls["n"] >= 4 and runner.state.step == 6


def test_fit_resilient_gives_up(cfg):
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)

    def always_fail(state, batch, generator):
        raise RuntimeError("permanent fault")

    runner.train_step = always_fail
    with pytest.raises(RuntimeError, match="permanent"):
        runner.fit_resilient(max_restarts=1, epochs=1, steps_per_epoch=1, log_samples=False)
    runner.close()
    fresh = _runner(cfg.replace(checkpoint_dir=cfg.checkpoint_dir + "_empty"))
    fresh.train_step = always_fail
    with pytest.raises(RuntimeError, match="permanent"):  # nothing to restore
        fresh.fit_resilient(max_restarts=3, epochs=1, steps_per_epoch=1, log_samples=False)
    fresh.close()


def test_keyboard_interrupt_saves_a_checkpoint(cfg, capsys):
    runner = _runner(cfg.replace(checkpoint_every=100))
    real = runner.train_step
    calls = {"n": 0}

    def interrupted(state, batch, generator):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return real(state, batch, generator)

    runner.train_step = interrupted
    with pytest.raises(KeyboardInterrupt):
        runner.fit(epochs=1, steps_per_epoch=5, log_samples=False)
    runner.close()
    assert ckpt_lib.all_steps(cfg.checkpoint_dir) == [2]
    assert "interrupted — checkpoint saved" in capsys.readouterr().out


def test_cadence_zero_disables_checkpoints_and_sampling(cfg):
    cfg = cfg.replace(checkpoint_every=0, log_images_every=0, steps_per_epoch=2)
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=2)
    runner.close()
    assert ckpt_lib.all_steps(cfg.checkpoint_dir) == []
    tags = _tags(runner.writer.path)
    assert "loss" in tags and "denoised/image" not in tags


def test_host_sync_every_leaves_results_unchanged(cfg):
    out = []
    for every in (1, 0):
        c = cfg.replace(host_sync_every=every, checkpoint_dir=f"{cfg.checkpoint_dir}_{every}")
        runner = _runner(c)
        runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
        out.append(_params(runner))
        runner.close()
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_data_position_restored_across_restart(cfg):
    ds = _dataset(cfg)
    runner = _runner(cfg, dataset=ds)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    assert ds.state_dict()["position"] == 4  # one batch prefetched
    runner.close()
    ds2 = _dataset(cfg)
    runner2 = _runner(cfg, dataset=ds2)
    assert ds2.state_dict()["position"] == 3  # the consumed position
    runner2.close()


def test_restore_tolerates_cross_input_path_sidecar(cfg, capsys):
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    runner.close()
    extra = os.path.join(cfg.checkpoint_dir, "step_000000003.extra.json")
    with open(extra, "w") as fh:
        json.dump({"data": {"dataset": {"batches_served": 3, "resume_round": 0}}}, fh)
    runner2 = _runner(cfg)
    assert runner2.state.step == 3
    assert "stream position not restored" in capsys.readouterr().out
    runner2.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    runner2.close()


def test_keep_best_tracker_and_its_guard(cfg, capsys):
    """Saves only on improvement; best/ is a checkpoint dir of its own; a
    restarted run continues the tracker; a record under another metric or
    extractor is ignored; one without the extractor field is trusted."""
    cfg = cfg.replace(keep_best=True)
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    assert runner._maybe_keep_best(5.0, 0, "fid") is not None
    assert runner._maybe_keep_best(7.0, 1, "fid") is None
    assert runner._maybe_keep_best(3.0, 2, "fid") is not None
    assert ckpt_lib.read_best(cfg.checkpoint_dir) == {
        "metric": "fid", "value": 3.0, "step": 3, "epoch": 2, "fid_extractor": cfg.fid_extractor}
    best = os.path.join(cfg.checkpoint_dir, "best")
    assert ckpt_lib.all_steps(best) == [3] and os.path.exists(os.path.join(best, "config.json"))
    runner.close()
    runner2 = _runner(cfg)
    assert runner2._maybe_keep_best(4.0, 0, "fid") is None
    assert runner2._maybe_keep_best(2.0, 1, "fid") is not None
    runner2.close()
    runner3 = _runner(cfg)  # another metric: 280 >> 2, but incomparable
    assert runner3._maybe_keep_best(280.0, 0, "transfer_fid_mean") is not None
    assert "incomparable" in capsys.readouterr().out
    runner3.close()
    runner3 = _runner(cfg.replace(fid_extractor="random"))  # another extractor
    assert runner3._maybe_keep_best(500.0, 0, "transfer_fid_mean") is not None
    runner3.close()
    path = os.path.join(best, "best.json")
    with open(path) as fh:
        legacy = json.load(fh)
    legacy.pop("fid_extractor")
    legacy.update(metric="fid", value=1.0)
    with open(path, "w") as fh:
        json.dump(legacy, fh)
    runner4 = _runner(cfg)
    assert runner4._maybe_keep_best(2.0, 0, "fid") is None
    assert runner4._maybe_keep_best(float("nan"), 0, "fid") is None
    runner4.close()


def test_async_checkpointing_trains_and_flushes(cfg):
    cfg = cfg.replace(checkpoint_async=True, checkpoint_every=1, checkpoint_keep=2)
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=3, log_samples=False)
    assert ckpt_lib.all_steps(cfg.checkpoint_dir) == [2, 3]
    runner.close()
    assert _runner(cfg).state.step == 3


def test_log_sample_matches_a_jax_runner(tmp_path, cfg):
    """The same weights in a tiny JAX Runner and in the port's: log_sample
    writes the same tags at the same step, its example loss within 1e-4
    relative and its images within one uint8 level."""
    from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny
    from gan_class_transfer2_tpu.data.pipeline import ArrayDataset as JArrayDataset
    from gan_class_transfer2_tpu.train.loop import Runner as JRunner
    from gan_class_transfer2_tpu_torch.utils import weights

    jcfg = jax_tiny(steps=4, log_dir=str(tmp_path / "jlogs"), checkpoint_dir=None, mesh_data=1)
    images = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    jr = JRunner(jcfg, dataset=JArrayDataset(images, 2))
    jr.log_sample(2)
    jr.close()
    runner = _runner(cfg.replace(checkpoint_dir=None))
    model = weights.from_jax_params(cfg, jax_params_np(jr.state.params), device="cpu")
    with torch.no_grad():
        for p, q in zip(runner.state.model.parameters(), model.parameters()):
            p.copy_(q)
    runner.log_sample(2)
    runner.close()
    ours, theirs = list(jtb.read_events(runner.writer.path)), list(jtb.read_events(jr.writer.path))
    assert [e[:3] for e in ours] == [e[:3] for e in theirs]
    assert {e[1] for e in ours} >= set(REF_TAGS) - {"loss", "images_per_sec"}
    for (_, tag, kind, a), (_, _, _, b) in zip(ours, theirs):
        if kind == "scalar":
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=tag)
        elif kind == "image":
            pa, pb = (np.asarray(Image.open(io.BytesIO(x))).astype(int) for x in (a, b))
            assert np.abs(pa - pb).max() <= 1, tag


def jax_params_np(params):
    import jax

    return jax.tree_util.tree_map(np.asarray, params)


def test_fid_and_multi_host_are_refused(cfg, tmp_path):
    """FID is ported: fid_samples=4 reserves held-out files (class 0's
    are the reference set) and no longer raises; multi-host still does.
    (The name is kept from when both were refused.)"""
    r = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(r.integers(0, 256, (18, 18, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    runner = Runner(cfg.replace(fid_samples=4, dataset_pattern=str(tmp_path / "*.png")),
                    device="cpu")
    assert len(runner._eval_files) == 4
    assert not set(runner._eval_files) & set(runner.dataset.files)
    runner.close()
    for flags in (["--coordinator", "localhost:1234"], ["--num-processes", "2"],
                  ["--process-id", "0"]):
        with pytest.raises(NotImplementedError, match="parallel/multihost.py"):
            cli.main(["train", "--device", "cpu", *flags])


def test_cli_train_sample_and_export_weights_end_to_end(tmp_path, capsys):
    """cli train from Pillow-written PNGs on the CPU: checkpoints, an event
    file the JAX reader reads with the reference's tags, a resumed call
    that finishes the budget; then sample and export-weights read the
    checkpoint (its config.json and EMA), and the exported weights
    reproduce the restored EMA model."""
    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.train import trainer
    from gan_class_transfer2_tpu_torch.utils import weights

    r = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(r.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(tmp_path / f"{i}.png")
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    argv = ["train", "--device", "cpu", *TINY, "--dataset-pattern", str(tmp_path / "*.png"),
            "--steps-per-epoch", "2", "--epochs", "1", "--ema-decay", "0.9",
            "--log-dir", logs, "--checkpoint-dir", ckpt, "--checkpoint-every", "2",
            "--data-workers", "1"]
    assert cli.main(argv) == 0
    assert "native_loader" not in capsys.readouterr().out  # the C++ loader ran
    assert ckpt_lib.all_steps(ckpt) == [2]
    (events,) = [os.path.join(d, f) for d, _, fs in os.walk(logs) for f in fs
                 if f.startswith("events")]
    assert set(REF_TAGS) <= _tags(events)
    assert cli.main(argv[:argv.index("--epochs")] + ["--epochs", "2"]
                    + argv[argv.index("--epochs") + 2:]) == 0
    assert ckpt_lib.all_steps(ckpt) == [2, 4]

    out = tmp_path / "samples"
    assert cli.main(["sample", "--device", "cpu", "--checkpoint-dir", ckpt, "--num", "2",
                     "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["sample_0.png", "sample_1.png"]
    assert "randomly initialised" not in capsys.readouterr().err
    npz = str(tmp_path / "w.npz")
    assert cli.main(["export-weights", "--device", "cpu", "--checkpoint-dir", ckpt,
                     "--out", npz]) == 0
    cfg = ckpt_lib.load_config(ckpt)
    assert cfg.ema_decay == 0.9 and cfg.size == 16
    state = ckpt_lib.restore(ckpt, trainer.init_state(cfg, device="cpu"))
    ema = trainer.eval_model(state)
    model = weights.import_flat_weights(api.init_denoiser(cfg, device="cpu"),
                                        weights.load_flat_npz(npz))
    for a, b in zip(model.parameters(), ema.parameters()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(ema.parameters(), state.model.parameters()))
    edits = tmp_path / "edits"
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", ckpt, "--input",
                     str(tmp_path / "0.png"), "--out", str(edits), "--edits", "shift"]) == 0
    assert sorted(os.listdir(edits)) == ["reconstruction.png", "shift.png"]


def test_cli_config_inherits_the_checkpoint_config(tmp_path, monkeypatch):
    """sample/edit/export-weights rebuild the state the checkpoint was
    written with: the config.json in --checkpoint-dir (the default dir
    too) is the base, explicit flags win, train does not inherit."""
    import argparse

    from gan_class_transfer2_tpu_torch.config import Config

    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(Config(optimizer="adam_tf", schedule="cosine2",
                                             classes=("a", "b")).to_json())
    monkeypatch.chdir(tmp_path)
    parser = argparse.ArgumentParser()
    cli._add_config_args(parser)
    args = parser.parse_args([])
    args.config = None
    c = cli.config_from_args(args, checkpoint_config=True)
    assert (c.optimizer, c.schedule, c.classes) == ("adam_tf", "cosine2", ("a", "b"))
    assert c.checkpoint_dir == "checkpoints"
    args2 = parser.parse_args(["--schedule", "quadratic", "--classes", "x", "y"])
    args2.config = None
    c2 = cli.config_from_args(args2, checkpoint_config=True)
    assert (c2.schedule, c2.optimizer, c2.classes) == ("quadratic", "adam_tf", ("x", "y"))
    assert cli.config_from_args(args).optimizer == "adam"
