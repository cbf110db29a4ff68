"""The port's GAN runner (train/gan_loop.GANRunner, cli gan-train) on
the CPU, mirroring tests/test_gan_loop.py for the JAX package: fit end to
end with the transfer tags, checkpoint/resume with the run budget, N +
restore + N steps equal to 2N bit for bit, recovery, the interrupt save,
the data sidecar, monotonic epoch indices, held-out files kept out of
training, the CLI from two class folders of PNGs; and log_sample against a
tiny JAX GANRunner on the same weights (one uint8 level on the logged
transfers: float32 sums in other orders)."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu.utils import tensorboard as jtb  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data.pipeline import ArrayDataset  # noqa: E402
from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)
TAGS = ("transfer_ab/image/0", "transfer_ba/image/0", "cycle_aba/image/0", "g_loss", "d_loss",
        "cycle", "adversarial", "identity", "images_per_sec")


def _cfg(tmp_path, **kw):
    base = dict(steps_per_epoch=2, epochs=1, learning_rate=1e-3, classes=("a", "b"),
                g_norm="instance", d_norm="instance", log_dir=str(tmp_path / "logs"),
                checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    base.update(kw)
    return tiny_test_config(**base)


def _ds(cfg, seed):
    images = np.random.default_rng(seed).integers(0, 256, (6, cfg.size, cfg.size, 3),
                                                  dtype=np.uint8)
    return ArrayDataset(images, cfg.batch_size, seed=seed)


def _runner(cfg, **kw):
    kw.setdefault("dataset_a", _ds(cfg, 0))
    kw.setdefault("dataset_b", _ds(cfg, 1))
    return GANRunner(cfg, device="cpu", **kw)


def _flat(state):
    out = {}
    ckpt_lib._walk(state, "", out)
    return out


def test_gan_runner_end_to_end_and_resume(tmp_path):
    cfg = _cfg(tmp_path)
    runner = _runner(cfg)
    runner.fit()
    runner.close()
    tags = {e[1] for e in jtb.read_events(runner.writer.path)}
    assert set(TAGS) <= tags, tags
    assert ckpt_lib.all_steps(cfg.checkpoint_dir) == [2]
    runner2 = _runner(cfg)
    assert runner2.state.step == 2
    for k, v in _flat(runner.state).items():
        w = _flat(runner2.state)[k]
        assert torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w, k
    runner2.fit()  # the budget is spent
    assert runner2.state.step == 2
    runner2.close()


def test_gan_runner_requires_two_classes(tmp_path):
    with pytest.raises(ValueError, match="exactly 2 class patterns"):
        GANRunner(tiny_test_config(classes=("only_one",)), device="cpu")
    # fid_samples > 0 is no longer refused: with datasets passed in there
    # is no file split, and the eval sets come from the datasets
    runner = _runner(_cfg(tmp_path, fid_samples=2))
    assert runner._eval_files == {"a": None, "b": None}
    assert runner._eval_set("a").shape == (2, 16, 16, 3)
    runner.close()


@pytest.mark.parametrize("source", ["array", "data_hbm"])
def test_n_plus_restore_plus_n_equals_2n_bit_for_bit(tmp_path, source):
    """One call of 2 epochs against two calls of 1 and 2 epochs on one
    checkpoint dir: the same losses, nets, optimizer states and EMAs, bit
    for bit (the generator rides the checkpoint, the stream positions the
    sidecar). DiffAugment draws from the generator too."""
    for cls in ("a", "b"):
        d = tmp_path / cls
        d.mkdir()
        r = np.random.default_rng(ord(cls))
        for i in range(4):
            Image.fromarray(r.integers(0, 256, (18, 20, 3), dtype=np.uint8)).save(d / f"{i}.png")

    def run(name, budgets):
        cfg = _cfg(tmp_path, epochs=2, ema_decay=0.9, diffaug="color,translation",
                   classes=(str(tmp_path / "a" / "*.png"), str(tmp_path / "b" / "*.png")),
                   data_hbm=18 if source == "data_hbm" else 0,
                   log_dir=str(tmp_path / name / "logs"),
                   checkpoint_dir=str(tmp_path / name / "ckpt"))
        losses = {}
        for epochs in budgets:
            c = cfg.replace(epochs=epochs)
            kw = {} if source == "data_hbm" else dict(dataset_a=_ds(c, 0), dataset_b=_ds(c, 1))
            runner = GANRunner(c, device="cpu", **kw)
            runner.fit(log_samples=False)
            losses.update({(e[0], e[1]): e[3] for e in jtb.read_events(runner.writer.path)
                           if e[2] == "scalar" and e[1] != "images_per_sec"})
            runner.close()
        return losses, runner.state

    (la, sa), (lb, sb) = run("a", [2]), run("b", [1, 2])
    assert la == lb and len(la) == 10  # 5 losses x 2 epochs
    fa, fb = _flat(sa), _flat(sb)
    assert sa.step == sb.step == 4 and sorted(fa) == sorted(fb)
    for k, v in fa.items():
        assert torch.equal(v, fb[k]) if isinstance(v, torch.Tensor) else v == fb[k], k


def test_gan_fit_resilient_recovers_from_failure(tmp_path):
    cfg = _cfg(tmp_path)
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=2, log_samples=False)
    calls = {"n": 0}
    real = runner.train_step

    def flaky(state, a, b, generator):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected fault")
        return real(state, a, b, generator)

    runner.train_step = flaky
    runner.fit_resilient(max_restarts=2, epochs=1, steps_per_epoch=2, log_samples=False)
    runner.close()
    assert calls["n"] >= 3 and runner.state.step == 4


def test_gan_keyboard_interrupt_saves_checkpoint(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_every=100)
    runner = _runner(cfg)
    real = runner.train_step
    calls = {"n": 0}

    def interrupting(state, a, b, generator):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return real(state, a, b, generator)

    runner.train_step = interrupting
    with pytest.raises(KeyboardInterrupt):
        runner.fit(epochs=1, steps_per_epoch=4, log_samples=False)
    runner.close()
    assert ckpt_lib.latest_step(cfg.checkpoint_dir) == 1


def test_gan_data_position_restored_across_restart(tmp_path):
    cfg = _cfg(tmp_path)
    runner = _runner(cfg)
    runner.fit(epochs=1, steps_per_epoch=2, log_samples=False)
    runner.close()
    a, b = _ds(cfg, 0), _ds(cfg, 1)
    runner2 = _runner(cfg, dataset_a=a, dataset_b=b)
    assert a.state_dict()["position"] == b.state_dict()["position"] == 2
    runner2.close()


def test_tb_epoch_index_is_monotonic_across_explicit_fits(tmp_path):
    runner = _runner(_cfg(tmp_path, checkpoint_dir=None))
    for _ in range(3):
        runner.fit(epochs=1, steps_per_epoch=2, log_samples=False)
    runner.close()
    steps = sorted(e[0] for e in jtb.read_events(runner.writer.path) if e[1] == "g_loss")
    assert steps == [0, 1, 2]


def test_held_out_files_never_reach_training(tmp_path):
    """The split of held_out_split(fid_samples) is made (the reserved files
    kept for the transfer FID, which waits for utils/metrics.py); with
    fid_samples=0 every file trains."""
    r = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(4):
            Image.fromarray(r.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                tmp_path / cls / f"{i}.png")
    cfg = _cfg(tmp_path, classes=(str(tmp_path / "a" / "*.png"), str(tmp_path / "b" / "*.png")),
               native_loader=False)
    runner = GANRunner(cfg, device="cpu")
    assert runner._eval_files == {"a": [], "b": []}
    assert len(runner.dataset_a.files) == len(runner.dataset_b.files) == 4
    runner.close()


def test_log_sample_matches_a_jax_gan_runner(tmp_path):
    """The same four nets in a tiny JAX GANRunner and in the port's, the
    same fixed batches: the same tags at the same step, each transfer
    within one uint8 level."""
    import jax

    from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny
    from gan_class_transfer2_tpu.data.pipeline import ArrayDataset as JArrayDataset
    from gan_class_transfer2_tpu.train.gan_loop import GANRunner as JGANRunner
    from gan_class_transfer2_tpu_torch.utils import weights

    kw = dict(classes=("a", "b"), g_norm="instance", d_norm="instance", checkpoint_dir=None)
    jcfg = jax_tiny(log_dir=str(tmp_path / "jlogs"), mesh_data=1, **kw)
    cfg = tiny_test_config(log_dir=str(tmp_path / "logs"), **kw)
    images = [np.random.default_rng(s).integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
              for s in (0, 1)]
    jr = JGANRunner(jcfg, dataset_a=JArrayDataset(images[0], 2, 0),
                    dataset_b=JArrayDataset(images[1], 2, 1))
    jr.log_sample(1)
    jr.close()
    carried = weights.from_jax_gan_state(cfg, jax.device_get(jr.state), device="cpu")
    runner = GANRunner(cfg, dataset_a=ArrayDataset(images[0], 2, 0),
                       dataset_b=ArrayDataset(images[1], 2, 1), device="cpu")
    runner.state = carried
    runner.log_sample(1)
    runner.close()
    ours, theirs = list(jtb.read_events(runner.writer.path)), list(jtb.read_events(jr.writer.path))
    assert [e[:3] for e in ours] == [e[:3] for e in theirs]
    assert {e[1] for e in ours} >= set(TAGS[:3])
    for (_, tag, kind, a), (_, _, _, b) in zip(ours, theirs):
        if kind == "image":
            pa, pb = (np.asarray(Image.open(io.BytesIO(x))).astype(int) for x in (a, b))
            assert np.abs(pa - pb).max() <= 1, tag


def test_cli_gan_train_from_png_folders(tmp_path, capsys):
    r = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(4):
            Image.fromarray(r.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
                tmp_path / cls / f"{i}.png")
    ckpt = str(tmp_path / "ckpt")
    argv = ["gan-train", "--device", "cpu", "--size", "16", "--pixel-size", "4",
            "--max-size", "8", "--octaves", "2", "--batch-size", "2", "--steps-per-epoch", "2",
            "--epochs", "1", "--g-norm", "instance", "--d-norm", "instance",
            "--classes", str(tmp_path / "a" / "*.png"), str(tmp_path / "b" / "*.png"),
            "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir", ckpt,
            "--checkpoint-every", "2", "--data-workers", "1", "--native-loader", "false",
            "--resilient", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "epoch 0: g=" in out and "native" not in out
    assert ckpt_lib.all_steps(ckpt) == [2]
    (events,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "logs") for f in fs]
    assert set(TAGS) <= {e[1] for e in jtb.read_events(events)}
    assert ckpt_lib.load_config(ckpt).classes == (str(tmp_path / "a" / "*.png"),
                                                  str(tmp_path / "b" / "*.png"))


def test_steps_to_fixed_fid_harness(tmp_path, capsys):
    """The twin of tests/test_gan_loop.py's harness test: an unreachable
    target within a 2-step budget returns (None, a finite score) at step 2,
    printing JAX's trajectory line; a target already met returns the step
    without training; degenerate eval sets raise JAX's ValueError."""
    from gan_class_transfer2_tpu_torch.utils.benchmark import steps_to_fixed_fid

    runner = _runner(_cfg(tmp_path, steps_per_epoch=1, learning_rate=1e-4, checkpoint_dir=None,
                          fid_samples=4))
    try:
        steps, fid = steps_to_fixed_fid(runner, target_fid=0.0, max_steps=2, check_every=2)
        assert steps is None and np.isfinite(fid)
        assert int(runner.state.step) == 2
        assert f"steps_to_fixed_fid: step 2 fid {fid:.4f}" in capsys.readouterr().out
        steps, kid = steps_to_fixed_fid(runner, target_fid=1e12, max_steps=4, check_every=2,
                                        metric="kid")
        assert steps == 2 and np.isfinite(kid) and int(runner.state.step) == 2
        runner.transfer_scores = lambda direction: None
        with pytest.raises(ValueError, match=">= 2 held-out images per class"):
            steps_to_fixed_fid(runner, target_fid=0.0, max_steps=2, check_every=2)
    finally:
        runner.close()
