"""FID/KID in the port's runners (train/loop.Runner.quality_scores,
train/gan_loop.GANRunner.transfer_scores), cli eval and
utils/benchmark.run_sampler_benchmark, against the JAX package on the CPU
with the same weights (carried by utils/weights), the same held-out files
and the same initial noise.

Tolerances. The samples agree as tests/test_torch_sampler.py holds them
(1e-4 relative to their scale). KID is well conditioned: 1e-5 relative.
FID over fewer than 256 images has a covariance of rank below 256, whose
matrix square root could amplify tiny feature differences; here rtol 1e-3
holds with room: the scores below differ from JAX's by ~2e-8 relative
(FID ~1.1e4, 3.9e3 and 7.1e2 on the CPU; KID by ~2.5e-8)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402

from gan_class_transfer2_tpu import cli as jcli  # noqa: E402
from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.utils import metrics as jm  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4", "--batch-size", "2"]


@pytest.fixture(scope="module")
def class_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_classes")
    r = np.random.default_rng(0)
    for cls, shift in (("a", 0), ("b", 90)):
        (d / cls).mkdir()
        for i in range(10):
            img = (r.integers(0, 160, (20, 20, 3)) + shift).astype(np.uint8)
            Image.fromarray(img).save(d / cls / f"{i}.png")
    return d


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_runner_quality_scores_match_jax(class_dirs, tmp_path):
    from gan_class_transfer2_tpu.train.loop import Runner as JRunner
    from gan_class_transfer2_tpu_torch.train.loop import Runner

    n = 6
    kw = dict(steps=4, fid_samples=n, dataset_pattern=str(class_dirs / "a" / "*.png"),
              checkpoint_dir=None)
    jr = JRunner(jax_tiny(mesh_data=1, log_dir=str(tmp_path / "jlogs"), **kw))
    runner = Runner(tiny_test_config(log_dir=str(tmp_path / "logs"), **kw), device="cpu")
    assert runner._eval_files == jr._eval_files and len(runner._eval_files) == n
    model = weights.from_jax_params(runner.cfg, _np(jr.state.params), device="cpu")
    with torch.no_grad():
        for p, q in zip(runner.state.model.parameters(), model.parameters()):
            p.copy_(q)
    init = np.random.default_rng(3).normal(size=(n, 16, 16, 3)).astype(np.float32)
    want_samples = np.asarray(jr._metric_sample(jr.state.params, jax.numpy.asarray(init)))
    got_samples = runner._metric_sample(runner.state.model, torch.from_numpy(init)).numpy()
    scale = np.abs(want_samples).max()
    np.testing.assert_allclose(got_samples, want_samples, rtol=1e-4, atol=1e-4 * scale)

    ref = jr._fid_reference_set(n)
    np.testing.assert_array_equal(runner._fid_reference_set(n), ref)
    x = jm.get_extractor("auto")
    want = jm.fid_and_kid(want_samples, ref, extractor=x)
    got = runner.quality_scores(init=torch.from_numpy(init))
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-3)
    assert got["kid"] == pytest.approx(want["kid"], rel=1e-5)
    # without an injected init the noise comes from the runner's generator
    state = runner.generator.get_state()
    again = runner.quality_scores()
    assert not torch.equal(runner.generator.get_state(), state) and np.isfinite(again["fid"])
    assert np.isfinite(runner.compute_fid())
    jr.close()
    runner.close()


def test_gan_runner_transfer_scores_match_jax(class_dirs, tmp_path):
    from gan_class_transfer2_tpu.train.gan_loop import GANRunner as JGANRunner
    from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner

    classes = (str(class_dirs / "a" / "*.png"), str(class_dirs / "b" / "*.png"))
    kw = dict(classes=classes, fid_samples=5, g_norm="instance", d_norm="instance",
              checkpoint_dir=None)
    jr = JGANRunner(jax_tiny(mesh_data=1, log_dir=str(tmp_path / "jlogs"), **kw))
    runner = GANRunner(tiny_test_config(log_dir=str(tmp_path / "logs"), **kw), device="cpu")
    assert runner._eval_files == jr._eval_files
    runner.state = weights.from_jax_gan_state(runner.cfg, jax.device_get(jr.state),
                                              device="cpu")
    for d in ("ab", "ba"):
        src = jr._eval_set("a" if d == "ab" else "b")
        np.testing.assert_array_equal(runner._eval_set("a" if d == "ab" else "b"), src)
        want = jr.transfer_scores(d)
        state = runner.generator.get_state()
        got = runner.transfer_scores(d)
        assert torch.equal(runner.generator.get_state(), state)  # the transfer draws no noise
        assert got["fid"] == pytest.approx(want["fid"], rel=1e-3)
        assert got["kid"] == pytest.approx(want["kid"], rel=1e-5)
        assert runner.transfer_fid(d) == got["fid"]  # the transfer is deterministic
    jr.close()
    runner.close()


def test_log_sample_writes_fid_kid_and_keeps_the_best(class_dirs, tmp_path):
    from gan_class_transfer2_tpu.utils import tensorboard as jtb
    from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner
    from gan_class_transfer2_tpu_torch.train.loop import Runner

    cfg = tiny_test_config(steps=4, fid_samples=4, keep_best=True,
                           dataset_pattern=str(class_dirs / "a" / "*.png"),
                           checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "l"))
    runner = Runner(cfg, device="cpu")
    runner.log_sample(0)
    runner.close()
    tags = {e[1] for e in jtb.read_events(runner.writer.path)}
    assert {"fid", "kid"} <= tags
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "best", "best.json"))
    gcfg = cfg.replace(classes=(str(class_dirs / "a" / "*.png"), str(class_dirs / "b" / "*.png")),
                       checkpoint_dir=str(tmp_path / "gckpt"), fid_samples=3)
    g = GANRunner(gcfg, device="cpu")
    g.log_sample(0)
    g.close()
    tags = {e[1] for e in jtb.read_events(g.writer.path)}
    assert {"transfer_fid_ab", "transfer_fid_ba", "transfer_kid_ab", "transfer_kid_ba"} <= tags
    with open(os.path.join(gcfg.checkpoint_dir, "best", "best.json")) as fh:
        assert json.load(fh)["metric"] == "transfer_fid_mean"


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["diffusion", "gan"])
def test_cli_eval_prints_the_jax_commands_keys(class_dirs, tmp_path, capsys, model):
    """No checkpoint on either side: both warn and score random weights."""
    data = (["--dataset-pattern", str(class_dirs / "a" / "*.png")] if model == "diffusion"
            else ["--classes", str(class_dirs / "a" / "*.png"), str(class_dirs / "b" / "*.png"),
                  "--g-norm", "instance", "--d-norm", "instance"])
    common = ["eval", "--model", model, *TINY, *data, "--fid-samples", "3",
              "--checkpoint-dir", str(tmp_path / "none")]
    assert cli.main([*common, "--device", "cpu"]) == 0
    io = capsys.readouterr()
    ours = json.loads(io.out.strip().splitlines()[-1])
    assert "no checkpoint found" in io.err
    assert jcli.main([*common, "--platform", "cpu", "--mesh-data", "1"]) == 0
    theirs = _last_json(capsys)
    assert sorted(ours) == sorted(theirs)
    assert ours["command"] == "eval" and ours["model"] == model and ours["step"] == 0
    scores = {k: v for k, v in ours.items() if k in ("fid", "kid") or k.startswith("transfer_")}
    assert len(scores) in (2, 4) and all(np.isfinite(v) for v in scores.values())


def test_cli_eval_scores_a_trained_checkpoint_and_refuses(class_dirs, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", "--device", "cpu", *TINY, "--dataset-pattern",
                     str(class_dirs / "a" / "*.png"), "--steps-per-epoch", "2", "--epochs", "1",
                     "--fused-diffusion", "false", "--checkpoint-dir", ckpt,
                     "--checkpoint-every", "2", "--log-dir", str(tmp_path / "logs"),
                     "--fid-samples", "3", "--log-images-every", "0"]) == 0
    capsys.readouterr()
    # the config (fid_samples included) is inherited from the checkpoint
    assert cli.main(["eval", "--device", "cpu", "--checkpoint-dir", ckpt]) == 0
    out = _last_json(capsys)
    assert out["step"] == 2 and np.isfinite(out["fid"]) and np.isfinite(out["kid"])
    assert not os.path.exists(str(tmp_path / "logs2"))
    with pytest.raises(SystemExit, match="fid_samples > 0"):
        cli.main(["eval", "--device", "cpu", "--checkpoint-dir", ckpt, "--fid-samples", "0"])
    with pytest.raises(NotImplementedError, match="models/conditional.py"):
        cli.main(["eval", "--device", "cpu", "--model", "cgan", "--checkpoint-dir", ckpt])


def test_run_sampler_benchmark_has_the_jax_keys():
    from gan_class_transfer2_tpu.utils import benchmark as jbench
    from gan_class_transfer2_tpu_torch.utils import benchmark

    ours = benchmark.run_sampler_benchmark(tiny_test_config(steps=4), batch=2, iters=1,
                                           device="cpu")
    theirs = jbench.run_sampler_benchmark(jax_tiny(steps=4, mesh_data=1), batch=2, iters=1)
    assert sorted(ours) == sorted(theirs)
    assert ours["sampler_denoiser_calls"] == theirs["sampler_denoiser_calls"] == 4
    assert ours["sampler_mfu"] is None and ours["sampler_images_per_sec"] > 0
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        benchmark.run_sampler_benchmark(tiny_test_config(), mesh=type("M", (), {"size": 2})(),
                                        device="cpu")
