"""Port parity of pipeline parallelism (gan_class_transfer2_tpu_torch
.parallel.pipeline) on the CPU, every stage on the one CPU device: the
stage plan and its errors against JAX's, the stage views, the pipeline step
against the port's one-process step on the same generator state (stages
2/3, microbatches 1/2/4, PP × DP 2, EMA, the global clip, the ε
parameterization, concat elision off, B2's plain version), the pipeline
step against JAX's ``PipelineTrainer.step`` on JAX's 8 host devices (its
draws taken from its own ``_prep``), JAX's refusals word for word,
checkpoints both ways, and the Runner through ``cli train
--pipeline-stages 2``.

Tolerances, each with its reason: the pipeline and the one-process step
differ only in the order of float32 sums (microbatch gradients summed with
cotangent 1/M, replica gradients summed on the stage's device, the loss as
a mean of means): the loss rtol 1e-6, weights and moments atol 1e-6 after
updates of ~1e-3 (constant lr 1e-3). Against JAX the bounds of the
one-process injected step (test_torch_trainer.py: loss rtol 2e-5, weights
atol 2e-5), from a state moved off its init by one JAX step so that no
near-zero gradient sits in Adam's first normalised step."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.parallel import pipeline as jpipeline  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import multihost, pipeline  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)
LR = 1e-3


def _cfg(**kw):
    base = dict(octaves=3, batch_size=8, pipeline_stages=2, lr_schedule="constant",
                learning_rate=LR)
    base.update(kw)
    return tiny_test_config(**base)


def _batch(cfg, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (cfg.batch_size, cfg.size, cfg.size, 3)).astype(np.float32))


def _one(cfg):
    return cfg.replace(pipeline_stages=1, pipeline_microbatches=0, pipeline_cuts="",
                       mesh_data=0)


def _flat(state):
    """Params, then every tensor of the optimizer state, then the EMA."""
    from gan_class_transfer2_tpu_torch.parallel.mesh import _leaves

    out = [p.detach() for p in state.model.parameters()]
    out += [t for _, t in _leaves(state.opt_state)]
    return out + list(state.ema_params or [])


# ------------------------------------------------------------------ planning


@pytest.mark.parametrize("kw, stages, cuts", [
    (dict(octaves=6, size=64), 2, ""), (dict(octaves=6, size=64), 3, ""),
    (dict(octaves=6, size=64), 4, ""), (dict(octaves=6, size=64), 2, "1"),
    (dict(octaves=6, size=64), 3, "2,4"), (dict(octaves=4, size=32, block_depth=2), 3, ""),
    (dict(octaves=3, skip_mode="residual"), 2, ""), (dict(octaves=5, size=64, max_size=16), 5, ""),
])
def test_plan_and_costs_equal_jax(kw, stages, cuts):
    cfg = tiny_test_config(**kw, pipeline_cuts=cuts, pipeline_stages=stages)
    jcfg = jconfig.tiny_test_config(**kw, pipeline_cuts=cuts, pipeline_stages=stages)
    assert pipeline.octave_costs(cfg) == jpipeline.octave_costs(jcfg)
    assert pipeline.plan_stages(cfg, stages) == jpipeline.plan_stages(jcfg, stages)


def test_plan_errors_are_jax_errors():
    cfg = tiny_test_config(octaves=3)
    jcfg = jconfig.tiny_test_config(octaves=3)
    for port_cfg, j_cfg, n in ((cfg, jcfg, 4), (cfg, jcfg, 0),
                               (tiny_test_config(octaves=6, size=64, pipeline_cuts="2,4"),
                                jconfig.tiny_test_config(octaves=6, size=64,
                                                         pipeline_cuts="2,4"), 2)):
        with pytest.raises(ValueError) as want:
            jpipeline.plan_stages(j_cfg, n)
        with pytest.raises(ValueError) as got:
            pipeline.plan_stages(port_cfg, n)
        assert str(got.value) == str(want.value)


def test_stage_views_round_trip_and_follow_the_stage_modules():
    cfg = _cfg(octaves=4, block_depth=1)
    state = trainer.init_state(cfg, device="cpu")
    params = list(state.model.parameters())
    plan = pipeline.plan_stages(cfg, 3)
    index = pipeline.stage_indices(state.model, plan)
    assert sorted(i for ix in index for i in ix) == list(range(len(params)))
    for s in range(3):
        view = pipeline.tree_stage_view(index, params, s)
        assert [id(p) for p in pipeline.Stage(state.model, plan, s).parameters()] == \
            [id(p) for p in view]
    names = [n for n, _ in state.model.named_parameters()]
    assert all(names[i].startswith(("pre_block", "post_block", "head", "octaves.0."))
               for i in index[0])
    assert any(names[i].startswith("middle") for i in index[2])
    rebuilt = [None] * len(params)
    for s in range(3):
        rebuilt = pipeline.tree_stage_merge(index, rebuilt, s,
                                            pipeline.tree_stage_view(index, params, s))
    assert all(a is b for a, b in zip(rebuilt, params))


# ----------------------------------------------------------------- parity


@pytest.mark.parametrize("stages, micro, dp, extra", [
    (2, 1, 1, {}), (2, 2, 1, {}), (3, 4, 1, {}), (2, 2, 2, {}), (3, 2, 2, {}),
    (2, 2, 1, dict(ema_decay=0.9, grad_clip_norm=1e-3)),
    (3, 2, 1, dict(parameterization="scaled_epsilon", concat_elision=False)),
    (2, 2, 1, dict(optimizer="adam_fused", fused_diffusion=True)),
    (3, 2, 1, dict(block_depth=1, skip_mode="residual", optimizer="momentum")),
    (2, 4, 1, dict(pipeline_cuts="1", parameterization="epsilon", ema_decay=0.5)),
])
def test_pipeline_step_matches_one_process_step(stages, micro, dp, extra):
    cfg = _cfg(pipeline_stages=stages, pipeline_microbatches=micro, mesh_data=dp, **extra)
    x = _batch(cfg)
    ref, ref_loss = trainer.make_train_step(_one(cfg))(
        trainer.init_state(_one(cfg), device="cpu"), x, torch.Generator().manual_seed(7))
    init = [p.detach().clone() for p in trainer.init_state(cfg, device="cpu").model.parameters()]
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    st, loss = tr.step(tr.init_state(), x, torch.Generator().manual_seed(7))
    assert st.step == 1 and loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    moved = max((p.detach() - q).abs().max().item() for p, q in zip(st.model.parameters(), init))
    assert moved > 100 * 1e-6  # the update stands far above the tolerance
    got, want = _flat(st), _flat(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_two_pipeline_steps_track_the_one_process_run():
    cfg = _cfg(pipeline_stages=3, pipeline_microbatches=2, ema_decay=0.9)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    st, ref = tr.init_state(), trainer.init_state(_one(cfg), device="cpu")
    step = trainer.make_train_step(_one(cfg))
    g_pp, g_one = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for k in range(2):
        st, loss = tr.step(st, _batch(cfg, k), g_pp)
        ref, ref_loss = step(ref, _batch(cfg, k), g_one)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert st.step == 2
    for a, b in zip(_flat(st), _flat(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def _against_jax_pipeline(stages, micro, dp, **extra):
    jcfg = jconfig.tiny_test_config(octaves=3, batch_size=8, learning_rate=LR, warm_up=1,
                                    pipeline_stages=stages, pipeline_microbatches=micro,
                                    mesh_data=dp, donate_state=False, **extra)
    r = np.random.default_rng(21)
    one = jcfg.replace(pipeline_stages=1, pipeline_microbatches=0, mesh_data=0)
    st = jtrainer.init_state(one, jax.random.PRNGKey(1))
    x0 = r.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32)
    st, _ = jtrainer.make_injected_train_step(one)(
        st, jnp.asarray(x0), r.integers(1, jcfg.steps + 1, 8).astype(np.int32),
        jnp.asarray(r.normal(size=x0.shape).astype(np.float32)))
    jst = jax.tree_util.tree_map(np.asarray, st)
    x = r.uniform(-1, 1, x0.shape).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jtr = jpipeline.PipelineTrainer(jcfg)
    prep = [torch.from_numpy(np.array(v)) for v in jtr._prep(jnp.asarray(x), rng, jst.step)]
    new, jloss = jtr.step(jtr.place_state(jax.tree_util.tree_map(jnp.asarray, jst)),
                          jnp.asarray(x), rng)

    cfg = Config.from_json(jcfg.to_json())
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    state = tr.place_state(weights.from_jax_train_state(cfg, jst, device="cpu"))
    state, loss = tr.step_from_draws(state, *prep)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    want = weights.from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, new.params),
                                   device="cpu")
    for a, b in zip(state.model.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-5, rtol=0)
    return float(loss)


@pytest.mark.parametrize("stages, micro, dp", [(2, 2, 1), (3, 4, 1), (2, 2, 2)])
def test_pipeline_step_matches_jax_pipeline_step(stages, micro, dp):
    _against_jax_pipeline(stages, micro, dp)


@pytest.mark.parametrize("dp", [1, 2])
def test_batch_norm_statistics_are_each_microbatch_s_as_in_jax(dp):
    """With batch norms in the denoiser each microbatch takes its own
    statistics, as in JAX's pipeline (a stage program runs on one
    microbatch, over its data devices under PP × DP): the step equals
    JAX's at its bounds, and differs from the one-process step on the whole
    batch."""
    loss = _against_jax_pipeline(2, 2, dp, g_norm="batch", optimizer="momentum")
    cfg = _cfg(pipeline_microbatches=2, mesh_data=dp, g_norm="batch", optimizer="momentum")
    one = Config.from_json(cfg.to_json()).replace(pipeline_stages=1, pipeline_microbatches=0,
                                                 mesh_data=0)
    x = _batch(cfg)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    _, pp = tr.step(tr.init_state(), x, torch.Generator().manual_seed(7))
    _, whole = trainer.make_train_step(one)(trainer.init_state(one, device="cpu"), x,
                                            torch.Generator().manual_seed(7))
    assert np.isfinite(loss) and abs(float(pp) - float(whole)) > 1e-4 * abs(float(whole))


def test_batch_norm_replicas_run_in_threads_and_share_their_statistics():
    """PP × DP 2 under batch norm: each replica's stage forward runs its own
    rows of every microbatch, in a thread of its own (the threads take
    turns on the host between the norms); the replicas' group
    sums each norm's statistics (two sums) once a microbatch in the
    forward (which stops short of stage 0's ascent) and once in the
    recompute; one ``autograd.grad`` a stage
    program and microbatch takes every replica's gradients (not one a
    replica: on the card a barrier in autograd's backward would deadlock
    replicas that share a device). The step equals the pipeline without
    replicas, whose stages take each microbatch's statistics whole."""
    cfg = _cfg(pipeline_microbatches=2, mesh_data=2, g_norm="batch", optimizer="momentum")
    x = _batch(cfg)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    st, loss = tr.step(tr.init_state(), x, torch.Generator().manual_seed(7))
    S, M, D = 2, 2, 2
    rows = cfg.batch_size // (M * D)
    c = tr.counts
    assert tr._threads is not None and c["rows"] == [[M * rows] * D] * S
    # a down and an up norm an octave; the no-grad forward stops short of
    # stage 0's ascent, which only its recompute (with the loss) runs
    norms, ups0 = 2 * cfg.octaves, tr.plan[0][1] - tr.plan[0][0]
    assert c["sums"] == 2 * M * ((norms - ups0) + norms)
    assert c["grads"] == M * (2 * S - 1)
    one = pipeline.PipelineTrainer(cfg.replace(mesh_data=1), device="cpu")
    ref, ref_loss = one.step(one.init_state(), x, torch.Generator().manual_seed(7))
    assert one.counts["sums"] == 0 and one._threads is None
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for a, b in zip(_flat(st), _flat(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_replica_threads_end_when_their_trainer_goes():
    """The replicas' threads hold nothing of a step once it has ended: a
    trainer that used them is freed when its last reference goes, and its
    threads end with it (its weights do not stay for the life of the
    process)."""
    import gc
    import weakref

    cfg = _cfg(pipeline_microbatches=2, mesh_data=2, g_norm="batch", optimizer="momentum")
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    tr.step(tr.init_state(), _batch(cfg), torch.Generator().manual_seed(7))
    threads = list(tr._threads._threads)
    assert all(t.is_alive() for t in threads)
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)


def test_a_replica_s_error_surfaces_in_the_caller(monkeypatch):
    """A replica thread that raises aborts the group's waits: the step
    raises its error at once, with no hang, and the trainer steps again."""
    import threading

    cfg = _cfg(pipeline_microbatches=2, mesh_data=2, g_norm="batch", optimizer="momentum")
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    state = tr.init_state()
    mid = pipeline._stage_mid

    def failing(*a, **k):
        if threading.current_thread().name == "replica-1":
            raise RuntimeError("replica 1 failed")
        return mid(*a, **k)

    monkeypatch.setattr(pipeline, "_stage_mid", failing)
    with pytest.raises(RuntimeError, match="replica 1 failed"):
        tr.step(state, _batch(cfg), torch.Generator().manual_seed(7))
    monkeypatch.setattr(pipeline, "_stage_mid", mid)
    _, loss = tr.step(state, _batch(cfg), torch.Generator().manual_seed(7))
    assert np.isfinite(float(loss))


def test_step_refuses_a_batch_the_microbatches_do_not_divide():
    cfg = _cfg(batch_size=4, pipeline_microbatches=2)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="divisible by pipeline_microbatches=2"):
        tr.step(tr.init_state(), _batch(cfg)[:3], torch.Generator().manual_seed(0))


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("kw", [
    dict(pipeline_stages=1), dict(num_classes=2), dict(mesh_model=2), dict(mesh_slice=2),
    dict(zero1=True), dict(grad_accum=2), dict(loss_scale=128.0),
    dict(dynamic_loss_scale=True), dict(batch_size=6, pipeline_microbatches=4),
    dict(batch_size=4, pipeline_microbatches=2, mesh_data=4),
])
def test_refusals_by_jax_message(kw):
    jkw = dict(octaves=3, batch_size=8, pipeline_stages=2, donate_state=False)
    jkw.update(kw)
    with pytest.raises(ValueError) as want:
        jpipeline.PipelineTrainer(jconfig.tiny_test_config(**jkw))
    with pytest.raises(ValueError) as got:
        pipeline.PipelineTrainer(_cfg(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_more_than_one_process_is_refused_by_jax_message(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as want:
        jpipeline.PipelineTrainer(jconfig.tiny_test_config(octaves=3, batch_size=8,
                                                           pipeline_stages=2))
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError) as got:
        pipeline.PipelineTrainer(_cfg(), device="cpu")
    assert str(got.value) == str(want.value)


def test_device_rule():
    cfg = _cfg(mesh_data=2)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")  # the one CPU holds all four
    assert tr.stage_devices == [[torch.device("cpu")] * 2] * 2
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        pipeline.PipelineTrainer(cfg, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            pipeline.PipelineTrainer(cfg)  # the card by default


# ------------------------------------------------------------ checkpoints


def test_checkpoints_interchange_both_ways(tmp_path):
    cfg = _cfg(pipeline_microbatches=2, ema_decay=0.9)
    tr = pipeline.PipelineTrainer(cfg, device="cpu")
    st, _ = tr.step(tr.init_state(), _batch(cfg), torch.Generator().manual_seed(1))
    ckpt_lib.save(str(tmp_path / "pp"), st, cfg)
    one = ckpt_lib.restore(str(tmp_path / "pp"), trainer.init_state(_one(cfg), device="cpu"))
    assert one.step == 1
    for a, b in zip(_flat(one), _flat(st)):
        assert torch.equal(a, b)
    # and a one-process checkpoint into the pipeline: a step from each agrees
    ref, ref_loss = trainer.make_train_step(_one(cfg))(one, _batch(cfg, 1),
                                                       torch.Generator().manual_seed(2))
    ckpt_lib.save(str(tmp_path / "one"), ref, cfg)
    back = tr.place_state(ckpt_lib.restore(str(tmp_path / "one"), tr.init_state()))
    assert back.step == 2
    for a, b in zip(_flat(back), _flat(ref)):
        assert torch.equal(a, b)
    st3, loss3 = tr.step(back, _batch(cfg, 2), torch.Generator().manual_seed(3))
    ref3, want3 = trainer.make_train_step(_one(cfg))(ref, _batch(cfg, 2),
                                                     torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(loss3), float(want3), rtol=1e-6)
    for a, b in zip(_flat(st3), _flat(ref3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


# ------------------------------------------------------------------ runner


def test_cli_train_pipeline_stages_2(tmp_path, capsys, monkeypatch):
    from gan_class_transfer2_tpu_torch.data import synthetic

    monkeypatch.chdir(tmp_path)
    synthetic.save_as_pngs(synthetic.circles(6, 20), "a")
    args = ["train", "--device", "cpu", "--size", "16", "--pixel-size", "4", "--max-size", "8",
            "--octaves", "2", "--batch-size", "4", "--dataset-pattern", "a/*.png",
            "--steps", "4", "--steps-per-epoch", "2", "--warm-up", "2", "--test-step", "2",
            "--fused-diffusion", "false", "--ema-decay", "0.9", "--log-dir", "logs",
            "--checkpoint-dir", "ckpt", "--checkpoint-every", "2", "--pipeline-stages", "2",
            "--pipeline-microbatches", "2", "--mesh-data", "2", "--log-images-every", "1"]
    assert cli.main(args + ["--epochs", "1"]) == 0
    assert ckpt_lib.all_steps("ckpt") == [2]
    # resumed by a pipeline Runner at step 2; the checkpoint restores in one process too
    assert cli.main(args + ["--epochs", "2"]) == 0
    assert ckpt_lib.all_steps("ckpt") == [2, 4]
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and "epoch 1: loss=" in out
    assert cli.main(["sample", "--device", "cpu", "--checkpoint-dir", "ckpt", "--num", "2",
                     "--out", "s"]) == 0
    assert sorted(os.listdir("s")) == ["sample_0.png", "sample_1.png"]
    one = tiny_test_config(batch_size=4, ema_decay=0.9, warm_up=2)
    state = ckpt_lib.restore("ckpt", trainer.init_state(one, device="cpu"))
    assert state.step == 4


def test_runner_holds_the_pipeline_and_samples_on_stage_0(tmp_path):
    from gan_class_transfer2_tpu_torch.data.pipeline import ArrayDataset
    from gan_class_transfer2_tpu_torch.train.loop import Runner

    cfg = _cfg(batch_size=4, steps=4, warm_up=2, test_step=2, ema_decay=0.9,
               pipeline_microbatches=2, checkpoint_dir=None)
    images = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    runner = Runner(cfg, dataset=ArrayDataset(images, 4, seed=0), log_dir=str(tmp_path),
                    device="cpu")
    try:
        assert runner.mesh is None and runner._pipeline.n_stages == 2
        runner.fit(epochs=1, steps_per_epoch=2)
        assert runner.state.step == 2
        model = runner._eval_model()
        assert model is not runner.state.model  # the EMA's copy
        for p, e in zip(model.parameters(), runner.state.ema_params):
            assert torch.equal(p, e)
        runner.log_sample(0)
    finally:
        runner.close()


def test_bench_ignores_pipeline_stages_as_jax_does():
    """JAX's ``run_benchmark`` times the one-process (mesh) step whatever
    ``pipeline_stages`` says (benchmark.py:148-161); so does the port's."""
    from gan_class_transfer2_tpu_torch.utils.benchmark import run_benchmark

    res = run_benchmark(_cfg(batch_size=2, pipeline_microbatches=2), steps=1, warmup=1,
                        device="cpu")
    assert res.extra["n_chips"] == 1 and np.isfinite(res.extra["final_loss"])
