"""Port parity of the training slice: gan_class_transfer2_tpu_torch.train
(trainer), core.schedule's learning-rate schedules, utils.weights' train
state carry and utils.benchmark, against the JAX package on the same numpy
inputs, on the CPU.

Tolerances, each with its reason:
  * golden step replay: the bounds of test_step_parity.py:61-63 (losses rtol
    2e-5, weights atol 2e-5), which the JAX package is held to against the
    same captured TF run;
  * optimizer menu: rtol 1e-6 / atol 1e-8 on parameters of order 1 after 3
    updates — both sides compute each transform in float32 with the same
    expressions; what differs is the order of the sums inside a global norm
    and the last ulp of pow/rsqrt, a few 1e-8 at most;
  * losses: rtol 1e-6 (float32 means over a few thousand terms in different
    orders); the DCT loss 1e-5 (JAX takes the DCT by FFT, the port by a
    matrix product);
  * schedules: rtol 1e-7 (the same float32 expressions; cos may differ by an
    ulp).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.core import schedule as jschedule  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu.utils import benchmark as jbench  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.core import schedule  # noqa: E402
from gan_class_transfer2_tpu_torch.models import unet  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import benchmark, weights  # noqa: E402

from helpers_tf_step import parity_config  # noqa: E402

torch.set_num_threads(1)


def port_config(jcfg) -> Config:
    """The port's Config equal to a JAX Config (same JSON fields)."""
    return Config.from_json(jcfg.to_json())


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- golden


def test_injected_step_replays_the_golden_tf_run():
    """Four injected steps (adam_tf, warmup LR) from the captured TF initial
    weights: losses and final weights equal the TF run's, as the JAX
    package's own golden test requires (test_step_parity.py:79-95)."""
    import os

    data = np.load(os.path.join(os.path.dirname(__file__), "golden", "step_parity.npz"))
    cfg = port_config(parity_config())
    n_init = int(data["n_init"])
    model = weights.import_flat_weights(unet.Denoiser(cfg), [data[f"w_{i:03d}"]
                                                             for i in range(n_init)])
    opt_state = trainer.make_optimizer(cfg).init(list(model.parameters()))
    state = trainer.TrainState(0, model, opt_state, None, None)
    step = trainer.make_injected_train_step(cfg)
    losses = []
    for x, t, eps in zip(data["batches"], data["t_draws"], data["eps_draws"]):
        state, loss = step(state, T(x), torch.from_numpy(t), T(eps))
        losses.append(float(loss))
    assert state.step == 4 and int(state.opt_state[0].count) == 4
    np.testing.assert_allclose(losses, data["losses"], rtol=2e-5, atol=1e-7)
    final = weights.export_flat_weights(state.model)
    for i, got in enumerate(final):
        np.testing.assert_allclose(got, data[f"f_{i:03d}"], atol=2e-5)


# ---------------------------------------------------------- optimizer menu

MENU = [
    dict(optimizer="adam"),
    dict(optimizer="adam_tf"),
    dict(optimizer="adam_fused"),
    dict(optimizer="sgd"),
    dict(optimizer="momentum", nesterov=True),
    dict(optimizer="momentum", nesterov=False),
    dict(optimizer="sign_sgd"),
    dict(optimizer="rmsprop"),
    dict(optimizer="adam_tf", weight_decay=0.05, grad_clip_norm=0.5),
    dict(optimizer="momentum", weight_decay=0.05, grad_clip_norm=100.0),  # clip inactive
    dict(optimizer="adam", grad_accum=2),
    dict(optimizer="adam_tf", grad_accum=2, lr_schedule="cosine", epochs=2, steps_per_epoch=4),
    dict(optimizer="adam_tf", moment_dtype="bfloat16"),
    dict(optimizer="adam_fused", moment_dtype="bfloat16", lr_schedule="inverse_time_decay",
         inverse_time_decay_steps=3),
]


def _menu_case(overrides, n_steps=3):
    base = dict(learning_rate=1e-2, warm_up=2)
    base.update(overrides)
    jcfg = jconfig.tiny_test_config(**base)
    r = np.random.default_rng(0)
    shapes = [(3, 3, 4, 8), (8,), (5,), (4, 4, 8, 6)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(r.normal(size=s) * (k + 1)).astype(np.float32) for s in shapes]
             for k in range(n_steps)]
    return jcfg, port_config(jcfg), params, grads


@pytest.mark.parametrize("overrides", MENU, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_optimizer_menu_matches_optax(overrides):
    """The same grads for 3 steps through JAX's make_optimizer(cfg).update
    and the port's: parameters after each step and the final counts."""
    jcfg, cfg, params, grads = _menu_case(overrides)
    jtx = jtrainer.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jst = jtx.init(jp)
    tx = trainer.make_optimizer(cfg)
    tp = [T(p) for p in params]
    st = tx.init(tp)
    for g in grads:
        upd, jst = jtx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        upd_t, st = tx.update([T(x) for x in g], st, tp)
        trainer.apply_updates(tp, upd_t)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)
               if np.ndim(x) == 0]
    tleaves = []

    def counts(node):
        if isinstance(node, torch.Tensor) and node.ndim == 0:
            tleaves.append(node.numpy())
        elif isinstance(node, int):
            tleaves.append(np.int32(node))
        elif isinstance(node, (tuple, list)):
            for v in node:
                counts(v)

    counts(st)
    np.testing.assert_array_equal(np.asarray(tleaves), np.asarray(jleaves))


def test_clip_only_scales_above_the_norm():
    """optax's clip: below max_norm the grads pass untouched (torch's
    clip_grad_norm_ would still scale by max/(‖g‖+1e-6))."""
    tx = trainer.clip_by_global_norm(10.0)
    g = [T([3.0, 4.0])]
    out, _ = tx.update(g, tx.init(g))
    assert torch.equal(out[0], g[0])
    out, _ = trainer.clip_by_global_norm(2.5).update(g, ())
    np.testing.assert_allclose(out[0].numpy(), [1.5, 2.0], rtol=1e-7)


def test_rmsprop_is_optax_not_torch():
    """decay 0.9 and eps inside the square root: one step from zero state
    gives g·rsqrt(0.1·g² + 1e-8), not torch.optim.RMSprop's
    g/(√(0.01·g²) + 1e-8)."""
    tx = trainer.scale_by_rms()
    g = [T([1e-3, 2.0])]
    out, _ = tx.update(g, tx.init(g))
    want = np.float32([1e-3, 2.0]) / np.sqrt(0.1 * np.float32([1e-3, 2.0]) ** 2 + 1e-8)
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-6)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("loss, rtol", [("mse", 1e-6), ("l1", 1e-6), ("dct", 1e-5),
                                        ("mse_multiscale", 1e-6)])
def test_compute_loss_matches_jax(loss, rtol):
    r = np.random.default_rng(1)
    target = r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    pred = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jcfg = jconfig.tiny_test_config(loss=loss)
    want = float(jtrainer.compute_loss(jcfg, jnp.asarray(target), jnp.asarray(pred)))
    got = float(trainer.compute_loss(port_config(jcfg), T(target), T(pred).bfloat16()
                                     if loss == "mse" else T(pred)))
    if loss == "mse":  # a bfloat16 prediction: the loss is still taken in float32
        want = float(jtrainer.compute_loss(
            jcfg, jnp.asarray(target), jnp.asarray(pred).astype(jnp.bfloat16)))
    np.testing.assert_allclose(got, want, rtol=rtol)


# -------------------------------------------------------------- schedules


@pytest.mark.parametrize("overrides", [
    dict(lr_schedule="warmup"),
    dict(lr_schedule="inverse_time_decay", inverse_time_decay_steps=3),
    dict(lr_schedule="constant"),
    dict(lr_schedule="cosine", epochs=2, steps_per_epoch=7),
    dict(lr_schedule="cosine", epochs=2, steps_per_epoch=7, grad_accum=2),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_lr_schedules_match_jax(overrides):
    jcfg = jconfig.tiny_test_config(learning_rate=3e-4, warm_up=5, **overrides)
    jsched, sched = jschedule.make_lr_schedule(jcfg), schedule.make_lr_schedule(port_config(jcfg))
    for count in range(2 * jcfg.warm_up + 1):
        want = np.asarray(jsched(jnp.asarray(count, jnp.int32)))
        got = sched(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_unknown_lr_schedule_raises():
    with pytest.raises(ValueError, match="lr_schedule"):
        schedule.make_lr_schedule(tiny_test_config(lr_schedule="banana"))


# ------------------------------------------------------------- EMA gating


def _tiny_state(cfg):
    return trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")


def _batch(seed=0, b=2):
    return T(np.random.default_rng(seed).uniform(-1, 1, (b, 16, 16, 3)))


def test_ema_advances_only_on_applied_steps_under_grad_accum():
    """grad_accum=2: the first micro-step moves neither params nor EMA, the
    second applies the mean grad and blends the EMA once; the optimizer's
    inner count advances once (trainer.py:459-460)."""
    cfg = tiny_test_config(grad_accum=2, ema_decay=0.5, learning_rate=1e-2, warm_up=0)
    state = _tiny_state(cfg)
    step = trainer.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    state, _ = step(state, _batch(0), gen)
    assert state.opt_state.mini_step == 1
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), p0))
    assert all(torch.equal(e, q) for e, q in zip(state.ema_params, p0))
    state, _ = step(state, _batch(1), gen)
    assert state.opt_state.mini_step == 0 and state.opt_state.gradient_step == 1
    assert int(state.opt_state.inner_opt_state[0][0].count) == 1
    p1 = list(state.model.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(p1, p0))
    for e, q, p in zip(state.ema_params, p0, p1):
        torch.testing.assert_close(e, q * 0.5 + p.detach() * 0.5, rtol=0, atol=0)


@pytest.mark.parametrize("applied", [True, False])
def test_ema_update_matches_jax(applied):
    """The blend and its gate against the JAX function on the same numpy
    trees (grad_accum=2 with the window closed or open, and under dynamic
    loss scaling with a finite or non-finite step)."""
    r = np.random.default_rng(2)
    ema, params = r.normal(size=(2, 4, 3)).astype(np.float32)
    jcfg = jconfig.tiny_test_config(grad_accum=2, ema_decay=0.9)
    mini = 0 if applied else 1
    jopt = optax.MultiStepsState(jnp.asarray(mini), jnp.asarray(0), (), {})
    want = jtrainer.ema_update(jcfg, [jnp.asarray(ema)], [jnp.asarray(params)], jopt)
    topt = trainer.MultiStepsState(mini, 0, (), [])
    got = trainer.ema_update(port_config(jcfg), [T(ema)], [T(params)], topt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-7)
    dcfg = jconfig.tiny_test_config(dynamic_loss_scale=True, ema_decay=0.9)
    want = jtrainer.ema_update(dcfg, [jnp.asarray(ema)], [jnp.asarray(params)], None,
                               finite=jnp.asarray(applied))
    got = trainer.ema_update(port_config(dcfg), [T(ema)], [T(params)], None,
                             finite=torch.tensor(applied))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-7)


def test_dynamic_loss_scale_skips_non_finite_steps():
    """A non-finite gradient leaves params, optimizer state and EMA as they
    were and halves the scale; a finite step then updates and, with a growth
    interval of 1, doubles it (trainer.py:398-420)."""
    cfg = tiny_test_config(dynamic_loss_scale=True, loss_scale=8.0, ema_decay=0.5,
                           loss_scale_growth_interval=1, learning_rate=1e-2, warm_up=0,
                           optimizer="adam_tf")
    state = _tiny_state(cfg)
    step = trainer.make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    bad = _batch(0)
    bad[0, 0, 0, 0] = float("nan")
    state, loss = step(state, bad, gen)
    assert not torch.isfinite(loss)
    assert float(state.scale_state.scale) == 4.0 and int(state.scale_state.good_steps) == 0
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), p0))
    assert all(torch.equal(e, q) for e, q in zip(state.ema_params, p0))
    assert int(state.opt_state[0].count) == 0 and int(state.opt_state[1].count) == 0
    assert all(float(m.abs().max()) == 0 for m in state.opt_state[0].mu)
    state, loss = step(state, _batch(1), gen)
    assert torch.isfinite(loss)
    assert float(state.scale_state.scale) == 8.0 and int(state.scale_state.good_steps) == 0
    assert int(state.opt_state[0].count) == 1
    assert any(not torch.equal(p, q) for p, q in zip(state.model.parameters(), p0))


def test_static_loss_scale_returns_the_unscaled_loss():
    cfg = tiny_test_config(loss_scale=1024.0)
    plain = tiny_test_config()
    s1, s2 = _tiny_state(cfg), _tiny_state(plain)
    _, l1 = trainer.make_train_step(cfg)(s1, _batch(), torch.Generator().manual_seed(3))
    _, l2 = trainer.make_train_step(plain)(s2, _batch(), torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_uint8_batches_name_the_missing_augment_module(monkeypatch):
    """uint8 batches, once refused for want of data/device_augment.py, now go
    through it, where trainer.py:331-334 puts it: ``augment_batch`` runs once,
    before the differentiated region (``loss_and_grads``) and so before t and
    the seed are drawn, and the loss sees exactly its float32 output.
    (Equality with the float step: test_torch_device_augment.py.)"""
    from gan_class_transfer2_tpu_torch.data import device_augment

    cfg = tiny_test_config()
    raw = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 20, 20, 3),
                                                             dtype=np.uint8))
    calls, augmented = [], []
    augment, differentiate = device_augment.augment_batch, trainer.loss_and_grads

    def spy_augment(r, g, size, mesh=None):
        calls.append("augment")
        augmented.append(augment(r, g, size, mesh))
        return augmented[-1]

    def spy_differentiate(c, m, batch, g, *a, **k):
        calls.append("loss_and_grads")
        assert batch is augmented[-1] and batch.dtype == torch.float32
        return differentiate(c, m, batch, g, *a, **k)

    monkeypatch.setattr(device_augment, "augment_batch", spy_augment)
    monkeypatch.setattr(trainer, "loss_and_grads", spy_differentiate)
    _, loss = trainer.make_train_step(cfg)(_tiny_state(cfg), raw, torch.Generator().manual_seed(4))
    assert calls == ["augment", "loss_and_grads"]
    assert augmented[0].shape == (2, cfg.size, cfg.size, 3) and torch.isfinite(loss)


@pytest.mark.parametrize("field, value, match", [
    ("zero1", True, "zero1"), ("mesh_data", 2, "mesh_data"), ("mesh_model", 2, "mesh_model"),
    ("mesh_slice", 2, "mesh_slice"), ("pipeline_stages", 2, "pipeline"),
])
def test_config_refuses_unported_parallelism(field, value, match):
    """Every parallel axis is ported now: the config takes each. zero1 and
    the mesh axes are held by make_mesh to the world size (1 here, JAX's
    "needs N devices" error), and zero1 gates B2 off; pipeline stages build
    a PipelineTrainer (parallel/pipeline.py), which refuses what JAX's
    refuses, by JAX's message (ZeRO-1 here)."""
    cfg = tiny_test_config(**{field: value})
    if field == "pipeline_stages":
        from gan_class_transfer2_tpu_torch.parallel import pipeline

        assert pipeline.PipelineTrainer(cfg, device="cpu").plan == ((0, 1), (1, 2))
        with pytest.raises(ValueError, match="already partitions optimizer state by stage"):
            pipeline.PipelineTrainer(cfg.replace(zero1=True), device="cpu")
        return
    assert getattr(cfg, field) == value
    if field == "zero1":
        from gan_class_transfer2_tpu_torch.ops import adam_kernel

        assert not adam_kernel.fused_adam_ok(cfg.replace(optimizer="adam_fused"))
        return
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_lib.make_mesh(cfg, device="cpu")
    if field == "mesh_data":
        with pytest.raises(ValueError, match=match):
            mesh_lib.make_mesh(cfg, device="cpu")


def test_unfused_step_matches_the_jax_step_on_injected_draws():
    """The port's loss and grads equal JAX's value_and_grad of
    diffusion_loss for the same weights, t and ε (epsilon parameterization,
    bfloat16 compute: the loss and grads stay float32)."""
    jcfg = jconfig.tiny_test_config(parameterization="epsilon", compute_dtype="bfloat16",
                                    prediction_weighting=True)
    cfg = port_config(jcfg)
    from gan_class_transfer2_tpu.models import unet as junet

    params = jax.tree_util.tree_map(np.asarray, junet.init_unet(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(4)
    x = r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 9], np.int32)
    eps = r.normal(size=x.shape).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: jtrainer.diffusion_loss(
        jcfg, p, jnp.asarray(x), jax.random.PRNGKey(0), t_int=t, epsilon_in=eps))(params)
    model = weights.from_jax_params(cfg, params, device="cpu")
    loss, grads = trainer.loss_and_grads(cfg, model, T(x), None, t_int=torch.from_numpy(t),
                                         epsilon_in=T(eps))
    # bfloat16 convs round at other places in the two frameworks: 2e-2 of
    # the largest grad of each leaf, 1e-2 on the loss
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)
    want = weights._jax_state(jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2 * np.abs(w).max() + 1e-12)


# ---------------------------------------------------------- state carry


@pytest.mark.parametrize("overrides", [
    dict(optimizer="adam_tf", ema_decay=0.9, dynamic_loss_scale=True),
    dict(optimizer="adam", grad_accum=2),
    dict(optimizer="momentum", weight_decay=0.1, grad_clip_norm=1.0),
    dict(optimizer="rmsprop"),
    dict(optimizer="adam_fused", moment_dtype="bfloat16", ema_decay=0.5),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_jax_train_state_carries_into_the_port_and_back(overrides):
    """A JAX TrainState, moved off its init by two optimizer updates, goes
    into the port and back unchanged (class and field names, counts,
    moments, EMA, scale); one more update on each side then agrees."""
    jcfg = jconfig.tiny_test_config(learning_rate=1e-2, warm_up=1, **overrides)
    cfg = port_config(jcfg)
    jstate = jtrainer.init_state(jcfg, jax.random.PRNGKey(1))
    tx = jtrainer.make_optimizer(jcfg)
    r = np.random.default_rng(5)
    params, opt = jstate.params, jstate.opt_state
    grads = []
    for _ in range(3):
        grads.append(jax.tree_util.tree_map(
            lambda p: jnp.asarray(r.normal(size=p.shape).astype(np.float32)), params))
    for g in grads[:2]:
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    jstate = jstate._replace(step=jnp.asarray(2, jnp.int32), params=params, opt_state=opt)
    npstate = jax.tree_util.tree_map(np.asarray, jstate)
    state = weights.from_jax_train_state(cfg, npstate, device="cpu")
    back = weights.to_jax_train_state(state)

    def same(a, b, path="state"):
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            assert type(a).__name__ == type(b).__name__ and a._fields == b._fields, path
            for f, x, y in zip(a._fields, a, b):
                same(x, y, f"{path}.{f}")
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif a is None:
            assert b is None, path
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a, np.float32)
                                          if np.asarray(a).dtype == jnp.bfloat16
                                          else np.asarray(a), err_msg=path)

    same(npstate._asdict(), back)
    # and both continue alike from the carried state
    upd, opt = tx.update(grads[2], opt, params)
    jp = optax.apply_updates(params, upd)
    tparams = list(state.model.parameters())
    tg = weights._param_list(state.model, jax.tree_util.tree_map(np.asarray, grads[2]))
    tupd, _ = trainer.make_optimizer(cfg).update(tg, state.opt_state, tparams)
    trainer.apply_updates(tparams, tupd)
    got = weights.to_jax_params(state.model)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ benchmark


@pytest.mark.parametrize("overrides", [dict(), dict(block_depth=1, skip_mode="residual")])
def test_model_flops_per_image_equals_jax(overrides):
    for jcfg in (jconfig.Config(**overrides), jconfig.tiny_test_config(**overrides)):
        got = benchmark.model_flops_per_image(port_config(jcfg))
        assert isinstance(got, int) and got == jbench.model_flops_per_image(jcfg)


def test_cli_bench_prints_the_jax_keys(capsys):
    """``bench --device cpu`` at the tiny shapes: one JSON line with every
    key of the JAX bench but its conv route, which the port has not; no MFU
    off the card."""
    rc = cli.main(["bench", "--device", "cpu", "--size", "16", "--pixel-size", "4",
                   "--max-size", "8", "--octaves", "2", "--steps", "10", "--batch-size", "2",
                   "--bench-steps", "2", "--optimizer", "adam_fused",
                   "--fused-diffusion", "true", "--learning-rate", "0.001"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    want = jbench.BenchResult("m", 1.0, "u", 0.0, {k: 0 for k in (
        "images_per_sec", "step_ms", "batch_size", "size", "compute_dtype",
        "n_chips", "backend", "model_tflops_per_chip", "train_flops_per_image", "mfu",
        "mfu_peak_tflops", "device_kind")})
    assert set(json.loads(want.to_json())) <= set(out) and "conv_impl" not in out
    assert out["metric"] == "train_images_per_sec_per_chip" and out["backend"] == "cpu"
    assert out["mfu"] is None and out["device_kind"] == "cpu"
    assert out["train_flops_per_image"] == 3 * jbench.model_flops_per_image(
        jconfig.tiny_test_config(steps=10))
    assert np.isfinite(out["final_loss"]) and out["images_per_sec"] > 0
