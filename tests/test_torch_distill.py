"""Port parity of progressive distillation: gan_class_transfer2_tpu_torch's
train/distill.py and ``cli distill`` against gan_class_transfer2_tpu's, on
the same numpy inputs and carried weights, on the CPU.

Tolerances, each with its reason:
  * distill_target, x_to_prediction: 1e-5 of the array's scale — two float32
    teacher forwards (which agree to ~1e-6) chained through the closed form,
    whose denominator √ᾱ'' − r·√ᾱ_t can magnify an error a few times;
  * distill_loss: 1e-5 relative (a float32 mean); the step's loss, whose
    student starts equal to its teacher, also 2·√loss·1e-5 absolute (the
    arrays' 1e-5 agreement through the square of their small difference);
  * one step's update under sgd: 1e-4 of the largest update of each leaf —
    the gradients of two float32 backward passes, summed in other orders —
    plus two ulps of the leaf's largest value (the rounding of p + u);
  * the port's own oracle (a student that predicts the closed-form target,
    sampled at stride 2s, against the teacher's sampler at stride s): the
    JAX oracle test's bounds (test_distill.py:64,80), 1e-4 and 1e-3 under
    the ε parameterizations.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.models import api as japi  # noqa: E402
from gan_class_transfer2_tpu.train import distill as jdistill  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.core import diffusion  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.train import distill, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)


def _setup(seed=0, **overrides):
    """(JAX cfg, port cfg, JAX params as numpy, the port's model from them)."""
    jcfg = jconfig.tiny_test_config(**overrides)
    cfg = Config.from_json(jcfg.to_json())
    params = jax.tree_util.tree_map(
        np.asarray, japi.init_denoiser(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, params, weights.from_jax_params(cfg, params, device="cpu")


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _classes(cfg, b):
    if cfg.num_classes <= 0:
        return None, None
    c = (np.arange(b) % cfg.num_classes).astype(np.int32)
    return jnp.asarray(c), torch.from_numpy(c)


# ----------------------------------------------------------- the target


@pytest.mark.parametrize("stride,overrides", [
    (2, dict()), (4, dict()),
    (2, dict(parameterization="epsilon")), (4, dict(parameterization="epsilon")),
    (2, dict(parameterization="scaled_epsilon", prediction_weighting=True)),
    (4, dict(parameterization="scaled_epsilon")),
    (2, dict(num_classes=3)),
])
def test_distill_target_and_prediction_match_jax(stride, overrides):
    """Every point of the student grid (the terminal ones included, where
    the target is the teacher's last clean estimate) on random latents."""
    jcfg, cfg, params, model = _setup(**overrides)
    grid = distill.student_grid(cfg, stride)
    b = len(grid)
    t = np.asarray(grid, np.float32).reshape(b, 1, 1, 1)
    z = np.random.default_rng(stride).normal(size=(b, cfg.size, cfg.size, 3)).astype(np.float32)
    jc, tc = _classes(cfg, b)
    want = jdistill.distill_target(jcfg, params, jnp.asarray(z), jnp.asarray(t), stride, jc)
    got = distill.distill_target(cfg, model, T(z), T(t), stride, tc)
    _close(got, want)
    _close(distill.x_to_prediction(cfg, got, T(z), T(t)),
           jdistill.x_to_prediction(jcfg, want, jnp.asarray(z), jnp.asarray(t)))


def _jax_draws(jcfg, batch, rng, stride):
    """The (t, ε) that JAX's distill_loss draws from ``rng`` (distill.py:
    147-160), to inject into the port."""
    rng_t, rng_eps = jax.random.split(rng)
    grid = jnp.asarray(jdistill.student_grid(jcfg, stride))
    idx = jax.random.randint(rng_t, (batch.shape[0],), 0, grid.shape[0])
    eps = jax.random.normal(rng_eps, batch.shape, batch.dtype)
    return np.asarray(grid[idx]), np.asarray(eps)


@pytest.mark.parametrize("overrides", [
    dict(), dict(parameterization="epsilon", prediction_weighting=True),
    dict(parameterization="scaled_epsilon"), dict(num_classes=2),
])
def test_distill_loss_matches_jax_on_injected_draws(overrides):
    jcfg, cfg, params, model = _setup(1, **overrides)
    _, _, sparams, student = _setup(2, **overrides)
    x = np.random.default_rng(3).uniform(-1, 1, (3, cfg.size, cfg.size, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    jc, tc = _classes(cfg, 3)
    want = jdistill.distill_loss(jcfg, sparams, params, jnp.asarray(x), rng, 2, class_idx=jc)
    t, eps = _jax_draws(jcfg, jnp.asarray(x), rng, 2)
    got = distill.distill_loss(cfg, student, model, T(x), None, 2, tc,
                               t=torch.from_numpy(t), epsilon=T(eps))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


# ------------------------------------------------------------- the step


@pytest.mark.parametrize("num_classes", [0, 3])
def test_one_distill_step_matches_jax_under_sgd(num_classes):
    """One step of JAX's make_distill_step and of the port's from carried
    params, with JAX's draws injected: the loss, each leaf's update and the
    EMA blend; a conditional checkpoint takes labeled dict batches."""
    jcfg, cfg, params, model = _setup(3, optimizer="sgd", learning_rate=0.05, ema_decay=0.9,
                                      warm_up=0, num_classes=num_classes)
    jopt = jdistill.distill_opt_config(jcfg, 10)
    opt = distill.distill_opt_config(cfg, 10)
    x = np.random.default_rng(5).uniform(-1, 1, (2, cfg.size, cfg.size, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    def tree():  # a fresh device copy: the jitted step donates its state
        return jax.tree_util.tree_map(jnp.array, params)

    jstate = jtrainer.TrainState(jnp.zeros((), jnp.int32), tree(),
                                 jtrainer.make_optimizer(jopt).init(tree()), tree(), None)
    label = np.array([2, 0], np.int32)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(label)} if num_classes else \
        jnp.asarray(x)
    batch = {"image": T(x), "label": torch.from_numpy(label)} if num_classes else T(x)
    jstate, jloss = jdistill.make_distill_step(jopt, 2)(jstate, tree(), jbatch, rng)
    # the step folds its number into the key before the draws (trainer.py:335)
    t, eps = _jax_draws(jcfg, jnp.asarray(x), jax.random.fold_in(rng, 0), 2)

    state = distill.init_student(opt, model)
    before = [p.detach().clone() for p in state.model.parameters()]
    state, loss = distill.make_distill_step(opt, 2)(
        state, model, batch, None, t=torch.from_numpy(t), epsilon=T(eps))
    assert state.step == 1
    # the student starts as its teacher, so its loss is the square of a
    # difference ~1e-2 of either array: their 1e-5 agreement bounds it by
    # 2·√loss·1e-5, not by 1e-5 of the loss
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=2e-5 * np.sqrt(float(jloss)))
    want = weights._jax_state(jax.tree_util.tree_map(np.asarray, jstate.params))
    want_ema = weights._jax_state(jax.tree_util.tree_map(np.asarray, jstate.ema_params))
    names = [n for n, _ in state.model.named_parameters()]
    for name, p, p0, e in zip(names, state.model.parameters(), before, state.ema_params):
        du, dw = (p - p0).detach().numpy(), want[name].numpy() - p0.numpy()
        ulp = float(np.spacing(np.abs(p0.numpy()).max()))  # rounding p + u in float32
        np.testing.assert_allclose(du, dw, rtol=0, atol=1e-4 * np.abs(dw).max() + 2 * ulp)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), rtol=1e-6, atol=1e-7)
    # the teacher is left as it was
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))


def test_distill_step_augments_uint8_batches_on_the_device():
    """A uint8 (device-pool) batch is cropped, flipped and normalised by the
    step before the draws, as the train step does; a round over such
    batches returns a student that moved and leaves the teacher as it was."""
    _, cfg, _, model = _setup(6, learning_rate=1e-2, warm_up=0)
    raw = np.random.default_rng(0).integers(0, 256, (2, 20, 20, 3), dtype=np.uint8)
    seen = []
    aug = trainer.augment_if_uint8

    def spy(c, batch, generator, mesh=None):
        out = aug(c, batch, generator, mesh)
        seen.append((batch.dtype, out.dtype, tuple(out.shape)))
        return out

    before = [p.detach().clone() for p in model.parameters()]
    try:
        trainer.augment_if_uint8 = spy
        student, loss = distill.distill_round(
            cfg, model, iter([torch.from_numpy(raw)] * 2), 2, 2, torch.Generator().manual_seed(0),
            log=lambda _: None)
    finally:
        trainer.augment_if_uint8 = aug
    assert seen == [(torch.uint8, torch.float32, (2, cfg.size, cfg.size, 3))] * 2
    assert np.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    assert any(not torch.equal(a, b) for a, b in zip(student.parameters(), before))


@pytest.mark.parametrize("overrides,steps", [
    (dict(), 10), (dict(grad_accum=4, ema_decay=0.9999, warm_up=500), 2000),
    (dict(ema_decay=0.99, warm_up=3), 40), (dict(ema_decay=0.0, lr_schedule="cosine"), 5),
])
def test_distill_opt_config_matches_jax(overrides, steps):
    jcfg = jconfig.tiny_test_config(**overrides)
    want = json.loads(jdistill.distill_opt_config(jcfg, steps).to_json())
    want.pop("conv_impl")  # the JAX package's conv route: no field in the port
    got = json.loads(distill.distill_opt_config(Config.from_json(jcfg.to_json()),
                                                steps).to_json())
    assert got == want


def test_ema_advances_only_on_applied_distill_steps_under_grad_accum():
    """grad_accum=2: the first micro-step moves neither the student nor its
    EMA; the second applies the mean update and blends the EMA once."""
    _, cfg, _, model = _setup(4, grad_accum=2, ema_decay=0.5, learning_rate=1e-2, warm_up=0)
    state = distill.init_student(cfg, model)
    step = distill.make_distill_step(cfg, 2)
    gen = torch.Generator().manual_seed(0)
    x = [T(np.random.default_rng(i).uniform(-1, 1, (2, 16, 16, 3))) for i in range(2)]
    p0 = [p.detach().clone() for p in state.model.parameters()]
    state, _ = step(state, model, x[0], gen)
    assert state.opt_state.mini_step == 1
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), p0))
    assert all(torch.equal(e, q) for e, q in zip(state.ema_params, p0))
    state, _ = step(state, model, x[1], gen)
    assert state.opt_state.mini_step == 0
    p1 = list(state.model.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(p1, p0))
    for e, q, p in zip(state.ema_params, p0, p1):
        torch.testing.assert_close(e, q * 0.5 + p.detach() * 0.5, rtol=0, atol=0)


# ----------------------------------------------------------- refusals


@pytest.mark.parametrize("overrides,stride", [
    (dict(parameterization="ode"), 2), (dict(), 3), (dict(), 12),
    (dict(loss_scale=128.0), 2), (dict(dynamic_loss_scale=True), 2),
])
def test_validate_refuses_as_jax(overrides, stride):
    jcfg = jconfig.tiny_test_config(**overrides)
    with pytest.raises(ValueError) as want:
        jdistill._validate(jcfg, stride)
    with pytest.raises(ValueError) as got:
        distill.make_distill_step(Config.from_json(jcfg.to_json()), stride)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sample_stride,target", [(1, 3), (2, 1), (2, 6), (1, 16)])
def test_progressive_distill_refuses_unreachable_strides(sample_stride, target):
    jcfg = jconfig.tiny_test_config(sample_stride=sample_stride)
    _, cfg, _, model = _setup(sample_stride=sample_stride)
    with pytest.raises(ValueError) as want:
        jdistill.progressive_distill(jcfg, None, iter(()), target, 1)
    with pytest.raises(ValueError) as got:
        distill.progressive_distill(cfg, model, iter(()), target, 1)
    assert str(got.value) == str(want.value)


def test_distill_round_over_a_mesh_is_refused():
    """Distillation over the ranks of a process group is ported (two gloo
    ranks: tests/test_torch_parallel.py); what is still refused is a mesh
    that is no process-group mesh: a list of device names, or the serving
    mesh of in-process replicas."""
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib

    _, cfg, _, model = _setup()
    for mesh in (["cuda:0", "cuda:1"], mesh_lib.make_mesh(devices=["cpu", "cpu"])):
        with pytest.raises(TypeError, match="ranks of a process group"):
            distill.distill_round(cfg, model, iter(()), 2, 1, torch.Generator(), mesh=mesh)


def test_student_grid_is_the_sampler_schedule():
    jcfg, cfg, _, _ = _setup()
    for stride in (1, 2, 4, 10):
        want = sampler.sample_timesteps(cfg.replace(sample_stride=stride))
        np.testing.assert_array_equal(distill.student_grid(cfg, stride), want)
        np.testing.assert_array_equal(distill.student_grid(cfg, stride),
                                      jdistill.student_grid(jcfg, stride))


# ------------------------------------------------------------ the oracle


@pytest.mark.parametrize("teacher_stride,overrides,tol", [
    (1, dict(), 1e-4), (2, dict(), 1e-4), (1, dict(parameterization="epsilon"), 1e-3),
    (1, dict(num_classes=2), 1e-4),
])
def test_oracle_student_reproduces_the_teacher_sampler(teacher_stride, overrides, tol):
    """A student whose prediction is the closed-form target, sampled at
    stride 2s through the port's sampler algebra, lands where the port's
    teacher sampler lands at stride s."""
    _, cfg, _, model = _setup(5, sample_stride=teacher_stride, **overrides)
    init = T(np.random.default_rng(0).normal(size=(2, cfg.size, cfg.size, 3)))
    _, c = _classes(cfg, 2)
    stride = 2 * teacher_stride
    teacher = sampler.sample(cfg, model, init, c, snapshots=False).images
    x_theta = eps_theta = init
    for t in distill.student_grid(cfg, stride):
        tb = torch.full((2, 1, 1, 1), float(t))
        tf = torch.tensor(float(t))
        fake = diffusion.renoise(cfg, x_theta, eps_theta, tf)
        target = distill.distill_target(cfg, model, fake, tb, stride, c)
        pred = distill.x_to_prediction(cfg, target, fake, tb)
        x_theta, eps_theta = diffusion.step_update(cfg, pred, fake, eps_theta, tf)
    np.testing.assert_allclose(x_theta.numpy(), teacher.numpy(), atol=tol)


# ------------------------------------------------------------ the command


def _write_pngs(tmp_path, name="a", n=6):
    from gan_class_transfer2_tpu_torch.data import synthetic

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        synthetic.save_as_pngs(synthetic.circles(n, 20), name)
    finally:
        os.chdir(cwd)
    return str(tmp_path / name / "*.png")


TINY = ["--device", "cpu", "--size", "16", "--pixel-size", "4", "--max-size", "8",
        "--octaves", "2", "--batch-size", "2"]


def test_cli_distill_round_trip(tmp_path, capsys):
    """train → distill → sample on the CPU: the loss and grid tags, the
    doubled stride in the student's config.json, JAX's printed line, and
    ``sample --checkpoint-dir`` on the student."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib
    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    from gan_class_transfer2_tpu_torch.data import pipeline

    pattern = _write_pngs(tmp_path)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "student")
    assert cli.main(["train", *TINY, "--dataset-pattern", pattern, "--steps", "4", "--test-step", "2",
                     "--steps-per-epoch", "2", "--epochs", "1", "--fused-diffusion", "false",
                     "--ema-decay", "0.9", "--checkpoint-dir", ckpt, "--checkpoint-every", "2",
                     "--log-dir", str(tmp_path / "logs"), "--fid-samples", "2"]) == 0
    capsys.readouterr()
    seen, make = [], pipeline.make_datasets

    def recording(c, files_per_class=None, **kw):
        seen.append(files_per_class)
        return make(c, files_per_class=files_per_class, **kw)

    pipeline.make_datasets = recording
    try:
        assert cli.main(["distill", "--device", "cpu", "--checkpoint-dir", ckpt, "--out", out,
                         "--distill-steps", "2", "--log-dir", str(tmp_path / "dlogs")]) == 0
    finally:
        pipeline.make_datasets = make
    # the fid_samples held-out files stay out of the batches (as training's)
    held = set(pipeline.held_out_split(pattern, 2, seed=0)[1])
    assert len(seen) == 1 and len(seen[0][0]) == 4 and not held & set(seen[0][0])
    printed = capsys.readouterr().out
    assert "wrote distilled student (sample_stride=2, 2 sampler steps vs the teacher's 4)" \
        in printed
    with open(os.path.join(out, "config.json")) as fh:
        assert json.load(fh)["sample_stride"] == 2
    assert ckpt_lib.latest_step(out) == 2
    (events,) = glob.glob(str(tmp_path / "dlogs" / "*" / "*" / "events.out.tfevents.*"))
    tags = {e[1] for e in tb.read_events(events)}
    assert "distill_loss/stride_2" in tags
    assert {"distill/teacher_samples/image/0", "distill/student_samples/image/5"} <= tags
    assert cli.main(["sample", "--device", "cpu", "--checkpoint-dir", out, "--num", "2",
                     "--out", str(tmp_path / "s")]) == 0
    assert sorted(os.listdir(tmp_path / "s")) == ["sample_0.png", "sample_1.png"]
    with pytest.raises(SystemExit, match="needs a trained teacher"):
        cli.main(["distill", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "none"),
                  "--out", out])
