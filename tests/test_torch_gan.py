"""Port parity of train/gan.py: the cycle-GAN losses, R1, one whole
``gan_train_step`` from a JAX ``GANState`` carried into the port, the state
carry itself, transfer, and ``cli profile --model gan`` on the CPU, against
gan_class_transfer2_tpu.train.gan on the same numpy inputs.

Tolerances, each with its reason:
  * losses: 1e-5 relative (IEEE float32 on both sides; convs and
    reductions sum in other orders);
  * params, optimizer states and EMAs after a step under ``sgd`` (the update
    is linear in the gradient): the change made by the step within 1e-5 of
    the largest change of that net or state;
  * under ``adam``: the diffusion step tests' rule, the change within
    1e-3·lr for all but 1e-4 of the elements (Adam divides by √ν, so an
    element whose gradient is ~0 may move by up to lr on either side for a
    correct gradient);
  * R1 and its gradient at the 128-channel config that reaches B4: 1e-4 of
    the largest value (a double backward through 2048- and 4096-term sums).
"""

import copy
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.models import discriminator as jdisc  # noqa: E402
from gan_class_transfer2_tpu.train import gan as jgan  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import discriminator as disc  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)

TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2"]
JAX_PROFILE_KEYS = {"command", "model", "steps", "wall_ms_per_step", "images_per_sec",
                    "trace_dir", "device_rows", "note"}


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfgs(**overrides):
    """A tiny GAN config in both packages (the port's from the JAX JSON)."""
    base = dict(g_norm="instance", d_norm="instance", learning_rate=0.1,
                lr_schedule="constant", ema_decay=0.9, donate_state=False)
    base.update(overrides)
    jcfg = jconfig.tiny_test_config(**base)
    return jcfg, Config.from_json(jcfg.to_json())


def _batches(cfg, seed=0):
    r = np.random.default_rng(seed)
    shape = (cfg.batch_size, cfg.size, cfg.size, 3)
    return (r.uniform(-1, 1, shape).astype(np.float32),
            r.uniform(-1, 1, shape).astype(np.float32))


def _perturb(tree, seed):
    """Random biases and norm γ/β, so that a misplaced norm or activation
    shows in the step."""
    r = np.random.default_rng(seed)

    def leaf(path, p):
        p = np.asarray(p)
        key = getattr(path[-1], "key", None)
        if key in ("bias", "beta"):
            return (r.normal(size=p.shape) * 0.1).astype(np.float32)
        if key == "gamma":
            return r.normal(1.0, 0.3, p.shape).astype(np.float32)
        return p

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_state(jcfg, moved=True):
    """A JAX GANState with numpy leaves: perturbed init, then (``moved``)
    one JAX step, so optimizer moments and EMAs are off their init."""
    st = jgan.init_gan_state(jcfg, jax.random.PRNGKey(0))
    st = st._replace(g_ab=_perturb(st.g_ab, 1), g_ba=_perturb(st.g_ba, 2),
                     d_a=_perturb(st.d_a, 3), d_b=_perturb(st.d_b, 4))
    if moved:
        a, b = _batches(jcfg, seed=9)
        st, _ = jgan.make_gan_train_step(jcfg)(st, jnp.asarray(a), jnp.asarray(b),
                                               jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray, st)


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _named(tree):
    """A param tree as ``{state_dict name: float64 array}``."""
    return {k: v.double().numpy() for k, v in weights._jax_state(tree).items()}


def _feeds_a_norm(cfg, name):
    """Whether the leaf ``name`` is a conv bias right before a norm."""
    if re.fullmatch(r"octaves\.\d+\.(down|up)\.bias", name):
        return cfg.g_norm != "none"
    if re.fullmatch(r"convs\.[1-9]\d*\.bias", name):  # D normalises every layer but the first
        return cfg.d_norm != "none"
    return False


def _adam_state(node):
    if type(node).__name__ == "ScaleByAdamState":
        return node
    if isinstance(node, tuple):
        for v in node:
            found = _adam_state(v)
            if found is not None:
                return found
    return None


def _close_state(a, b, path):
    """Optimizer state ``a`` (port, from to_jax_gan_state) against ``b``
    (JAX): scalars equal; each param tree (or dict of trees) within 1e-5 of
    its largest leaf value."""
    if isinstance(b, dict):
        xs, ys = _leaves(a), _leaves(b)
        assert len(xs) == len(ys), path
        scale = max((np.abs(y).max() for y in ys if y.size), default=0.0)
        for x, y in zip(xs, ys):
            assert np.abs(x - y).max() <= 1e-5 * scale, path
    elif isinstance(b, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_state(x, y, f"{path}[{i}]")
    elif b is None:
        assert a is None, path
    else:
        assert np.asarray(a) == np.asarray(b), path


def _same(a, b, path="state"):
    """Port-side (``a``, from to_jax_gan_state) equals JAX-side ``b``
    exactly: NamedTuples by class and field names, dicts by keys."""
    if isinstance(b, tuple) and hasattr(b, "_fields"):
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields, path
        for f, x, y in zip(b._fields, a, b):
            _same(x, y, f"{path}.{f}")
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif b is None:
        assert a is None, path
    else:
        want = np.asarray(b)
        want = want.astype(np.float32) if want.dtype == jnp.bfloat16 else want
        np.testing.assert_array_equal(np.asarray(a), want, err_msg=path)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("gan_loss", ["nonsaturating", "lsgan", "hinge"])
def test_adversarial_loss_matches_jax(gan_loss):
    jcfg, cfg = _cfgs(gan_loss=gan_loss)
    logits = np.random.default_rng(0).normal(0, 3, (4, 2, 2, 1)).astype(np.float32)
    for is_real in (True, False):
        for for_g in (True, False):
            got = gan.adversarial_loss(cfg, T(logits).bfloat16(), is_real, for_g)
            assert got.dtype == torch.float32
            bf = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
            want = float(jgan.adversarial_loss(jcfg, jnp.asarray(bf), is_real, for_g))
            np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=(is_real, for_g))
    with pytest.raises(ValueError, match="gan_loss"):
        gan.adversarial_loss(cfg.replace(gan_loss="wgan"), T(logits), True, True)


def test_annealed_weight_matches_jax():
    jcfg, cfg = _cfgs()
    w = gan.annealed_weight(cfg, 10.0, -1.0, 3)
    assert type(w) is float and w == 10.0  # off: the Python float, as in JAX
    jcfg, cfg = _cfgs(loss_anneal_steps=4, cycle_weight_final=2.0)
    for step in (0, 1, 3, 4, 9):
        want = float(jgan.annealed_weight(jcfg, 10.0, 2.0, jnp.asarray(step)))
        got = gan.annealed_weight(cfg, 10.0, 2.0, step)
        np.testing.assert_allclose(float(got), want, rtol=1e-7)
    assert gan.annealed_weight(cfg, 0.5, -1.0, 2) == 0.5


def test_l1_matches_jax():
    r = np.random.default_rng(1)
    a, b = r.normal(size=(2, 4, 4, 3)).astype(np.float32), r.normal(size=(2, 4, 4, 3))
    np.testing.assert_allclose(float(gan._l1(T(a), T(b))),
                               float(jgan._l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# --------------------------------------------------------------------- R1


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(size=32, d_pixel_size=128, max_size=256, d_octaves=2),
], ids=["tiny", "b4-reaching"])
def test_r1_penalty_and_its_gradient_match_jax(overrides):
    """R1 through a normalised discriminator, and its gradient with respect
    to D's params: a double backward through the instance norm's backward
    (recomputed statistics) and, at the 128-channel config, through B4's
    backward (``torch.nn.grad`` convs, differentiable again)."""
    jcfg, cfg = _cfgs(**overrides)
    params = _perturb(jdisc.init_discriminator(jax.random.PRNGKey(0), jcfg), 5)
    real = np.random.default_rng(2).uniform(-1, 1, (2, cfg.size, cfg.size, 3)).astype(np.float32)
    jc = jcfg.replace(conv_impl="lax")
    want, want_g = jax.value_and_grad(lambda p: jgan.r1_penalty(jc, p, jnp.asarray(real)))(params)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    pen = gan.r1_penalty(cfg, model, T(real))
    # the head's bias does not reach ∇ₓD: its gradient is 0, as JAX's is
    grads = torch.autograd.grad(pen, list(model.parameters()), materialize_grads=True)
    np.testing.assert_allclose(float(pen.detach()), float(want), rtol=1e-4)
    # relative to the largest gradient of D: the biases before a norm have
    # a gradient that is 0 in exact arithmetic, rounding noise on both sides
    flat = _named(want_g)
    top = max(np.abs(w).max() for w in flat.values())
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), flat[name], atol=1e-4 * top, err_msg=name)


# ------------------------------------------------------------------- step


STEP_CASES = [
    dict(optimizer="sgd"),
    dict(optimizer="adam"),
    dict(optimizer="sgd", loss_anneal_steps=4, cycle_weight_final=2.0, identity_weight_final=0.0),
    dict(optimizer="sgd", r1_weight=1.0, gan_loss="lsgan", d_learning_rate=0.05),
    dict(optimizer="sgd", gan_loss="hinge", reconstruction_weight=1.0, identity_weight=0.0,
         g_norm="batch", patch_discriminator=False),
]


@pytest.mark.parametrize("overrides", STEP_CASES,
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_gan_step_from_a_carried_jax_state_matches_jax(overrides):
    jcfg, cfg = _cfgs(**overrides)
    jst = _jax_state(jcfg)
    a, b = _batches(jcfg)
    jnew, jm = jgan.make_gan_train_step(jcfg)(
        jax.tree_util.tree_map(jnp.asarray, jst), jnp.asarray(a), jnp.asarray(b),
        jax.random.PRNGKey(7))
    jnew = jax.tree_util.tree_map(np.asarray, jnew)

    state = weights.from_jax_gan_state(cfg, jst, device="cpu")
    new, m = gan.make_gan_train_step(cfg)(state, T(a), T(b), torch.Generator().manual_seed(0))
    back = weights.to_jax_gan_state(new)

    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert new.step == int(jnew.step) == 2
    for p in gan.g_params(new) + gan.d_params(new):
        assert p.grad is None  # gradients by autograd.grad only, never .backward()

    lr = cfg.learning_rate
    for name in ("g_ab", "g_ba", "d_a", "d_b", "ema_g_ab", "ema_g_ba"):
        before = _named(getattr(jst, name))
        got = {k: v - before[k] for k, v in _named(back[name]).items()}
        want = {k: v - before[k] for k, v in _named(getattr(jnew, name)).items()}
        assert sorted(got) == sorted(want), name
        largest = max(np.abs(w).max() for w in want.values())
        assert largest > 0, name
        for k in want:
            diff = np.abs(got[k] - want[k])
            if cfg.optimizer == "sgd":
                assert diff.max() <= 1e-5 * largest, (name, k, diff.max(), largest)
            elif not _feeds_a_norm(cfg, k):
                assert (diff > 1e-3 * lr).mean() <= 1e-4, (name, k, diff.max(), lr)
    if cfg.optimizer == "adam":
        # A conv bias right before a norm has a gradient that is 0 in exact
        # arithmetic (the norm subtracts the channel mean): both packages
        # give rounding noise there, which Adam scales up to ±lr, so its
        # update is not compared. The first moments show the gradient is
        # noise on both sides.
        for net, mu in (("ab", jnew.g_opt), ("a", jnew.d_opt), ("ab", back["g_opt"]),
                        ("a", back["d_opt"])):
            moments = _named(_adam_state(mu).mu[net])
            top = max(np.abs(v).max() for v in moments.values())
            noise = [k for k in moments if _feeds_a_norm(cfg, k)]
            assert noise and all(np.abs(moments[k]).max() <= 1e-6 * top for k in noise)

    # optimizer states after the step: counts exactly; moments within 1e-5
    # of the largest moment of the same tree
    for name in ("g_opt", "d_opt"):
        _close_state(back[name], getattr(jnew, name), name)


def test_step_holds_d_constant_for_g_and_updates_after_both_gradients():
    """With the generator's learning rate 0 nothing of G moves, and D's
    update equals JAX's: D's gradient saw the pre-step G (fakes) and G's
    step left no gradient in D (no ``.grad``, no update from the G loss)."""
    jcfg, cfg = _cfgs(optimizer="sgd", learning_rate=0.0, d_learning_rate=0.1)
    jst = _jax_state(jcfg, moved=False)
    a, b = _batches(jcfg, seed=3)
    jnew, _ = jgan.make_gan_train_step(jcfg)(jax.tree_util.tree_map(jnp.asarray, jst),
                                             jnp.asarray(a), jnp.asarray(b),
                                             jax.random.PRNGKey(0))
    state = weights.from_jax_gan_state(cfg, jst, device="cpu")
    g_before = [p.detach().clone() for p in gan.g_params(state)]
    new, _ = gan.make_gan_train_step(cfg)(state, T(a), T(b), torch.Generator().manual_seed(0))
    for p, q in zip(gan.g_params(new), g_before):
        assert torch.equal(p, q)
    back = weights.to_jax_gan_state(new)
    for name in ("d_a", "d_b"):
        got = [x - y for x, y in zip(_leaves(back[name]), _leaves(getattr(jst, name)))]
        want = [x - y for x, y in zip(_leaves(getattr(jnew, name)),
                                      _leaves(getattr(jst, name)))]
        largest = max(np.abs(w).max() for w in want)
        assert largest > 0
        for x, y in zip(got, want):
            assert np.abs(x - y).max() <= 1e-5 * largest, name


def test_diffaug_draws_are_fresh_on_consecutive_steps(monkeypatch):
    """The JAX step folds its key with the step number so that the
    augmentation draws change every step (gan.py:146-148); the port's
    generator advances with each draw. Two consecutive steps from the same
    state and batches augment differently; a generator seeded alike
    reproduces the first step's draws."""
    jcfg, cfg = _cfgs(diffaug="color,translation,cutout", optimizer="sgd")
    state = weights.from_jax_gan_state(cfg, _jax_state(jcfg, moved=False), device="cpu")
    a, b = (T(x) for x in _batches(cfg))
    seen = []
    augment = gan.diffaug.augment

    def record(cfg_, generator, x, mesh=None):
        y = augment(cfg_, generator, x, mesh)
        seen.append(y.detach().clone())
        return y

    monkeypatch.setattr(gan.diffaug, "augment", record)
    step = gan.make_gan_train_step(cfg)
    gen = torch.Generator().manual_seed(11)
    step(copy.deepcopy(state), a, b, gen)
    step(copy.deepcopy(state), a, b, gen)
    assert len(seen) == 12  # 2 in the G loss, 4 in the D loss, per step
    first, second = seen[:6], seen[6:]
    assert all(not torch.equal(x, y) for x, y in zip(first, second))
    seen.clear()
    step(copy.deepcopy(state), a, b, torch.Generator().manual_seed(11))
    assert all(torch.equal(x, y) for x, y in zip(seen, first))


def test_uint8_batches_name_the_missing_augment_module(monkeypatch):
    """uint8 batches, once refused for want of data/device_augment.py, now go
    through it (gan.py:151-156): each of the two batches is augmented once,
    with its own draws, and the generators see exactly those float32
    outputs. (Equality with the float step: test_torch_device_augment.py.)"""
    from gan_class_transfer2_tpu_torch.data import device_augment

    jcfg, cfg = _cfgs()
    state = gan.init_gan_state(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 24, 24, 3),
                                                           dtype=np.uint8))
    seen, inputs = [], []
    augment = device_augment.augment_batch
    generate = gan._generate
    monkeypatch.setattr(device_augment, "augment_batch",
                        lambda raw, g, size, mesh=None: seen.append(augment(raw, g, size, mesh))
                        or seen[-1])
    monkeypatch.setattr(gan, "_generate", lambda c, m, b: inputs.append(b) or generate(c, m, b))
    _, metrics = gan.make_gan_train_step(cfg)(state, x, x, torch.Generator().manual_seed(0))
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])  # own draws, same pixels
    assert all(t.dtype == torch.float32 and t.shape == (2, 16, 16, 3) for t in inputs)
    assert torch.equal(inputs[0], seen[0]) and torch.equal(inputs[1], seen[1])
    assert all(torch.isfinite(v) for v in metrics.values())


# ------------------------------------------------------------ state carry


@pytest.mark.parametrize("overrides", [
    dict(optimizer="adam"),
    dict(optimizer="adam_tf", moment_dtype="bfloat16", ema_decay=0.0),
    dict(optimizer="momentum", grad_accum=2, d_norm="batch"),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_jax_gan_state_carries_into_the_port_and_back(overrides):
    jcfg, cfg = _cfgs(**overrides)
    jst = _jax_state(jcfg)
    state = weights.from_jax_gan_state(cfg, jst, device="cpu")
    assert isinstance(state, gan.GANState) and state.step == 1
    assert (state.ema_g_ab is None) == (cfg.ema_decay == 0)
    _same(weights.to_jax_gan_state(state), jst._asdict())


def test_init_gan_state_builds_four_nets_their_optimizers_and_emas():
    jcfg, cfg = _cfgs(optimizer="adam", d_learning_rate=0.5)
    state = gan.init_gan_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    jst = jax.eval_shape(lambda k: jgan.init_gan_state(jcfg, k), jax.random.PRNGKey(0))
    back = weights.to_jax_gan_state(state)
    for name in ("g_ab", "g_ba", "d_a", "d_b", "g_opt", "d_opt", "ema_g_ab", "ema_g_ba"):
        shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(back[name])]
        assert shapes == [tuple(x.shape) for x in jax.tree_util.tree_leaves(getattr(jst, name))]
    for e, p in zip(state.ema_g_ab.parameters(), state.g_ab.parameters()):
        assert torch.equal(e, p) and e is not p and not e.requires_grad
    assert not torch.equal(state.g_ab.head.kernel, state.g_ba.head.kernel)
    # D's optimizer takes d_learning_rate
    p, g = [torch.zeros(3)], [torch.ones(3)]
    d_opt = gan._d_optimizer(cfg.replace(optimizer="sgd"))
    upd, _ = d_opt.update(g, d_opt.init(p), p)
    np.testing.assert_allclose(upd[0].numpy(), -0.5)


# ---------------------------------------------------------------- transfer


def test_transfer_matches_jax_and_selects_the_generator():
    jcfg, cfg = _cfgs()
    jst = _jax_state(jcfg)
    state = weights.from_jax_gan_state(cfg, jst, device="cpu")
    x = _batches(jcfg, seed=4)[0]
    jtree = jax.tree_util.tree_map(jnp.asarray, jst)
    for direction in ("ab", "ba"):
        for use_ema in (True, False):
            want = np.asarray(jgan.transfer(jcfg, jtree, jnp.asarray(x), direction, use_ema))
            with torch.inference_mode():
                got = gan.transfer(cfg, state, T(x), direction, use_ema)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    fn = gan.make_transfer_fn(cfg)
    assert torch.equal(fn(gan.select_generator(state, "ab"), T(x)),
                       gan.transfer(cfg, state, T(x), "ab").detach())
    with pytest.raises(ValueError, match="direction"):
        gan.select_generator(state, "AB")
    # on a mesh of one rank the transfer is the same function
    # (tests/test_torch_parallel.py splits it over two ranks)
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib

    one = gan.make_transfer_fn(cfg, mesh=mesh_lib.make_mesh(device="cpu"))
    assert torch.equal(one(gan.select_generator(state, "ab"), T(x)), fn(
        gan.select_generator(state, "ab"), T(x)))


# --------------------------------------------------------------------- cli


@pytest.mark.parametrize("model", ["gan", "diffusion"])
def test_cli_profile_prints_the_jax_summary_keys(model, tmp_path, capsys):
    args = ["profile", "--device", "cpu", "--model", model, *TINY, "--batch-size", "2",
            "--profile-steps", "1", "--trace-dir", str(tmp_path / "trace"), "--steps", "10"]
    if model == "gan":
        args += ["--g-norm", "instance", "--d-norm", "instance"]
    assert cli.main(args) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert JAX_PROFILE_KEYS <= set(out)
    assert out["command"] == "profile" and out["model"] == model and out["steps"] == 1
    assert out["device_rows"] == 0 and out["device"] == "cpu"  # no CUDA kernels on the CPU
    assert (tmp_path / "trace" / "trace.json").exists()
    keys = {"g_loss", "d_loss", "adversarial", "cycle", "identity"} if model == "gan" else {"loss"}
    assert set(out["final"]) == keys and all(np.isfinite(v) for v in out["final"].values())


def test_cli_profile_cgan_names_the_missing_module():
    """The conditional GAN is ported; without --num-classes it names the
    missing setting (tests/test_torch_conditional_gan.py profiles it)."""
    with pytest.raises(ValueError, match="num_classes >= 2"):
        cli.main(["profile", "--device", "cpu", "--model", "cgan", *TINY])


def test_optax_sgd_is_the_step_s_update_rule():
    """The step applies optax-form updates (gan.py:263-266): under sgd the
    update of every leaf is −lr·g, as optax.sgd gives."""
    jcfg, cfg = _cfgs(optimizer="sgd", learning_rate=0.25)
    p = [np.ones(3, np.float32)]
    g = [np.arange(3, dtype=np.float32)]
    tx = optax.sgd(0.25)
    want, _ = tx.update([jnp.asarray(g[0])], tx.init([jnp.asarray(p[0])]))
    opt = gan.make_optimizer(cfg)
    got, _ = opt.update([T(g[0])], opt.init([T(p[0])]), [T(p[0])])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]))
    assert disc.param_count(gan.init_gan_state(cfg, device="cpu").d_a) > 0
