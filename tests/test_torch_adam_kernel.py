"""B2, fused Adam: the plain version of the port's kernel
(ops/adam_kernel.py) on the CPU against the JAX package's Pallas kernel run
in interpret mode (``_leaf_update_pallas(..., interpret=True)``) and against
``fused_adam_apply(..., interpret=True)``, which also sends leaves whose size
is not a multiple of 128 to its XLA update.

Tolerance: against ``_leaf_update_xla`` (the same float32 expressions,
operation by operation, in the same order) bit for bit, in float32 and in
bfloat16 moments. Against the Pallas kernel in interpret mode, within one
float32 rounding of the operands (2⁻²³·(|b·m| + |(1−b)·g|) for m, likewise
for v and p), plus one bfloat16 spacing (2⁻⁷·|x|) for bfloat16 moments: XLA's
CPU backend contracts ``b·m + (1−b)·g`` into a fused multiply-add there,
which rounds once where the plain expression rounds twice; where the sum
cancels, that is many ulps of the small result.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.ops import adam_kernel as jadam  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import adam_kernel  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402

torch.set_num_threads(1)


def _leaf(r, n, moment_dtype, steps_seen=3):
    """A parameter, moments as after a few steps, and a gradient."""
    p = r.normal(size=n).astype(np.float32)
    m = (r.normal(size=n) * 0.1).astype(np.float32)
    v = (r.uniform(0, 0.01, size=n) * steps_seen).astype(np.float32)
    g = r.normal(size=n).astype(np.float32)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    m, v = np.asarray(jnp.asarray(m).astype(jdt)), np.asarray(jnp.asarray(v).astype(jdt))
    return p, m, v, g


def _ulps(a: torch.Tensor, b) -> int:
    """Largest distance in units in the last place of ``a``'s dtype between
    ``a`` and the array ``b`` holding values of that dtype."""
    b = torch.from_numpy(np.asarray(b).astype(np.float32)).to(a.dtype)
    as_int = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(as_int).long() - b.view(as_int).long()).abs().max())


def _one_rounding(got: torch.Tensor, want, scale):
    """|got − want| within one float32 rounding of operands of size
    ``scale``, plus one bfloat16 spacing when ``got`` is stored in bfloat16."""
    want = np.asarray(want).astype(np.float32)
    bound = 2.0**-23 * np.asarray(scale, np.float32)
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0**-7 * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


def _scales(p, m, v, g, p_new):
    """Operand sizes of the update's three sums (see the module doc)."""
    m, v = np.asarray(m, np.float32), np.asarray(v, np.float32)
    return (np.abs(p) + np.abs(p - np.asarray(p_new, np.float32)),
            np.abs(0.9 * m) + np.abs(0.1 * g), np.abs(0.999 * v) + np.abs(0.001 * g * g))


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1024, 4096, 1000])
def test_plain_matches_the_jax_leaf_updates(moment_dtype, n):
    r = np.random.default_rng(n)
    p, m, v, g = _leaf(r, n, moment_dtype)
    step = np.float32(3.7e-4)
    args = [jnp.asarray(a) for a in (p, m, v, g)] + [jnp.asarray(step), 0.9, 0.999, 1e-7]
    xla = jadam._leaf_update_xla(*args)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    before = adam_kernel.adam_fused.launches
    adam_kernel.adam_fused([tp], [tm], [tv], [_torch(g)], torch.tensor([step]), 1e-7)
    assert adam_kernel.adam_fused.launches == before  # the CPU takes the plain version
    for got, want in zip((tp, tm, tv), xla):
        assert _ulps(got, want) == 0
    if n % 128 == 0:
        pallas = jadam._leaf_update_pallas(*args, True)
        for got, want, scale in zip((tp, tm, tv), pallas, _scales(p, m, v, g, pallas[0])):
            _one_rounding(got, want, scale)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_fused_apply_matches_jax_over_mixed_leaves(moment_dtype):
    """A tree with leaves that are (1024, 384) and are not (3, 1000, 1) a
    multiple of 128: the JAX step runs the Pallas kernel on the first and
    XLA on the others, the port one update over all; the warmup LR at
    count 1 and t = 3 make the step size."""
    r = np.random.default_rng(0)
    sizes = [1024, 3, 384, 1000, 1]
    leaves = [_leaf(r, n, moment_dtype) for n in sizes]
    jcfg = jconfig.tiny_test_config(optimizer="adam_fused", moment_dtype=moment_dtype,
                                    learning_rate=1e-3, warm_up=4)
    import optax

    adam_st = optax.ScaleByAdamState(jnp.asarray(2, jnp.int32),
                                     [jnp.asarray(x[1]) for x in leaves],
                                     [jnp.asarray(x[2]) for x in leaves])
    opt = (adam_st, optax.ScaleByScheduleState(jnp.asarray(1, jnp.int32)))
    jp, (jst, jsched) = jadam.fused_adam_apply(
        jcfg, [jnp.asarray(x[0]) for x in leaves], opt, [jnp.asarray(x[3]) for x in leaves],
        interpret=True)
    cfg = Config.from_json(jcfg.to_json())
    tparams = [_torch(x[0]) for x in leaves]
    tst = (trainer.ScaleByAdamState(torch.tensor(2, dtype=torch.int32),
                                    [_torch(x[1]) for x in leaves],
                                    [_torch(x[2]) for x in leaves]),
           trainer.ScaleByScheduleState(torch.tensor(1, dtype=torch.int32)))
    new = adam_kernel.fused_adam_apply(cfg, tparams, tst, [_torch(x[3]) for x in leaves])
    assert int(new[0].count) == int(jst.count) == 3 and int(new[1].count) == int(jsched.count)
    for (p, m, v, g), tp, tm, tv, jpp, jm, jv in zip(leaves, tparams, new[0].mu, new[0].nu, jp,
                                                     jst.mu, jst.nu):
        for got, want, scale in zip((tp, tm, tv), (jpp, jm, jv), _scales(p, m, v, g, jpp)):
            _one_rounding(got, want, scale)


@pytest.mark.parametrize("overrides", [
    dict(optimizer="adam_fused"),
    dict(optimizer="adam_tf"),
    dict(optimizer="adam_fused", grad_clip_norm=1.0),
    dict(optimizer="adam_fused", weight_decay=0.1),
    dict(optimizer="adam_fused", grad_accum=2),
    dict(optimizer="adam_fused", dynamic_loss_scale=True),
    dict(optimizer="adam_fused", moment_dtype="bfloat16"),
])
def test_gate_matches_jax(overrides):
    jcfg = jconfig.tiny_test_config(**overrides)
    assert adam_kernel.fused_adam_ok(Config.from_json(jcfg.to_json())) == jadam.fused_adam_ok(
        jcfg, 1)


def test_fused_train_step_equals_the_optax_form_step():
    """Through the train step: adam_fused (the plain version of B2 on the
    CPU) against adam_tf (the optax-form transforms) from the same state and
    draws. The two orders of float32 rounding (s·m/(√v+ε) against
    (α·m/(√v+ε))·(−lr)) differ by an ulp of the update: rtol 1e-6."""
    states, losses = [], []
    for opt in ("adam_fused", "adam_tf"):
        cfg = tiny_test_config(optimizer=opt, learning_rate=1e-2, warm_up=0,
                               fused_diffusion=True)
        state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = trainer.make_train_step(cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3))
                             .astype(np.float32))
        for _ in range(3):
            state, loss = step(state, x, gen)
        states.append(state)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-8)
    assert int(states[0].opt_state[0].count) == int(states[1].opt_state[0].count) == 3


def test_launch_count_per_step():
    assert adam_kernel.launches_per_step(26) == 1  # the default model's leaves
    assert adam_kernel.launches_per_step(adam_kernel.LEAVES_PER_LAUNCH + 1) == 2


def test_wrapper_refuses_devices_without_a_kernel():
    t = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        adam_kernel.adam_fused([t], [t], [t], [t], torch.empty(1, device="meta"), 1e-7)
