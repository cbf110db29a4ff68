"""Port parity of ops/diffaug.py: each DiffAugment policy's apply, given the
draws that gan_class_transfer2_tpu.ops.diffaug makes from its key, against
the JAX policy on the same input. ``jax.random`` and ``torch.Generator``
give different numbers from one seed, so the port's own draws are held to
their ranges and to freshness instead.

Tolerance: 1e-6 absolute for color (float32 means in other orders);
translation and cutout move or zero values and match exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.ops import diffaug as jdiffaug  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import diffaug  # noqa: E402

torch.set_num_threads(1)


def _x(shape=(5, 16, 12, 3), seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def test_color_matches_jax_on_jax_draws():
    x, key = _x(), jax.random.PRNGKey(3)
    kb, ks, kc = jax.random.split(key, 3)
    shape = (x.shape[0], 1, 1, 1)
    draws = [jax.random.uniform(k, shape, jnp.float32, lo, hi)
             for k, (lo, hi) in zip((kb, ks, kc), ((-0.5, 0.5), (0.0, 2.0), (0.5, 1.5)))]
    want = np.asarray(jdiffaug._color(key, jnp.asarray(x)))
    got = diffaug.color(T(x), *(T(d) for d in draws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 16, 12, 3), (3, 8, 8, 2)])
def test_translation_matches_jax_on_jax_draws(shape):
    """Per-sample integer shifts, zero pad, per-axis bound ⌈size/8⌉ (a
    non-square input keeps its own horizontal bound)."""
    x, key = _x(shape, seed=1), jax.random.PRNGKey(4)
    n, h, w, _ = shape
    sy, sx = max(-(-h // 8), 1), max(-(-w // 8), 1)
    kx, ky = jax.random.split(key)
    ty = jax.random.randint(ky, (n,), -sy, sy + 1)
    tx = jax.random.randint(kx, (n,), -sx, sx + 1)
    want = np.asarray(jdiffaug._translation(key, jnp.asarray(x)))
    got = diffaug.translation(T(x), T(ty), T(tx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 16, 12, 3), (4, 9, 7, 1)])
def test_cutout_matches_jax_on_jax_draws(shape):
    x, key = _x(shape, seed=2), jax.random.PRNGKey(5)
    n, h, w, _ = shape
    ch, cw = max(h // 2, 1), max(w // 2, 1)
    ky, kx = jax.random.split(key)
    oy = jax.random.randint(ky, (n, 1, 1), -(ch // 2), h - ch // 2 + 1)
    ox = jax.random.randint(kx, (n, 1, 1), -(cw // 2), w - cw // 2 + 1)
    want = np.asarray(jdiffaug._cutout(key, jnp.asarray(x)))
    got = diffaug.cutout(T(x), T(np.asarray(oy)[:, 0, 0]), T(np.asarray(ox)[:, 0, 0]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_translation_by_zero_is_identity_and_shift_moves_rows():
    x = T(_x((2, 8, 8, 3), seed=3))
    zero = torch.zeros(2, dtype=torch.int64)
    assert torch.equal(diffaug.translation(x, zero, zero), x)
    one = torch.ones(2, dtype=torch.int64)
    y = diffaug.translation(x, one, zero)  # out[y] = x[y + 1]
    assert torch.equal(y[:, :-1], x[:, 1:]) and torch.equal(y[:, -1], torch.zeros_like(y[:, -1]))


def test_empty_policy_is_a_no_op_that_draws_nothing():
    cfg = tiny_test_config(diffaug="")
    x = T(_x())
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    assert diffaug.augment(cfg, gen, x) is x
    assert torch.equal(gen.get_state(), before)


def test_port_draws_stay_in_the_policies_ranges_and_are_fresh():
    """Every call draws anew from the generator (the JAX step folds its key
    with the step for the same end); the draws lie in each policy's range."""
    x = T(_x((64, 16, 12, 3), seed=4))
    gen = torch.Generator().manual_seed(1)
    b, s, c = diffaug.draw_color(gen, x)
    assert (-0.5 <= b).all() and (b < 0.5).all() and (0 <= s).all() and (s < 2).all()
    assert (0.5 <= c).all() and (c < 1.5).all() and b.shape == (64, 1, 1, 1)
    ty, tx = diffaug.draw_translation(gen, x)
    assert ty.abs().max() == 2 and tx.abs().max() == 2  # ⌈16/8⌉, ⌈12/8⌉: both ends reached
    oy, ox = diffaug.draw_cutout(gen, x)
    assert oy.min() >= -4 and oy.max() <= 12 and ox.min() >= -3 and ox.max() <= 9
    cfg = tiny_test_config(diffaug="color,translation,cutout")
    first, second = diffaug.augment(cfg, gen, x), diffaug.augment(cfg, gen, x)
    assert first.shape == x.shape and not torch.equal(first, second)
    again = diffaug.augment(cfg, torch.Generator().manual_seed(7), x)
    assert torch.equal(again, diffaug.augment(cfg, torch.Generator().manual_seed(7), x))


def test_augment_applies_the_policies_in_order():
    """``augment`` = the policies' applies in the config's order, each on a
    draw taken in that order from the one generator."""
    cfg = tiny_test_config(diffaug="cutout,color")
    x = T(_x(seed=5))
    got = diffaug.augment(cfg, torch.Generator().manual_seed(3), x)
    gen = torch.Generator().manual_seed(3)
    y = diffaug.cutout(x, *diffaug.draw_cutout(gen, x))
    want = diffaug.color(y, *diffaug.draw_color(gen, y))
    assert torch.equal(got, want)
