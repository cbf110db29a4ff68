"""Port parity: the diffusion algebra and noise schedules of
gan_class_transfer2_tpu_torch.core against gan_class_transfer2_tpu.core, for
every (schedule × parameterization) pair, on the same numpy inputs.

Tolerance: rtol 1e-6 in float32, with an atol of 1e-6 × max|reference| —
both sides evaluate the same expressions in the same order, so they differ
only by the rounding of pow/cos (an ulp, ~6e-8 relative); an element that
cancels to near zero keeps that absolute error but loses its relative
precision, hence the atol scaled to the array."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.core import diffusion as jd  # noqa: E402
from gan_class_transfer2_tpu.core import schedule as js  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.core import diffusion as td  # noqa: E402
from gan_class_transfer2_tpu_torch.core import schedule as ts  # noqa: E402

torch.set_num_threads(1)

SCHEDULES = ("quadratic", "exponential", "rational_exponential", "geometric",
             "cosine2", "quartic")
PARAMS = ("x", "epsilon", "scaled_epsilon", "ode")
RTOL = 1e-6


def _close(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _tensors(seed, shape=(2, 4, 4, 3)):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_alpha_dash(schedule):
    steps = 200
    for t in (1, 2, 7, 100, 150.5, 199, 200):  # Python scalars, as cfg fields reach it
        _close(ts.alpha_dash(t, steps, schedule), js.alpha_dash(t, steps, schedule))
    t32 = np.arange(1, steps + 1, dtype=np.float32)  # float32 timesteps, as the samplers pass
    _close(ts.alpha_dash(torch.from_numpy(t32), steps, schedule),
           js.alpha_dash(jnp.asarray(t32), steps, schedule))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("param", PARAMS)
def test_diffusion_algebra(schedule, param):
    kw = dict(schedule=schedule, parameterization=param)
    jcfg, tcfg = jax_tiny(**kw), tiny_test_config(**kw)
    x, eps, pred = _tensors(1)
    T = tcfg.steps
    for t in (1, 2, T // 2, T):
        for t_arg in (float(t), np.float32(t)):
            jt = jnp.float32(t_arg) if isinstance(t_arg, np.float32) else t_arg
            tt = torch.tensor(t_arg) if isinstance(t_arg, np.float32) else t_arg
            _close(td.renoise(tcfg, torch.from_numpy(x), torch.from_numpy(eps), tt),
                   jd.renoise(jcfg, jnp.asarray(x), jnp.asarray(eps), jt))
            xp, ep = td.step_update(tcfg, torch.from_numpy(pred), torch.from_numpy(x),
                                    torch.from_numpy(eps), tt)
            xr, er = jd.step_update(jcfg, jnp.asarray(pred), jnp.asarray(x),
                                    jnp.asarray(eps), jt)
            _close(xp, xr)
            _close(ep, er)
            target_p, scale_p = td.training_target(tcfg, torch.from_numpy(x),
                                                   torch.from_numpy(eps), tt)
            target_r, scale_r = jd.training_target(jcfg, jnp.asarray(x), jnp.asarray(eps), jt)
            _close(target_p, target_r)
            _close(scale_p, scale_r)
    _close(td.preview_image_factor(tcfg), jd.preview_image_factor(jcfg))
    _close(td.preview_denoise(tcfg, torch.from_numpy(x), torch.from_numpy(pred)),
           jd.preview_denoise(jcfg, jnp.asarray(x), jnp.asarray(pred)))


def test_prediction_weighting_target():
    kw = dict(parameterization="scaled_epsilon", prediction_weighting=True)
    x, eps, _ = _tensors(2)
    target_p, scale_p = td.training_target(tiny_test_config(**kw), torch.from_numpy(x),
                                           torch.from_numpy(eps), 3.0)
    target_r, scale_r = jd.training_target(jax_tiny(**kw), jnp.asarray(x),
                                           jnp.asarray(eps), 3.0)
    _close(target_p, target_r)
    _close(scale_p, scale_r)


def test_ode_keeps_epsilon_stale():
    """The reference quirk (diffusion.py:13-21): ODE updates only x̂."""
    cfg = tiny_test_config(parameterization="ode")
    x, eps, pred = (torch.from_numpy(a) for a in _tensors(3))
    _, eps_out = td.step_update(cfg, pred, x, eps, 4.0)
    assert eps_out is eps
