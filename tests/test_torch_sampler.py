"""Slice-as-a-whole parity: the port's serving path (preview, invert, edits,
sample, sample_stream, edit_image, the eval program) against
gan_class_transfer2_tpu.sample.sampler at the tiny config, with the same
weights (carried by from_jax_params), the same init batches and the same
explicitly passed VQ dictionary.

Tolerance: atol = rtol = 1e-4 — both run IEEE float32 denoisers whose
outputs agree to ~1e-6; the loops chain ``steps`` of them through the
diffusion algebra, which divides by √ᾱ or √(1−ᾱ) and so can grow an error
by up to ~20× at the noisiest timestep. The atol scales with max|reference|
where that exceeds 1: under ``ode`` the stale-ε̂ quirk grows the inversion's
x̂ geometrically (to ~1e9 at T=10), and only relative agreement is defined."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.models import unet as junet  # noqa: E402
from gan_class_transfer2_tpu.sample import sampler as jsampler  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4


def _setup(**overrides):
    jcfg, cfg = jax_tiny(**overrides), tiny_test_config(**overrides)
    params = jax.tree_util.tree_map(np.asarray, junet.init_unet(jax.random.PRNGKey(0), jcfg))
    model = weights.from_jax_params(cfg, params, device="cpu")
    return jcfg, cfg, params, model


def _np(seed, shape, uniform=False):
    r = np.random.default_rng(seed)
    a = r.uniform(-1, 1, shape) if uniform else r.normal(size=shape)
    return a.astype(np.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(port), ref, rtol=TOL, atol=TOL * scale)


@pytest.fixture(scope="module")
def tiny():
    return _setup()


@pytest.mark.parametrize("param", ["x", "epsilon", "scaled_epsilon", "ode"])
def test_preview_and_invert_match_jax(param):
    jcfg, cfg, params, model = _setup(parameterization=param)
    image = _np(0, (1, cfg.size, cfg.size, 3), uniform=True)
    noise = _np(1, image.shape)
    d_ref, rmse_ref = jsampler.preview(jcfg, params, jnp.asarray(image), jnp.asarray(noise))
    d, rmse = sampler.preview(cfg, model, torch.from_numpy(image), torch.from_numpy(noise))
    _close(d, d_ref)
    _close(rmse, rmse_ref)
    x_ref, e_ref = jax.jit(lambda p, x: jsampler.invert(jcfg, p, x))(params, jnp.asarray(image))
    x, e = sampler.invert(cfg, model, torch.from_numpy(image))
    _close(x, x_ref)
    _close(e, e_ref)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("snapshots", [True, False])
def test_sample_matches_jax(tiny, stride, snapshots):
    jcfg, cfg, params, model = tiny
    jcfg, cfg = jcfg.replace(sample_stride=stride), cfg.replace(sample_stride=stride)
    init = _np(2, (3, cfg.size, cfg.size, 3))
    ref = jsampler.sample(jcfg, params, jnp.asarray(init), snapshots=snapshots)
    out = sampler.sample(cfg, model, torch.from_numpy(init), snapshots=snapshots)
    _close(out.images, ref.images)
    if snapshots:
        _close(out.snapshots, ref.snapshots)
    else:
        assert out.snapshots is None


def test_sample_stream_last_yield_equals_sample(tiny):
    _, cfg, _, model = tiny
    cfg = cfg.replace(sample_stride=3)
    init = torch.from_numpy(_np(3, (2, cfg.size, cfg.size, 3)))
    direct = sampler.sample(cfg, model, init).images.numpy()
    yields = list(sampler.sample_stream(cfg, model, init, segments=3))
    assert len(yields) == 3
    np.testing.assert_array_equal(yields[-1], direct)
    assert list(sampler.sample_timesteps(cfg)) == [10, 7, 4, 1]


def test_edit_image_matches_jax(tiny):
    jcfg, cfg, params, model = tiny
    image = _np(4, (2, cfg.size, cfg.size, 3), uniform=True)
    dictionary = _np(5, (cfg.size, cfg.size, 2**cfg.bits_per_pixel, 3))
    ref = jsampler.edit_image(jcfg, params, jnp.asarray(image), dictionary=jnp.asarray(dictionary))
    out = sampler.edit_image(cfg, model, torch.from_numpy(image),
                             dictionary=torch.from_numpy(dictionary))
    assert list(out) == list(ref) == ["reconstruction", "pixelate", "shift", "quantise"]
    for name in ref:
        _close(out[name], ref[name])
    with pytest.raises(ValueError, match="unknown edits"):
        sampler.edit_image(cfg, model, torch.from_numpy(image), edits=("quantize",))


def test_eval_fn_matches_jax(tiny):
    jcfg, cfg, params, model = tiny
    example = _np(6, (2, cfg.size, cfg.size, 3), uniform=True)
    noise = _np(7, (2, cfg.size, cfg.size, 3))
    dictionary = _np(8, (cfg.size, cfg.size, 2**cfg.bits_per_pixel, 3))
    ref = jsampler.make_eval_fn(jcfg)(params, jnp.asarray(example), jnp.asarray(noise),
                                       jnp.asarray(dictionary))
    out = sampler.make_eval_fn(cfg)(model, torch.from_numpy(example), torch.from_numpy(noise),
                                    torch.from_numpy(dictionary))
    assert set(out) == set(ref)
    assert out["fake"].shape == (2 + 4 * 2, cfg.size, cfg.size, 3)
    for k in ref:
        _close(out[k], ref[k])
