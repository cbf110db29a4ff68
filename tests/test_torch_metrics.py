"""The port's quality metrics (utils/metrics.py, utils/fid_extractor.py)
against the JAX package's on the CPU.

Tolerances: the trained extractor's features agree to 1e-5 absolute (IEEE
float32 convolutions summed in other orders; features are ~1–20); the
statistics on identical float64 features are the same numpy and scipy
code, so 1e-12 relative; end to end over 300 images (the 256-d covariance
has full rank) the features' float32 differences reach FID and KID at
~1e-6, held to 1e-4 relative."""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu.utils import fid_extractor as jfx  # noqa: E402
from gan_class_transfer2_tpu.utils import metrics as jm  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import fid_extractor as fx  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import metrics as m  # noqa: E402

torch.set_num_threads(1)
WEIGHTS_SHA256 = "f8d3f10a7bd2230d9f349f091db676dd89958e0433247e9287c049b9a3b85132"


def _images(n, side, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, side, side, 3)).astype(np.float32)


def test_the_extractor_reads_the_jax_packages_pinned_weights_file():
    assert fx.available() and os.path.samefile(fx.WEIGHTS_PATH, jfx.WEIGHTS_PATH)
    with open(fx.WEIGHTS_PATH, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == WEIGHTS_SHA256
    params = fx.load_params()
    assert [tuple(layer["kernel"].shape) for layer in params["convs"]] == [
        (3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 128), (3, 3, 128, 256)]


@pytest.mark.parametrize("side", [64, 100, 256, 32])
def test_trained_features_equal_jax(side):
    """64² takes no resize; 100² and 256² the antialiased downsample (0.85
    off without antialias=True); 32² an upsample."""
    x = _images(8, side, seed=side)
    want = np.asarray(jfx.trained_features(x))
    got = fx.trained_features(torch.from_numpy(x))
    assert got.shape == (8, fx.FEATURE_DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_logits_equal_jax():
    x = _images(4, 64, seed=1)
    want = np.asarray(jfx.logits(jfx.load_params(), x))
    got = fx.logits(fx.load_params(), torch.from_numpy(x))
    assert got.shape == (4, fx.NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_random_features_with_carried_parameters_equal_jax():
    kernels = [np.asarray(k) for k in jm._random_feature_params(4, 32, 0)]
    params = m.random_feature_params_from_numpy(kernels)
    x = _images(6, 48, seed=3)
    want = np.asarray(jm.random_conv_features(x))
    got = m.random_conv_features(torch.from_numpy(x), params=params)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    own = m.random_conv_features(torch.from_numpy(x))  # the port's own draws
    assert own.shape == got.shape and not torch.allclose(own, got)
    assert [tuple(k.shape) for k in m.random_feature_params()] == [k.shape for k in kernels]
    with pytest.raises(ValueError, match=r"expected \(4, 4, 3, F\)"):
        m.random_feature_params_from_numpy(kernels[1:])


def _feats(n, d, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, d)) @ r.normal(size=(d, d)) * 0.3 + r.normal(size=d)


@pytest.mark.parametrize("n, d", [(40, 8), (300, 32)])
def test_statistics_on_identical_features_equal_jax(n, d):
    x, y = _feats(n, d, 0), _feats(n + 5, d, 1) + 0.2
    (mu_a, s_a), (mu_b, s_b) = m._stats(x), m._stats(y)
    (jmu_a, js_a), (jmu_b, js_b) = jm._stats(x), jm._stats(y)
    np.testing.assert_array_equal(s_a, js_a)
    got = m.frechet_distance(mu_a, s_a, mu_b, s_b)
    assert got == pytest.approx(jm.frechet_distance(jmu_a, js_a, jmu_b, js_b), rel=1e-12)
    assert m._kid_from_features(x, y) == pytest.approx(jm._kid_from_features(x, y), rel=1e-12)


def test_fid_kid_and_fid_and_kid_on_identical_features_equal_jax():
    """An extractor that flattens its input: both packages score the same
    float64 features."""
    a = _images(20, 4, seed=5)
    b = np.clip(_images(24, 4, seed=6) * 0.5 + 0.2, -1, 0.99).astype(np.float32)

    def ours(t):
        return t.reshape(len(t), -1)

    def theirs(t):
        return np.asarray(t).reshape(len(t), -1)

    got = m.fid_and_kid(a, b, extractor=ours, device="cpu")
    want = jm.fid_and_kid(a, b, extractor=theirs)
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-12)
    assert got["kid"] == pytest.approx(want["kid"], rel=1e-12)
    assert m.fid(a, b, extractor=ours, device="cpu") == pytest.approx(
        jm.fid(a, b, extractor=theirs), rel=1e-12)
    assert m.kid(a, b, extractor=ours, device="cpu") == pytest.approx(
        jm.kid(a, b, extractor=theirs), rel=1e-12)
    fb = m.extract_features(b, extractor=ours, device="cpu", batch_size=7)
    np.testing.assert_array_equal(fb, jm.extract_features(b, extractor=theirs))
    assert fb.dtype == np.float64
    again = m.fid_and_kid(a, None, extractor=ours, features_b=fb, device="cpu")
    assert again == got


def test_fid_and_kid_end_to_end_on_300_images_equal_jax():
    a = _images(300, 64, seed=7)
    b = np.clip(_images(300, 64, seed=8) * 0.6 + 0.1, -1, 0.99).astype(np.float32)
    got = m.fid_and_kid(a, b, extractor=m.get_extractor("trained"), device="cpu")
    want = jm.fid_and_kid(a, b, extractor=jm.get_extractor("trained"))
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-4)
    assert got["kid"] == pytest.approx(want["kid"], rel=1e-4)
    assert got["fid"] > 0


def test_get_extractor_names_and_errors_match_jax():
    assert m.get_extractor("trained") is fx.trained_features
    assert m.get_extractor("random") is m.random_conv_features
    assert m.get_extractor("auto") is fx.trained_features
    for mod in (m, jm):
        with pytest.raises(ValueError, match="unknown extractor 'banana'"):
            mod.get_extractor("banana")
    # a missing weights file: JAX's FileNotFoundError, from both packages
    for name in ("inception:/no/such/w.pth", "inception-tv:/no/such/w.pth"):
        for mod in (m, jm):
            with pytest.raises(FileNotFoundError, match="Inception weights not found"):
                mod.get_extractor(name)


def test_guards_and_pixel_metrics_equal_jax():
    one = _images(1, 8)
    for mod, kw in ((m, {"device": "cpu"}), (jm, {})):
        with pytest.raises(ValueError, match="fid needs >= 2 images"):
            mod.fid(one, _images(3, 8), **kw)
        with pytest.raises(ValueError, match="need >= 2 images per set, got 1"):
            mod.kid(one, _images(3, 8), **kw)
        with pytest.raises(ValueError, match="got 1"):
            mod.fid_and_kid(_images(3, 8), None, features_b=np.zeros((1, 4)), **kw)
    a, b = _images(2, 4, 0), _images(2, 4, 1)
    assert m.rmse(a, b) == jm.rmse(a, b) and m.psnr(a, b) == jm.psnr(a, b)
    assert m.psnr(a, a) == float("inf")
    mu, s = np.zeros(2), np.eye(2)
    assert abs(m.frechet_distance(mu, s, mu, s)) < 1e-8
