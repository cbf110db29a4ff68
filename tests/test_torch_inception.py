"""The port's InceptionV3 pool3 path (gan_class_transfer2_tpu_torch/utils/inception.py)
against the JAX package's (utils/inception.py) on the CPU, on the seeded
synthetic state dict both draw from the torchvision shape table (no real
InceptionV3 weights exist here). The twins of tests/test_inception.py, plus
the features themselves against JAX's.

Tolerances: pool3 features within 1e-5 of their scale (max |feature|):
IEEE float32 convolutions summed in other orders through 94 layers (the
measured difference is 3.9e-7 to 4.7e-7 of the scale); the folded kernels
and biases are the same numpy arithmetic, within 1e-6 relative (numpy
against XLA's multiply order of the transposed kernel); KID over those
features, 1e-3 relative: KID's kernel (xᵀy/d + 1)³ on features of ~1e2
cubes them to ~1e4 per pair and the estimate is a difference of such sums,
so the features' ~4e-7 differences reach it at 1.7e-4 (measured; the
threads' summation order moves it from run to run)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.lax as lax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.utils import inception as ji  # noqa: E402
from gan_class_transfer2_tpu.utils import metrics as jm  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import inception  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def state_dict():
    return inception.synthetic_state_dict(seed=0)


@pytest.fixture(scope="module")
def npz_path(state_dict, tmp_path_factory):
    p = tmp_path_factory.mktemp("inception") / "weights.npz"
    np.savez(p, **state_dict)
    return str(p)


@pytest.fixture(scope="module")
def params(state_dict):
    return inception.fold_state_dict(state_dict), ji.fold_state_dict(state_dict)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_spec_table_and_synthetic_state_dict_equal_jax(state_dict):
    """The torchvision channel ledger (256/288/288, 768, 1280, 2048) and the
    seeded synthetic draws, key for key."""
    s = inception.CONV_SPECS
    assert s == ji.CONV_SPECS and len(s) == 94
    assert s["Mixed_5b.branch_pool"][1] == 32
    assert s["Mixed_5c.branch1x1"][0] == 256
    assert s["Mixed_5d.branch1x1"][0] == 288
    assert s["Mixed_6b.branch1x1"][0] == 768
    assert s["Mixed_7a.branch3x3_1"][0] == 768
    assert s["Mixed_7b.branch1x1"][0] == 1280
    assert s["Mixed_7c.branch1x1"][0] == 2048
    theirs = ji.synthetic_state_dict(seed=0)
    assert sorted(state_dict) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(state_dict[k], v, err_msg=k)


def test_fold_state_dict_shapes_and_values_equal_jax(params):
    """OIHW kernels (JAX's HWIO transposed) and per-channel biases."""
    ours, theirs = params
    assert set(ours) == set(inception.CONV_SPECS)
    for name, (cin, cout, (kh, kw), _, _) in inception.CONV_SPECS.items():
        k, b = ours[name]["kernel"], ours[name]["bias"]
        assert tuple(k.shape) == (cout, cin, kh, kw) and tuple(b.shape) == (cout,), name
        assert k.dtype == b.dtype == torch.float32
        np.testing.assert_allclose(
            k.numpy(), np.transpose(np.asarray(theirs[name]["kernel"]), (3, 2, 0, 1)),
            rtol=1e-6, atol=0, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(theirs[name]["bias"]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_bn_folding_matches_explicit(state_dict, params):
    """conv → BN(eval) → relu computed explicitly equals the folded path, on
    Conv2d_1a_3x3's spec (the JAX twin's bounds)."""
    x = _images((1, 9, 9, 3), 1)
    got = inception._conv(params[0], "Conv2d_1a_3x3",
                          torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    raw = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(np.transpose(state_dict["Conv2d_1a_3x3.conv.weight"],
                                                 (2, 3, 1, 0))),
        (2, 2), ((0, 0), (0, 0)), dimension_numbers=("NHWC", "HWIO", "NHWC")))
    g, b, mu, var = (state_dict[f"Conv2d_1a_3x3.bn.{k}"]
                     for k in ("weight", "bias", "running_mean", "running_var"))
    want = np.maximum(g * (raw - mu) / np.sqrt(var + inception.BN_EPS) + b, 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    want_jax = np.asarray(ji._conv(params[1], "Conv2d_1a_3x3", jnp.asarray(x)))
    np.testing.assert_allclose(got, want_jax, rtol=2e-5, atol=2e-5)


def test_avg_pool_count_include_pad_semantics():
    """A ones image's corner: 4 valid cells of 9 → 1.0 when the padding is
    excluded (pytorch-fid), 4/9 when counted (torchvision); on random values
    both equal JAX's reduce_window forms."""
    ones = torch.ones((1, 1, 3, 3))
    excl = inception._branch_avg_pool(ones, fid_variant=True)
    incl = inception._branch_avg_pool(ones, fid_variant=False)
    assert float(excl[0, 0, 0, 0]) == pytest.approx(1.0)
    assert float(incl[0, 0, 0, 0]) == pytest.approx(4.0 / 9.0)
    assert float(excl[0, 0, 1, 1]) == float(incl[0, 0, 1, 1]) == pytest.approx(1.0)
    x = _images((2, 7, 5, 4), 2)
    for fid_variant in (True, False):
        got = inception._branch_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), fid_variant)
        want = ji._branch_avg_pool(jnp.asarray(x), fid_variant)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 256, 256, 3), (1, 320, 320, 3)],
                         ids=["upsampled", "downsampled"])
@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_pool3_features_equal_jax(params, shape, variant):
    """The whole forward, the resize to 299² included, at 1e-5 of the
    features' scale; finite, (N, 2048)."""
    x = _images(shape, 3)
    got = inception.pool3_features(params[0], torch.from_numpy(x), variant).numpy()
    want = np.asarray(ji.pool3_features(params[1], jnp.asarray(x), variant))
    assert got.shape == (shape[0], inception.POOL3_DIM) and np.all(np.isfinite(got))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_variants_differ_and_a_bad_variant_raises(params):
    x = torch.from_numpy(_images((1, 64, 64, 3), 4))
    fid = inception.pool3_features(params[0], x, "fid")
    tv = inception.pool3_features(params[0], x, "torchvision")
    assert not torch.allclose(fid, tv)
    with pytest.raises(ValueError, match="variant"):
        inception.pool3_features(params[0], x, variant="bogus")


def test_pth_and_npz_load_identically(state_dict, npz_path, tmp_path):
    """The .pth format published weights ship in and the .npz mirror fold to
    identical parameters, in both packages."""
    pth = tmp_path / "weights.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state_dict.items()}, pth)
    a = inception.load_params(str(pth))
    b = inception.load_params(npz_path)
    ja = ji.load_params(str(pth))
    for name in inception.CONV_SPECS:
        for key in ("kernel", "bias"):
            torch.testing.assert_close(a[name][key], b[name][key], rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(ja[name]["bias"]), b[name]["bias"].numpy())


def test_hwio_npz_kernels_accepted(state_dict, tmp_path):
    """An .npz with HWIO kernels (the JAX layout) folds as the OIHW one."""
    hwio = dict(state_dict)
    for name in inception.CONV_SPECS:
        hwio[f"{name}.conv.weight"] = np.transpose(state_dict[f"{name}.conv.weight"],
                                                   (2, 3, 1, 0))
    p = tmp_path / "hwio.npz"
    np.savez(p, **hwio)
    a = inception.fold_state_dict(state_dict)
    b = inception.load_params(str(p))
    for name in inception.CONV_SPECS:
        torch.testing.assert_close(a[name]["kernel"], b[name]["kernel"], rtol=0, atol=0)


def test_loader_errors_match_jax(state_dict, tmp_path):
    """Each refusal names the key, as JAX's does, word for word."""
    cases = []
    sd = dict(state_dict)
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    cases.append((sd, "Mixed_7c.branch_pool.bn.running_var"))
    sd = dict(state_dict)
    sd["Conv2d_1a_3x3.conv.weight"] = np.zeros((32, 3, 5, 5), np.float32)
    cases.append((sd, "Conv2d_1a_3x3"))
    sd = dict(state_dict)
    sd["Mixed_6b.branch1x1.bn.bias"] = np.zeros((7,), np.float32)
    cases.append((sd, "Mixed_6b.branch1x1.bn.bias"))
    for sd, key in cases:
        msgs = []
        for mod in (inception, ji):
            with pytest.raises(ValueError, match=key.replace(".", r"\.")) as e:
                mod.fold_state_dict(sd)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    missing = str(tmp_path / "nope.pth")
    for mod in (inception, ji):
        with pytest.raises(FileNotFoundError, match="Inception weights not found"):
            mod.features_from_file(missing)
    bad = tmp_path / "weights.txt"
    bad.write_text("x")
    for mod in (inception, ji):
        with pytest.raises(ValueError, match="unsupported weight format"):
            mod.load_params(str(bad))


def test_get_extractor_and_kid_equal_jax(npz_path):
    """``get_extractor('inception:<path>')`` end to end: 2048-d features
    equal to JAX's, KID over them finite, a different set scoring higher,
    and the torchvision variant differing."""
    ex = metrics.get_extractor(f"inception:{npz_path}")
    jex = jm.get_extractor(f"inception:{npz_path}")
    r = np.random.default_rng(3)
    a = r.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.5, a.shape), -1, 1).astype(np.float32)
    feats = ex(torch.from_numpy(a)).numpy()
    want = np.asarray(jex(jnp.asarray(a)))
    assert feats.shape == (4, 2048)
    np.testing.assert_allclose(feats, want, rtol=0, atol=1e-5 * np.abs(want).max())
    k_same = metrics.kid(a, a.copy(), extractor=ex, device="cpu")
    k_diff = metrics.kid(a, b, extractor=ex, device="cpu")
    assert np.isfinite(k_same) and np.isfinite(k_diff) and k_diff > k_same
    assert k_diff == pytest.approx(jm.kid(a, b, extractor=jex), rel=1e-3)
    ex_tv = metrics.get_extractor(f"inception-tv:{npz_path}")
    assert not np.allclose(ex_tv(torch.from_numpy(a)).numpy(), feats)


def test_config_accepts_inception_extractor():
    from gan_class_transfer2_tpu_torch.config import Config

    Config(fid_extractor="inception:/some/path.pth").validate()
    Config(fid_extractor="inception-tv:/some/path.npz").validate()
    with pytest.raises(ValueError, match="fid_extractor"):
        Config(fid_extractor="inceptionv4:/x.pth").validate()


def test_cli_eval_with_an_inception_extractor(npz_path, tmp_path, capsys):
    """``eval --fid-extractor inception:<npz>`` on the CPU (no checkpoint:
    random weights from the seed, with the warning): one JSON line naming
    the extractor, with finite FID and KID."""
    from gan_class_transfer2_tpu_torch import cli
    from gan_class_transfer2_tpu_torch.data import synthetic

    synthetic.save_as_pngs(synthetic.circles(8, 20), str(tmp_path / "a"))
    name = f"inception:{npz_path}"
    assert cli.main(["eval", "--device", "cpu", "--size", "16", "--pixel-size", "4",
                     "--max-size", "8", "--octaves", "2", "--steps", "4", "--batch-size", "2",
                     "--dataset-pattern", str(tmp_path / "a" / "*.png"), "--fid-samples", "3",
                     "--checkpoint-dir", str(tmp_path / "none"), "--fid-extractor", name]) == 0
    io = capsys.readouterr()
    out = json.loads(io.out.strip().splitlines()[-1])
    assert "no checkpoint found" in io.err
    assert out["fid_extractor"] == name and out["step"] == 0
    assert np.isfinite(out["fid"]) and np.isfinite(out["kid"])
