"""The port's file input (data/pipeline.py, data/synthetic.py) against the
JAX package's on the same files and the same numpy draws. Everything here
is exact: the decoders agree byte for byte (the port's PNG decoder against
Pillow's) and both packages make the same numpy calls in the same order.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu.data import pipeline as jpipe  # noqa: E402
from gan_class_transfer2_tpu.data import synthetic as jsyn  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data import pipeline, synthetic  # noqa: E402
from gan_class_transfer2_tpu_torch.data.device_augment import HBMDataset  # noqa: E402


@pytest.fixture
def image_dir(tmp_path):
    """Pillow-written files: RGB and grey PNGs larger than, equal to and
    smaller than the crop, an RGBA and a palette PNG, a JPEG, and bytes
    that are no image."""
    r = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(20, 24), (16, 16), (31, 18), (12, 30)]):
        Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"rgb_{i}.png")
    Image.fromarray(r.integers(0, 256, (22, 19), dtype=np.uint8)).save(d / "grey.png")
    Image.fromarray(r.integers(0, 256, (18, 21, 4), dtype=np.uint8)).save(d / "rgba.png")
    Image.fromarray(r.integers(0, 256, (17, 23), dtype=np.uint8)).quantize(64).save(d / "pal.png")
    Image.fromarray(r.integers(0, 256, (25, 20, 3), dtype=np.uint8)).save(d / "photo.jpg")
    (d / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    return d


def _files(d, pattern="*"):
    return sorted(str(p) for p in d.glob(pattern))


@pytest.mark.parametrize("kw", [dict(), dict(flip=False), dict(center=True, flip=False),
                                dict(crop=False)], ids=["crop-flip", "no-flip", "center", "no-crop"])
def test_decode_image_uint8_equals_jax_on_the_same_rng(image_dir, kw):
    """One rng stream through every file: the crop corners, the flips and
    the refusals (too small, undecodable) line up call for call."""
    r_port, r_jax = np.random.default_rng(3), np.random.default_rng(3)
    for f in _files(image_dir):
        want = got = None
        try:
            want = jpipe.decode_image_uint8(f, 16, r_jax, **kw)
        except Exception as e:  # noqa: BLE001 — the refusal itself is compared
            want = type(e)
        try:
            got = pipeline.decode_image_uint8(f, 16, r_port, **kw)
        except Exception as e:  # noqa: BLE001
            got = type(e)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert got in (want, ValueError), (f, got, want)
    assert r_port.integers(0, 2**31) == r_jax.integers(0, 2**31)


def test_too_small_and_broken_files_are_refused(image_dir):
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="smaller than crop"):
        pipeline.decode_image(str(image_dir / "rgb_3.png"), 16, rng)
    with pytest.raises(ValueError):
        pipeline.decode_image(str(image_dir / "broken.png"), 16, rng)
    x = pipeline.decode_image(str(image_dir / "rgb_1.png"), 16, rng, flip=False)
    assert x.dtype == np.float32 and x.min() >= -1 and x.max() < 1


def test_held_out_split_and_eval_set_equal_jax(image_dir, capsys):
    pattern = str(image_dir / "*")
    for n in (0, 3, 100):
        assert pipeline.held_out_split(pattern, n, seed=4) == jpipe.held_out_split(pattern, n, seed=4)
    _, ev = pipeline.held_out_split(pattern, 6, seed=1)
    got, want = pipeline.decode_eval_set(ev, 16, seed=2), jpipe.decode_eval_set(ev, 16, seed=2)
    assert got.dtype == np.float32 and 0 < len(got) < len(ev)  # bad files skipped
    np.testing.assert_array_equal(got, want)
    assert "skipped undecodable" in capsys.readouterr().out


def test_image_dataset_one_worker_equals_jax_batch_for_batch(image_dir):
    """One decode worker: the file stream (shuffle buffer 3, repeat), the
    skips and the augment draws give JAX's batches, before and after a
    set_state (the resumed stream is a fresh one from resume_round)."""
    files = _files(image_dir)

    def batches(mod, state=None, n=6):
        ds = mod.ImageDataset(files, 16, 3, seed=7, shuffle_buffer=3, num_workers=1)
        if state is not None:
            ds.set_state(state)
        it = iter(ds)
        out = [next(it) for _ in range(n)]
        sd = ds.state_dict()
        ds.close()
        return out, sd

    got, sd = batches(pipeline)
    want, jsd = batches(jpipe)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sd["resume_round"] == jsd["resume_round"] == 0
    state = {"batches_served": 4, "resume_round": 0}
    got, sd = batches(pipeline, state, 3)
    want, _ = batches(jpipe, state, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sd["resume_round"] == 1


def test_image_dataset_cache_and_failure_modes(image_dir, tmp_path):
    ds = pipeline.ImageDataset(_files(image_dir, "rgb_0.png"), 16, 2, num_workers=1, cache=True)
    next(iter(ds))
    assert list(ds._cache) == [str(image_dir / "rgb_0.png")]
    ds.close()
    small = tmp_path / "small"
    small.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(small / "s.png")
    ds = pipeline.ImageDataset(str(small / "*.png"), 16, 2, num_workers=1)
    with pytest.raises(RuntimeError, match="consecutive decode failures"):
        next(iter(ds))
    with pytest.raises(ValueError, match="num_workers"):
        next(iter(pipeline.ImageDataset(str(small / "*.png"), 16, 2, num_workers=0)))
    with pytest.raises(FileNotFoundError, match="no files match"):
        pipeline.list_files(str(tmp_path / "nothing" / "*.png"))


def test_missing_pillow_stops_the_run_by_name(image_dir, monkeypatch):
    """Without Pillow, PNGs still decode; a JPEG raises DecoderUnavailable,
    which the dataset re-raises at once instead of counting it as a bad
    file."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    rng = np.random.default_rng(0)
    assert pipeline.decode_image_uint8(str(image_dir / "pal.png"), 16, rng).shape == (16, 16, 3)
    with pytest.raises(pipeline.DecoderUnavailable, match="Pillow"):
        pipeline.decode_image_uint8(str(image_dir / "photo.jpg"), 16, rng)
    ds = pipeline.ImageDataset([str(image_dir / "photo.jpg")] * 3, 16, 2, num_workers=1)
    with pytest.raises(pipeline.DecoderUnavailable, match="photo.jpg"):
        next(iter(ds))
    with pytest.raises(pipeline.DecoderUnavailable):
        pipeline.load_hbm_pool([str(image_dir / "photo.jpg")], 16)


def test_array_dataset_equals_jax_and_replays_after_set_state():
    images = np.random.default_rng(1).integers(0, 256, (5, 8, 8, 3), dtype=np.uint8)
    ours, theirs = pipeline.ArrayDataset(images, 2, seed=3), jpipe.ArrayDataset(images, 2, seed=3)
    a, b = iter(ours), iter(theirs)
    for _ in range(4):
        np.testing.assert_array_equal(next(a), next(b))
    state = ours.state_dict()
    assert state == theirs.state_dict()
    again = pipeline.ArrayDataset(images, 2, seed=3)
    again.set_state(state)
    np.testing.assert_array_equal(next(iter(again)), next(a))


def test_device_iterator_consumed_state_is_one_batch_behind():
    ds = pipeline.ArrayDataset(np.zeros((6, 4, 4, 3), np.float32), 2, seed=0)
    it = pipeline.DeviceIterator(ds, device="cpu")
    assert it.consumed_state() is None
    batch = next(it)
    assert isinstance(batch, torch.Tensor) and batch.shape == (2, 4, 4, 3)
    assert it.consumed_state()["position"] == 1
    assert ds.state_dict()["position"] == 2  # the prefetched batch
    next(it)
    assert it.consumed_state()["position"] == 2 and ds.state_dict()["position"] == 3
    j = jpipe.DeviceIterator(jpipe.ArrayDataset(np.zeros((6, 4, 4, 3), np.float32), 2, seed=0))
    next(j), next(j)
    assert j.consumed_state() == it.consumed_state()


def test_device_iterator_yields_the_last_batch_of_a_finite_source():
    it = pipeline.DeviceIterator([np.ones((1, 2, 2, 3), np.float32)] * 2, device="cpu")
    assert len(list(it)) == 2


def test_load_hbm_pool_clamps_as_jax_does(image_dir, capsys):
    """The header-only pre-scan finds the smallest accepted image; the pool
    side is clamped to it, too-small and broken files are skipped, and the
    center crops equal JAX's."""
    files = _files(image_dir)
    got = pipeline.load_hbm_pool(files, 20, size=16, workers=2)
    out = capsys.readouterr().out
    want = jpipe.load_hbm_pool(files, 20, size=16)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[1] == 16  # rgb_1 is 16x16: 20 -> 16
    np.testing.assert_array_equal(got, want)
    assert "side clamped 20 -> 16" in out and "skipped" in out
    with pytest.raises(FileNotFoundError):
        pipeline.load_hbm_pool(_files(image_dir, "broken.png"), 16)


def test_make_datasets_routes_and_says_the_native_loader_is_not_ported(image_dir, capsys):
    cfg = tiny_test_config(classes=(str(image_dir / "rgb_*.png"), str(image_dir / "grey.png")),
                           data_workers=1)
    dsets = pipeline.make_datasets(cfg, device="cpu")
    assert [type(d) for d in dsets] == [pipeline.ImageDataset] * 2
    assert [d.seed for d in dsets] == [cfg.seed, cfg.seed + 1]
    assert "data/native_loader.py" in capsys.readouterr().out
    pipeline.make_datasets(cfg.replace(native_loader=False), device="cpu")
    assert "native" not in capsys.readouterr().out
    hbm = pipeline.make_datasets(cfg.replace(data_hbm=20), device="cpu")
    assert all(isinstance(d, HBMDataset) for d in hbm)
    batch = next(iter(hbm[0]))
    assert batch.shape == (cfg.batch_size, 16, 16, 3) and batch.dtype == torch.float32


def test_synthetic_equals_jax_and_its_pngs_read_back(tmp_path):
    for name, fn in synthetic.SHAPE_CLASSES:
        jfn = dict(jsyn.SHAPE_CLASSES)[name]
        np.testing.assert_array_equal(fn(3, 16, seed=2), jfn(3, 16, seed=2))
    a, b = synthetic.colored_pair(4, 8, seed=1)
    ja, jb = jsyn.colored_pair(4, 8, seed=1)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    imgs = synthetic.circles(3, 12)
    synthetic.save_as_pngs(imgs, str(tmp_path / "ours"))
    jsyn.save_as_pngs(imgs, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [f"img_{i:04d}.png" for i in range(3)]
    for n in names:
        with Image.open(tmp_path / "jax" / n) as img:
            np.testing.assert_array_equal(
                pipeline.decode_rgb(str(tmp_path / "ours" / n)), np.asarray(img.convert("RGB")))
