"""The port's native C++ loader (data/native/dataloader.cc through
data/native_loader.py), built with the host's g++, against the JAX
package's loader and the port's own PNG decoder (utils/png.py) on the same
files. Every comparison is exact: both libraries decode with the same
libpng/libjpeg and draw crops and flips from std::mt19937_64(seed).

The port's batch stream does not depend on timing, so the epoch test holds
exact batches for 1 and 3 workers."""

import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu.data import native_loader as jnl  # noqa: E402
from gan_class_transfer2_tpu_torch.data import native_loader as nl  # noqa: E402
from gan_class_transfer2_tpu_torch.data import pipeline  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import png  # noqa: E402


@pytest.fixture(scope="module")
def built():
    if not nl.available():
        pytest.fail(f"the port's native loader does not build here: {nl.build_error()}")
    if not jnl.available():
        pytest.skip("the JAX package's native loader does not build here")


def _filtered_png(arr, ctype, ftype, palette=None):
    """PNG bytes of (h, w, ch) uint8 with every row under one filter (as
    tests/test_torch_png.py writes them): Pillow writes no Average rows."""
    h, w, ch = arr.shape
    rows, prev, out = arr.reshape(h, w * ch).astype(np.int32), np.zeros(w * ch, np.int32), []
    for row in rows:
        a = np.concatenate([np.zeros(ch, np.int32), row[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ftype == 0:
            f = row
        elif ftype == 1:
            f = row - a
        elif ftype == 2:
            f = row - prev
        elif ftype == 3:
            f = row - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    return (png.SIGNATURE + body + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Pillow-written RGB, grey, palette and RGBA PNGs; PNGs whose rows all
    use one of the five filters, per colour type; a JPEG."""
    d = tmp_path_factory.mktemp("native_imgs")
    r = np.random.default_rng(0)
    Image.fromarray(r.integers(0, 256, (24, 20, 3), dtype=np.uint8)).save(d / "rgb.png")
    Image.fromarray(r.integers(0, 256, (22, 19), dtype=np.uint8)).save(d / "grey.png")
    Image.fromarray(r.integers(0, 256, (18, 21, 3), dtype=np.uint8)).quantize(64).save(
        d / "pal.png")
    Image.fromarray(r.integers(0, 256, (19, 23, 4), dtype=np.uint8)).save(d / "rgba.png")
    for ftype in range(5):
        for ctype, ch in ((0, 1), (2, 3), (3, 1), (4, 2), (6, 4)):
            arr = r.integers(0, 256, (17, 18, ch), dtype=np.uint8)
            palette = None
            if ctype == 3:
                arr = r.integers(0, 40, (17, 18, 1), dtype=np.uint8)
                palette = r.integers(0, 256, (40, 3), dtype=np.uint8)
            (d / f"f{ftype}_c{ctype}.png").write_bytes(_filtered_png(arr, ctype, ftype, palette))
    Image.fromarray(r.integers(0, 256, (25, 20, 3), dtype=np.uint8)).save(d / "photo.jpg",
                                                                         quality=90)
    return d


def _pngs(d):
    return sorted(str(p) for p in d.glob("*.png"))


@pytest.mark.parametrize("augment", [False, True], ids=["whole", "augment"])
def test_decode_one_equals_jax_bit_for_bit_on_every_png_kind(built, image_dir, augment):
    files = _pngs(image_dir)
    assert len(files) == 4 + 25
    for f in files:
        for seed in range(4):
            got = nl.decode_one(f, 16, seed=seed, augment=augment)
            want = jnl.decode_one(f, 16, seed=seed, augment=augment)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{f} seed {seed}")


def test_decode_one_equals_the_ports_png_decoder(built, image_dir):
    """augment=False sizes its buffer from the library (no Pillow)."""
    for f in _pngs(image_dir):
        want = png.read_png(f).astype(np.float32) / 128.0 - 1.0
        np.testing.assert_array_equal(nl.decode_one(f, 16, augment=False), want, err_msg=f)


@pytest.mark.parametrize("augment", [False, True], ids=["whole", "augment"])
def test_decode_one_equals_jax_on_a_jpeg(built, image_dir, augment):
    if not nl.jpeg_available():
        pytest.skip("this host's g++ finds no jpeglib.h: the loader was built without libjpeg")
    f = str(image_dir / "photo.jpg")
    for seed in range(4):
        np.testing.assert_array_equal(nl.decode_one(f, 16, seed=seed, augment=augment),
                                      jnl.decode_one(f, 16, seed=seed, augment=augment))


def test_a_build_without_libjpeg_stops_on_a_jpeg_by_name(built, image_dir, tmp_path,
                                                          monkeypatch):
    """Built as on a machine without jpeglib.h (the card's): PNGs decode
    as before, and a JPEG raises DecoderUnavailable from every entry point
    instead of counting as a bad file."""
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_flags", lambda: ("-lz",))
    assert not nl.jpeg_available()
    f = str(image_dir / "rgb.png")
    np.testing.assert_array_equal(nl.decode_one(f, 16, seed=1), jnl.decode_one(f, 16, seed=1))
    jpeg = str(image_dir / "photo.jpg")
    for augment in (False, True):
        with pytest.raises(pipeline.DecoderUnavailable, match="photo.jpg.*no JPEG decoder"):
            nl.decode_one(jpeg, 16, augment=augment)
    with pytest.raises(pipeline.DecoderUnavailable, match="photo.jpg"):
        nl.build_cache([f, jpeg], 16, str(tmp_path / "c.cache"))
    assert not (tmp_path / "c.cache").exists()
    ds = nl.NativeImageDataset([f, jpeg], 16, 2, num_workers=1)
    with pytest.raises(pipeline.DecoderUnavailable, match="photo.jpg"):
        for _ in range(4):
            next(iter(ds))
    ds.close()


def test_decode_one_refusals(built, image_dir, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    with pytest.raises(ValueError, match=r"\(-1\)"):
        nl.decode_one(str(bad), 16, augment=False)
    with pytest.raises(ValueError, match=r"\(-2\)"):  # smaller than the crop
        nl.decode_one(str(image_dir / "rgb.png"), 32)


@pytest.fixture
def solid_dir(tmp_path):
    """12 solid-colour 16² PNGs: each batch element names its file."""
    for i in range(12):
        Image.fromarray(np.full((16, 16, 3), i * 20, np.uint8)).save(tmp_path / f"c_{i:02d}.png")
    return tmp_path


def _ids(batch):
    return np.round((batch[:, 0, 0, 0] + 1.0) * 128 / 20).astype(int).tolist()


def _take(files, workers, n, seed=3, batch=4):
    ds = nl.NativeImageDataset(files, 16, batch, seed=seed, num_workers=workers)
    it = iter(ds)
    out = [next(it) for _ in range(n)]
    ds.close()
    return out


def test_every_file_once_per_epoch_and_the_same_batches_for_1_and_3_workers(built, solid_dir):
    files = sorted(str(p) for p in solid_dir.glob("*.png"))
    one, three = _take(files, 1, 9), _take(files, 3, 9)
    for a, b in zip(one, three):
        np.testing.assert_array_equal(a, b)
    for epoch in range(3):
        seen = sum((_ids(b) for b in one[3 * epoch: 3 * epoch + 3]), [])
        assert sorted(seen) == list(range(12)), (epoch, seen)
    assert one[0].shape == (4, 16, 16, 3) and one[0].dtype == np.float32


def test_crops_and_flips_are_the_same_for_any_worker_count(built, image_dir):
    """Random crops of larger images: the draws are keyed by stream
    position, not by the worker that decodes."""
    files = [str(image_dir / n) for n in ("rgb.png", "grey.png", "pal.png", "rgba.png")]
    for a, b in zip(_take(files, 1, 5, batch=3), _take(files, 4, 5, batch=3)):
        np.testing.assert_array_equal(a, b)


def test_a_corrupt_file_is_tolerated(built, solid_dir):
    (solid_dir / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
    files = sorted(str(p) for p in solid_dir.glob("*.png"))
    batches = _take(files, 2, 6)
    assert all(np.isfinite(b).all() for b in batches)
    assert sorted(set(sum((_ids(b) for b in batches), []))) == list(range(12))


def test_nothing_decodes_raises_consecutive(built, tmp_path):
    for i in range(3):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / f"s{i}.png")
    ds = nl.NativeImageDataset(str(tmp_path / "*.png"), 16, 2, num_workers=2)
    with pytest.raises(RuntimeError, match="consecutive"):
        next(iter(ds))
    ds.close()


def test_close_stops_the_iterator_cleanly_even_from_another_thread(built, solid_dir):
    import threading

    files = sorted(str(p) for p in solid_dir.glob("*.png"))
    ds = nl.NativeImageDataset(files, 16, 2, seed=0)
    it = iter(ds)
    next(it)
    ds.close()
    assert list(it) == []
    ds.close()  # idempotent
    # a consumer blocked in dl_next (workers stalled by a full window) while
    # another thread closes: it returns, nothing is freed under it
    ds = nl.NativeImageDataset(files, 16, 2, seed=0, num_workers=1, prefetch=1)
    got = []
    t = threading.Thread(target=lambda: got.extend(ds))
    t.start()
    ds.close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_state_dict_set_state_and_the_resume_seed(built, solid_dir):
    files = sorted(str(p) for p in solid_dir.glob("*.png"))
    ds = nl.NativeImageDataset(files, 16, 4, seed=3)
    it = iter(ds)
    next(it), next(it)
    state = ds.state_dict()
    assert state == {"batches_served": 2, "resume_round": 0}
    with pytest.raises(RuntimeError, match="before iteration"):
        ds.set_state(state)
    ds.close()
    resumed = nl.NativeImageDataset(files, 16, 4, seed=3)
    resumed.set_state(state)
    fresh = nl.NativeImageDataset(files, 16, 4, seed=3 + 1_000_003)
    np.testing.assert_array_equal(next(iter(resumed)), next(iter(fresh)))
    assert resumed.state_dict() == {"batches_served": 3, "resume_round": 1}
    resumed.close()
    fresh.close()


def test_resume_through_the_runner_sidecar(built, solid_dir, tmp_path):
    """A Runner on the native loader (make_datasets' default), then a
    resumed one: the sidecar carries the loader's position and the new
    dataset resumes from it on a fresh stream."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.train.loop import Runner
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = tiny_test_config(dataset_pattern=str(solid_dir / "*.png"), steps_per_epoch=2,
                           epochs=1, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2,
                           log_dir=str(tmp_path / "logs"), data_workers=2)
    runner = Runner(cfg, device="cpu")
    assert isinstance(runner.dataset, nl.NativeImageDataset)
    runner.fit(log_samples=False)
    runner.close()
    extra = ckpt_lib.load_extra(cfg.checkpoint_dir)
    assert extra["data"]["dataset"] == {"batches_served": 2, "resume_round": 0}
    again = Runner(cfg.replace(epochs=2), device="cpu")
    assert again.dataset.state_dict() == {"batches_served": 2, "resume_round": 1}
    again.fit(log_samples=False)
    again.close()
    assert ckpt_lib.all_steps(cfg.checkpoint_dir)[-1] == 4
