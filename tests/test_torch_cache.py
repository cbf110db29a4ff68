"""The port's dataset cache (data/cache.py, native_loader.build_cache, cli
build-cache) and make_datasets' routing, against the JAX package on the same
files. Exact: the cache files are compared byte for byte, the batches
element for element, and the device augment is held on JAX's own draws (as
tests/test_torch_device_augment.py does: jax.random and torch.Generator
give different numbers from one seed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402

from gan_class_transfer2_tpu import cli as jcli  # noqa: E402
from gan_class_transfer2_tpu.data import cache as jcache  # noqa: E402
from gan_class_transfer2_tpu.data import native_loader as jnl  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data import cache  # noqa: E402
from gan_class_transfer2_tpu_torch.data import device_augment as aug  # noqa: E402
from gan_class_transfer2_tpu_torch.data import native_loader as nl  # noqa: E402
from gan_class_transfer2_tpu_torch.data import pipeline  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Varied sizes (the resize path), one store-sized file (no resize),
    grey and palette PNGs, a JPEG, a 1×50 strip (skipped as degenerate)
    and a broken file (skipped as undecodable)."""
    if not nl.available() or not jnl.available():
        pytest.fail(f"native loaders do not build: {nl.build_error()}")
    d = tmp_path_factory.mktemp("cache_imgs")
    r = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(r.integers(0, 256, (24 + 3 * i, 20 + 5 * i, 3),
                                   dtype=np.uint8)).save(d / f"img_{i}.png")
    Image.fromarray(r.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / "exact.png")
    Image.fromarray(r.integers(0, 256, (30, 22), dtype=np.uint8)).save(d / "grey.png")
    Image.fromarray(r.integers(0, 256, (21, 27, 3), dtype=np.uint8)).quantize(32).save(
        d / "pal.png")
    Image.fromarray(r.integers(0, 256, (26, 26, 3), dtype=np.uint8)).save(d / "photo.jpg")
    Image.fromarray(r.integers(0, 256, (1, 50, 3), dtype=np.uint8)).save(d / "strip.png")
    (d / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    return sorted(str(p) for p in d.iterdir())


@pytest.mark.parametrize("store", [16, 20])
def test_build_cache_is_byte_identical_to_jax(files, tmp_path, store):
    ours, theirs = str(tmp_path / "ours.cache"), str(tmp_path / "theirs.cache")
    n = nl.build_cache(files, store, ours)
    assert n == jnl.build_cache(files, store, theirs) == len(files) - 2  # strip, broken
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    data, s = cache.read_cache(ours)
    assert s == store and data.shape == (n, store, store, 3) and data.dtype == np.uint8


def test_build_cache_errors(files, tmp_path):
    with pytest.raises(RuntimeError, match="no file decoded"):
        nl.build_cache([f for f in files if "broken" in f], 16, str(tmp_path / "x.cache"))
    with pytest.raises(RuntimeError, match="cache build failed"):
        nl.build_cache(files, 16, str(tmp_path / "missing" / "x.cache"))
    (tmp_path / "junk").write_bytes(b"\0" * 32)
    with pytest.raises(ValueError, match="not a GCT2 dataset cache"):
        cache.read_cache(str(tmp_path / "junk"))


def test_cached_dataset_equals_jax_and_restores(files, tmp_path):
    path = str(tmp_path / "c.cache")
    nl.build_cache(files, 18, path)
    ours, theirs = cache.CachedDataset(path, 3, seed=4), jcache.CachedDataset(path, 3, seed=4)
    assert len(ours) == len(theirs)
    a, b = iter(ours), iter(theirs)
    for _ in range(7):  # over two epochs of 9 records
        np.testing.assert_array_equal(next(a), next(b))
    state = ours.state_dict()
    assert state == theirs.state_dict()
    again = cache.CachedDataset(path, 3, seed=4)
    again.set_state(state)
    np.testing.assert_array_equal(next(iter(again)), next(a))


def test_augmented_cached_dataset_equals_jax_on_its_draws(files, tmp_path, monkeypatch):
    """The port's batch at stream position p is apply_augment of the raw
    batch with the offsets and flips JAX draws from fold_in(PRNGKey(seed +
    101), p); the port's own generator is seeded from (seed + 101, p)."""
    import jax.numpy as jnp

    path = str(tmp_path / "c.cache")
    nl.build_cache(files, 20, path)
    seed, size, b = 2, 16, 4
    positions = []
    real_key = aug._key

    def key(s, pos):
        positions.append((s, pos))
        return real_key(s, pos)

    def jax_draws(n, h, w, sz, generator):
        s, pos = positions[-1]
        k = jax.random.fold_in(jax.random.PRNGKey(s), pos)
        r_crop, r_flip = jax.random.split(k)
        off = jax.random.randint(r_crop, (n, 2), 0, jnp.asarray([h - sz + 1, w - sz + 1]))
        flip = jax.random.bernoulli(r_flip, 0.5, (n,))
        return torch.from_numpy(np.array(off)), torch.from_numpy(np.array(flip))

    monkeypatch.setattr(aug, "_key", key)
    monkeypatch.setattr(aug, "draw_augment", jax_draws)
    ours = cache.AugmentedCachedDataset(path, size, b, seed=seed, device="cpu")
    theirs = jcache.AugmentedCachedDataset(path, size, b, seed=seed)
    for x, y in zip(_take(ours, 3), _take(theirs, 3)):
        assert x.dtype == torch.float32 and x.shape == (b, size, size, 3)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert [p for _, p in positions[-3:]] == [1, 2, 3] and positions[-1][0] == seed + 101


def _take(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


def test_augmented_cached_dataset_replays_after_set_state(files, tmp_path):
    path = str(tmp_path / "c.cache")
    nl.build_cache(files, 20, path)
    ds = cache.AugmentedCachedDataset(path, 16, 2, seed=1, device="cpu")
    it = iter(ds)
    next(it), next(it)
    state = ds.state_dict()
    want = next(it)
    again = cache.AugmentedCachedDataset(path, 16, 2, seed=1, device="cpu")
    again.set_state(state)
    assert torch.equal(next(iter(again)), want)
    assert want.min() >= -1 and want.max() <= 127 / 128
    with pytest.raises(ValueError, match="smaller than crop"):
        cache.AugmentedCachedDataset(path, 24, 2, device="cpu")


def test_cached_dataset_trains_the_runner(files, tmp_path):
    from gan_class_transfer2_tpu_torch.train.loop import Runner

    path = str(tmp_path / "c.cache")
    nl.build_cache(files, 18, path)
    cfg = tiny_test_config(checkpoint_dir=None, log_dir=str(tmp_path / "logs"))
    ds = cache.AugmentedCachedDataset(path, cfg.size, cfg.batch_size, device="cpu")
    runner = Runner(cfg, dataset=ds, device="cpu")
    runner.fit(epochs=1, steps_per_epoch=2, log_samples=False)
    runner.close()
    assert int(runner.state.step) == 2


def test_cli_build_cache_writes_the_jax_cli_file(files, tmp_path, capsys):
    src = [f for f in files if f.endswith(".png")]
    d = tmp_path / "src"
    d.mkdir()
    for f in src:
        (d / f.rsplit("/", 1)[1]).write_bytes(open(f, "rb").read())
    pattern = str(d / "*.png")
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    common = ["--dataset-pattern", pattern, "--size", "16", "--octaves", "2"]
    assert cli.main(["build-cache", "--device", "cpu", *common, "--out", ours]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jcli.main(["build-cache", "--platform", "cpu", *common, "--out", theirs]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == line.replace(ours, theirs)
    assert line == f"wrote {len(src) - 2} records (18x18x3 uint8) to {ours}"
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_make_datasets_routes_native_cache_and_the_build_failure(files, tmp_path, capsys,
                                                                 monkeypatch):
    good = [f for f in files if "img_" in f]
    cfg = tiny_test_config(classes=(good[0].rsplit("/", 1)[0] + "/img_*.png",), data_workers=1)
    (ds,) = pipeline.make_datasets(cfg, device="cpu")
    assert isinstance(ds, nl.NativeImageDataset) and ds.num_workers == 1
    assert next(iter(ds)).shape == (cfg.batch_size, cfg.size, cfg.size, 3)
    ds.close()
    assert capsys.readouterr().out == ""
    (ds,) = pipeline.make_datasets(cfg.replace(cache=True), device="cpu")
    assert type(ds) is pipeline.ImageDataset and ds._cache == {}
    assert "cache=True: using the Python pipeline" in capsys.readouterr().out
    monkeypatch.setattr(nl, "available", lambda: False)
    monkeypatch.setattr(nl, "build_error",
                        lambda: "C++ build of dataloader.cc failed (exit 1):\n"
                                "x.cc:1: fatal error: png.h: No such file or directory")
    (ds,) = pipeline.make_datasets(cfg, device="cpu")
    assert type(ds) is pipeline.ImageDataset
    out = capsys.readouterr().out
    assert "did not build (x.cc:1: fatal error: png.h: No such file or directory)" in out
