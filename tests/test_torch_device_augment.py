"""Port parity of the HBM-resident uint8 input path:
gan_class_transfer2_tpu_torch.data (pipeline.EpochIndexStream,
device_augment) and the train steps' uint8 augment, against
gan_class_transfer2_tpu.data on the same numpy inputs, on the CPU.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so the augment is compared given the draws: the test re-derives the
offsets and flips that the JAX ``augment_batch`` draws from its key and hands
them to the port's ``apply_augment``. Every comparison is exact: the crop and
flip move bytes, and ``uint8·(1/128) − 1`` is exact in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.data import device_augment as jaug  # noqa: E402
from gan_class_transfer2_tpu.data import pipeline as jpipe  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data import device_augment as aug  # noqa: E402
from gan_class_transfer2_tpu_torch.data import pipeline  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402

torch.set_num_threads(1)


def _pool(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _jax_draws(key, b, h, w, size):
    """The offsets and flips jax augment_batch draws from ``key``
    (device_augment.py:38-46)."""
    r_crop, r_flip = jax.random.split(key)
    off = jax.random.randint(r_crop, (b, 2), 0, jnp.asarray([h - size + 1, w - size + 1]))
    flip = jax.random.bernoulli(r_flip, 0.5, (b,))
    return torch.from_numpy(np.array(off)), torch.from_numpy(np.array(flip))


@pytest.mark.parametrize("b, h, w, size, seed", [
    (4, 20, 20, 16, 0),
    (8, 24, 19, 16, 1),  # H ≠ W
    (3, 16, 16, 16, 2),  # no room to crop: offsets 0, flips only
    (6, 40, 36, 32, 3),
])
def test_apply_augment_equals_jax_augment_batch_on_its_draws(b, h, w, size, seed):
    raw = _pool(b, h, w, seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.augment_batch(jnp.asarray(raw), key, size=size))
    off, flip = _jax_draws(key, b, h, w, size)
    got = aug.apply_augment(torch.from_numpy(raw), off, flip, size)
    assert got.dtype == torch.float32 and got.shape == (b, size, size, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draw_augment_ranges_and_augment_batch_is_draw_then_apply():
    raw = torch.from_numpy(_pool(64, 21, 18))
    off, flip = aug.draw_augment(64, 21, 18, 16, torch.Generator().manual_seed(0))
    assert off.shape == (64, 2) and flip.shape == (64,) and flip.dtype == torch.bool
    assert 0 <= off[:, 0].min() and off[:, 0].max() <= 5 and 0 <= off[:, 1].min()
    assert off[:, 1].max() <= 2 and 0 < flip.sum() < 64
    got = aug.augment_batch(raw, torch.Generator().manual_seed(0), 16)
    assert torch.equal(got, aug.apply_augment(raw, off, flip, 16))
    assert got.min() >= -1 and got.max() <= 127 / 128


def test_epoch_index_stream_equals_jax_over_three_epochs_and_restores():
    """n = 10 at batch 4: batches straddle epochs (a ragged last batch of
    each epoch is filled from the next), over three epochs; a state taken
    mid-stream restores the rest of it."""
    mine, ref = pipeline.EpochIndexStream(10, 4, seed=3), jpipe.EpochIndexStream(10, 4, seed=3)
    got = [mine.next_indices() for _ in range(8)]
    want = [ref.next_indices() for _ in range(8)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    flat = np.concatenate(got)[:30].reshape(3, 10)
    assert all(sorted(epoch) == list(range(10)) for epoch in flat)
    assert mine.state_dict() == ref.state_dict() == {"epoch": 3, "offset": 2, "position": 8}
    again = pipeline.EpochIndexStream(10, 4, seed=3)
    mid = pipeline.EpochIndexStream(10, 4, seed=3)
    for _ in range(3):
        mid.next_indices()
    again.set_state(mid.state_dict())
    np.testing.assert_array_equal(np.stack([again.next_indices() for _ in range(5)]),
                                  np.stack(got[3:]))
    with pytest.raises(ValueError, match="empty"):
        pipeline.EpochIndexStream(0, 4)


def test_hbm_dataset_float_pool_draws_the_jax_batches():
    """A float32 pool is a plain gather: the port's batches equal the JAX
    HBMDataset's for the same (pool, batch_size, seed)."""
    pool = np.random.default_rng(1).uniform(-1, 1, (7, 16, 16, 3)).astype(np.float32)
    mine = iter(aug.HBMDataset(pool, 16, 3, seed=5, device="cpu"))
    ref = iter(jaug.HBMDataset(pool, 16, 3, seed=5))
    for _ in range(5):
        np.testing.assert_array_equal(next(mine).numpy(), np.asarray(next(ref)))


def test_hbm_dataset_uint8_draws_are_apply_augment_and_restore():
    """A uint8 pool's batch at stream position p is apply_augment of the
    pool's rows at the stream's indices, with the draws of a generator
    seeded from (seed, p); raw=True gives the rows themselves; set_state
    restores the exact batches."""
    pool = _pool(9, 20, 22, seed=4)
    ds = aug.HBMDataset(pool, 16, 4, seed=2, device="cpu")
    raw = aug.HBMDataset(pool, 16, 4, seed=2, raw=True, device="cpu")
    stream = pipeline.EpochIndexStream(9, 4, seed=2)
    it, it_raw = iter(ds), iter(raw)
    batches = []
    for pos in range(4):
        idx = stream.next_indices()
        got, rows = next(it), next(it_raw)
        assert rows.dtype == torch.uint8 and torch.equal(rows, torch.from_numpy(pool[idx]))
        gen = torch.Generator().manual_seed(aug._key(2, pos))
        off, flip = aug.draw_augment(4, 20, 22, 16, gen)
        assert torch.equal(got, aug.apply_augment(rows, off, flip, 16))
        batches.append(got)
    again = aug.HBMDataset(pool, 16, 4, seed=2, device="cpu")
    fresh = aug.HBMDataset(pool, 16, 4, seed=2, device="cpu")
    it_fresh = iter(fresh)
    next(it_fresh), next(it_fresh)
    again.set_state(fresh.state_dict())
    it_again = iter(again)
    assert all(torch.equal(next(it_again), b) for b in batches[2:])


def test_hbm_dataset_refusals():
    with pytest.raises(ValueError, match="pre-cropped"):
        aug.HBMDataset(np.zeros((2, 20, 20, 3), np.float32), 16, 2, device="cpu")
    with pytest.raises(ValueError, match="smaller than size"):
        aug.HBMDataset(np.zeros((2, 12, 20, 3), np.uint8), 16, 2, device="cpu")
    with pytest.raises(TypeError, match="uint8 or float32"):
        aug.HBMDataset(np.zeros((2, 16, 16, 3), np.float64), 16, 2, device="cpu")
    # a batch sharding (parallel/mesh.py) splits the global batch over the
    # ranks, which must divide it
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        aug.HBMDataset(np.zeros((2, 16, 16, 3), np.uint8), 16, 3,
                       sharding=mesh_lib.batch_sharding(mesh_lib.Mesh(2, 0, "cpu")))


def test_hbm_dataset_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        aug.HBMDataset(np.zeros((2, 16, 16, 3), np.uint8), 16, 2)


@pytest.mark.parametrize("overrides, labeled", [
    (dict(fused_diffusion=True), False),  # B1's plain version, the kernel's stream
    (dict(parameterization="epsilon", fused_diffusion=False), True),
])
def test_uint8_train_step_equals_the_float_step_on_the_same_draws(overrides, labeled):
    """train_step on a raw uint8 batch (a dict with ``"image"`` when
    labeled, as the JAX step takes it) equals train_step on apply_augment of
    the draws the step makes first: loss and params exactly."""
    cfg = tiny_test_config(**overrides)
    raw = torch.from_numpy(_pool(2, 19, 23, seed=6))

    def run(batch, gen):
        state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        state, loss = trainer.make_train_step(cfg)(state, batch, gen)
        return loss, list(state.model.parameters())

    wrap = (lambda x: {"image": x, "label": None}) if labeled else (lambda x: x)
    l1, p1 = run(wrap(raw), torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(8)
    off, flip = aug.draw_augment(2, 19, 23, cfg.size, gen)
    l2, p2 = run(wrap(aug.apply_augment(raw, off, flip, cfg.size)), gen)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_augment_if_uint8_keeps_dicts_and_passes_floats_without_drawing():
    cfg = tiny_test_config()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    x = torch.zeros((2, 16, 16, 3))
    assert trainer.augment_if_uint8(cfg, x, gen) is x
    labeled = {"image": x, "label": torch.tensor([1, 0])}
    assert trainer.augment_if_uint8(cfg, labeled, gen) is labeled
    assert torch.equal(gen.get_state(), state)
    raw = {"image": torch.from_numpy(_pool(2, 18, 18)), "label": torch.tensor([1, 0])}
    out = trainer.augment_if_uint8(cfg, raw, gen)
    assert out["label"] is raw["label"] and out["image"].shape == (2, 16, 16, 3)
    assert out["image"].dtype == torch.float32
    # the label reaches the class-conditional model as its class_idx
    cond = tiny_test_config(num_classes=2)
    model = api.init_denoiser(cond, device="cpu").requires_grad_(False)
    loss = trainer.diffusion_loss(cond, model, out, gen)
    other = trainer.diffusion_loss(cond, model, dict(out, label=torch.tensor([0, 0])),
                                   torch.Generator().manual_seed(0), t_int=torch.tensor([5, 5]),
                                   epsilon_in=torch.zeros(2, 16, 16, 3))
    same = trainer.diffusion_loss(cond, model, out, torch.Generator().manual_seed(0),
                                  t_int=torch.tensor([5, 5]), epsilon_in=torch.zeros(2, 16, 16, 3))
    assert np.isfinite(float(loss)) and float(other) != float(same)


def test_gan_step_on_uint8_batches_equals_the_float_step_on_the_same_draws():
    """gan_train_step on two raw uint8 batches equals the step on their
    augment_batch outputs, drawn in the step's order (a, then b) from the
    same generator state: losses and every net's params exactly."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.train import gan

    cfg = Config.from_json(tiny_test_config(g_norm="instance", d_norm="instance",
                                            diffaug="color,translation").to_json())
    a, b = (torch.from_numpy(_pool(2, 20, 18, seed=s)) for s in (7, 8))

    def run(xa, xb, gen):
        state = gan.init_gan_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        state, m = gan.make_gan_train_step(cfg)(state, xa, xb, gen)
        return m, [p for n in ("g_ab", "g_ba", "d_a", "d_b")
                   for p in getattr(state, n).parameters()]

    m1, p1 = run(a, b, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    xa = aug.augment_batch(a, gen, cfg.size)
    xb = aug.augment_batch(b, gen, cfg.size)
    m2, p2 = run(xa, xb, gen)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
