"""The port's TensorBoard writer and grid renderer (utils/tensorboard.py,
utils/grid.py) against the JAX package's: the JAX ``read_events`` and the
``tensorboard`` package read the port's event files with the same tags,
steps and values; CRC32C from the Python table equals JAX's; the PNG
payloads decode (through Pillow) to the pixels JAX's writer stores; and the
grid PNGs hold the same pixels. All exact: the same integer arithmetic."""

import io

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gan_class_transfer2_tpu.utils import grid as jgrid  # noqa: E402
from gan_class_transfer2_tpu.utils import tensorboard as jtb  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import grid, png  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import tensorboard as tb  # noqa: E402


def _write(mod, log_dir):
    r = np.random.default_rng(0)
    w = mod.SummaryWriter(str(log_dir))
    w.scalar("example loss", 0.125, 3)
    w.scalar("loss", 1.0 / 3.0, 4)
    w.image("denoised", r.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32), 3)
    w.image("fake", r.uniform(-0.2, 1.2, (4, 6, 5, 3)).astype(np.float32), 3, max_outputs=3)
    w.image("gray", np.linspace(0, 1, 2 * 8 * 8, dtype=np.float32).reshape(2, 8, 8), 5, 2)
    w.image("u8", r.integers(0, 256, (7, 9, 3), dtype=np.uint8), 6)
    w.close()
    return w.path


def _pixels(data):
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img)


def test_jax_reader_reads_the_port_events_as_its_own(tmp_path):
    ours = list(jtb.read_events(_write(tb, tmp_path / "port")))
    theirs = list(jtb.read_events(_write(jtb, tmp_path / "jax")))
    assert [(s, t, k) for s, t, k, _ in ours] == [(s, t, k) for s, t, k, _ in theirs]
    assert {t for _, t, _, _ in ours} >= {"example loss", "loss", "denoised/image",
                                          "fake/image/0", "fake/image/2", "gray/image/1",
                                          "u8/image"}
    for (_, tag, kind, a), (_, _, _, b) in zip(ours, theirs):
        if kind == "scalar":
            assert a == b, tag
        elif kind == "image":
            np.testing.assert_array_equal(_pixels(a), _pixels(b), err_msg=tag)
    # and the port's own reader reads both the same way
    assert [e[:3] for e in tb.read_events(_write(tb, tmp_path / "again"))] == \
        [e[:3] for e in ours]


def test_tensorboard_package_reads_the_port_events(tmp_path):
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    path = _write(tb, tmp_path)
    acc = ea_mod.EventAccumulator(path, size_guidance={ea_mod.IMAGES: 0, ea_mod.SCALARS: 0})
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"example loss", "loss"}
    (ev,) = acc.Scalars("loss")
    assert ev.step == 4 and ev.value == np.float32(1.0 / 3.0)
    (img,) = acc.Images("denoised/image")
    assert (img.width, img.height, img.step) == (8, 8, 3)
    assert _pixels(img.encoded_image_string).shape == (8, 8, 3)


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256)) * 3])
def test_crc32c_equals_jax(data):
    assert tb.crc32c(data) == jtb.crc32c(data)
    assert tb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_png_payloads_decode_with_the_port_decoder(tmp_path):
    for _, tag, kind, payload in tb.read_events(_write(tb, tmp_path)):
        if kind == "image" and not tag.startswith("gray"):
            np.testing.assert_array_equal(png.decode_png(payload), _pixels(payload)[..., :3])


def test_grid_png_pixels_equal_jax(tmp_path):
    images = np.random.default_rng(1).uniform(-1, 1, (6, 5, 4, 3)).astype(np.float32)
    ours = grid.grid_png(images, str(tmp_path / "a" / "grid.png"), cols=4)
    theirs = jgrid.grid_png(images, str(tmp_path / "b" / "grid.png"), cols=4)
    with Image.open(theirs) as img:
        want = np.asarray(img)
    np.testing.assert_array_equal(png.read_png(ours), want)
    assert want.shape == (10, 16, 3)


def test_null_writer_and_reference_log_dir(tmp_path):
    w = tb.NullWriter()
    w.scalar("x", 1.0, 0)
    w.image("y", np.zeros((1, 2, 2, 3)), 0)
    w.close()
    assert w.path is None
    d = tb.reference_log_dir(str(tmp_path))
    day, hms = d.split("/")[-2:]
    assert len(day) == 8 and day.isdigit() and len(hms) == 6 and hms.isdigit()
