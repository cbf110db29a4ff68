"""Port parity of serve/server.py: the service's device programs and its
codecs against gan_class_transfer2_tpu.serve.server, on the tiny config with
carried weights (``utils/weights.py``) and the same numpy noise.

The port's service draws its request noise from a ``torch.Generator``
seeded ``cfg.seed + 99`` at the padded batch's shape; the tests replay that
generator and hand the same noise to the JAX service's programs. Each
tolerance sits beside its test, with its reason."""

import io
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.sample import sampler as jsampler  # noqa: E402
from gan_class_transfer2_tpu.serve import server as jserver  # noqa: E402
from gan_class_transfer2_tpu.train import gan as jgan  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.serve import server  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import png, weights  # noqa: E402

torch.set_num_threads(1)


def _cfgs(**overrides):
    """The tiny config in both packages (the port's from the JAX JSON)."""
    jcfg = jconfig.tiny_test_config(**overrides)
    return jcfg, Config.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def services():
    """A JAX service and the port's on the same diffusion and cycle-GAN
    weights (instance norms on, so /transfer runs B3's plain version)."""
    jcfg, cfg = _cfgs(g_norm="instance", sample_stride=3)
    jstate = jtrainer.init_state(jcfg, jax.random.PRNGKey(0))
    jgstate = jgan.init_gan_state(jcfg, jax.random.PRNGKey(1))
    state = weights.from_jax_train_state(cfg, jax.tree_util.tree_map(np.asarray, jstate),
                                         device="cpu")
    gstate = weights.from_jax_gan_state(cfg, jax.tree_util.tree_map(np.asarray, jgstate),
                                        device="cpu")
    jsvc = jserver.ModelService(jcfg, state=jstate, gan_state=jgstate)
    svc = server.ModelService(cfg, state=state, gan_state=gstate, device="cpu")
    yield jsvc, svc, cfg
    jsvc.close()
    svc.close()


def _replay(svc, shape):
    """The noise the service's next draw of ``shape`` gives, without
    advancing its generator."""
    g = torch.Generator().manual_seed(0)
    g.set_state(svc._gen.get_state())
    return torch.randn(shape, generator=g)


def _image(cfg, seed=0, n=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, cfg.size, cfg.size, 3)).astype(
        np.float32)


def _close(port, ref, rel):
    """|port − ref| within ``rel`` of the array's scale (max(1, max|ref|))."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(np.asarray(port) - ref).max() <= rel * scale


def test_sample_batch_matches_jax_within_one_level(services):
    """/sample's uint8 batch (num 3, padded to 4) against JAX's device
    program on the same noise. Both quantise by clip-then-truncate, so a
    float32 difference of ~1e-6 can only flip a value that sits on a level
    boundary: at most 1 level, on at most 1e-3 of the values."""
    jsvc, svc, cfg = services
    init = _replay(svc, (4, cfg.size, cfg.size, 3))
    got = svc.sample(3)
    want = np.asarray(jsvc._sample(jsvc._params, jnp.asarray(init.numpy()), None))[:3]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3, 16, 16, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # the service drew its noise at the padded bucket's shape
    np.testing.assert_array_equal(got, svc._sample_prog(svc._model, init)[:3].numpy())


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_stream_segments_match_jax_and_end_on_the_full_sample(services, segments):
    """Each streamed state against JAX's make_segment_fn over the same
    splits of the visit order, within 1e-5 of the array's scale (IEEE
    float32 on both sides through at most 4 denoiser calls at stride 3);
    the last state equals the port's full sample on the same noise."""
    jsvc, svc, cfg = services
    init = _replay(svc, (1, cfg.size, cfg.size, 3))
    frames = list(svc.sample_stream(1, segments=segments))
    seg = jsampler.make_segment_fn(jsvc.cfg)
    x = e = jnp.asarray(init.numpy())
    ts_all = sampler.sample_timesteps(cfg)
    assert len(frames) == min(segments, len(ts_all))
    for frame, ts in zip(frames, np.array_split(ts_all, len(frames))):
        x, e = seg(jsvc._params, x, e, jnp.asarray(ts))
        _close(frame, np.asarray(x)[:1], 1e-5)
    full = sampler.sample(cfg, svc._model, init, snapshots=False).images.numpy()
    np.testing.assert_array_equal(frames[-1], full)


def test_denoise_matches_jax_preview(services):
    """/denoise (one preview forward) against JAX's preview program on the
    same image and noise, within 1e-5 of the array's scale."""
    jsvc, svc, cfg = services
    img = _image(cfg, 1)
    noise = _replay(svc, img.shape).numpy()
    got = svc.denoise(img)
    want = np.asarray(jsvc._preview(jsvc._params, img, noise))
    assert got.shape == img.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("direction", ["ab", "ba"])
def test_transfer_matches_jax(services, direction):
    """/transfer through the generator with instance norms (B3's plain
    version on the CPU) against the JAX service, batch 3 padded to 4;
    1e-5 absolute, as test_torch_gan's transfer."""
    jsvc, svc, cfg = services
    img = _image(cfg, 2, n=3)
    np.testing.assert_allclose(svc.transfer(img, direction), jsvc.transfer(img, direction),
                               atol=1e-5)


def test_edit_with_the_carried_dictionary_matches_jax(services):
    """/edit (T invert steps, then the candidates decoded) with JAX's VQ
    dictionary carried in, against the JAX service's edit; within 1e-4 of
    the array's scale (test_torch_sampler's bound for these chains)."""
    jsvc, svc, cfg = services
    img = _image(cfg, 3)
    dictionary = jax.random.normal(jax.random.PRNGKey(cfg.seed),
                                   (cfg.size, cfg.size, 2**cfg.bits_per_pixel, 3), jnp.float32)
    svc.edit_dictionary = torch.from_numpy(np.array(dictionary))
    try:
        got = svc.edit(img, ("shift", "quantise", "pixelate"))
    finally:
        svc.edit_dictionary = None
    want = jsvc.edit(img, ("shift", "quantise", "pixelate"))
    # keys in JAX's order (its jitted program returns them sorted): the
    # JSON and .npz answers list them so
    assert list(got) == list(want) == ["pixelate", "quantise", "reconstruction", "shift"]
    for name in want:
        _close(got[name], want[name], 1e-4)


# ------------------------------------------------------------------ codecs


def _batches():
    r = np.random.default_rng(4)
    return [r.integers(0, 256, (2, 5, 6, 3), dtype=np.uint8),
            r.uniform(-1.2, 1.2, (3, 4, 4, 3)).astype(np.float32)]


@pytest.mark.parametrize("i", [0, 1])
def test_npy_and_npz_bytes_are_jax_s(i, monkeypatch):
    """The raw response formats, byte for byte (the zip entries' timestamps
    are taken from the clock, held fixed here)."""
    batch = _batches()[i]
    assert server._npy_bytes(batch) == jserver._npy_bytes(batch)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    named = {"reconstruction": batch, "shift": batch[::-1]}
    assert server._npz_bytes(named) == jserver._npz_bytes(named)


def _pil_bytes(arr, fmt="PNG", mode=None):
    buf = io.BytesIO()
    img = Image.fromarray(arr)
    (img.convert(mode) if mode else img).save(buf, format=fmt)
    return buf.getvalue()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


_R = np.random.default_rng(5)
_SQ = _R.integers(0, 256, (16, 16, 3), dtype=np.uint8)
_BODIES = {
    "png_rgb": _pil_bytes(_SQ),
    "png_rgba": _pil_bytes(_SQ, mode="RGBA"),
    "png_grey": _pil_bytes(_SQ, mode="L"),
    "png_palette": _pil_bytes(_SQ, mode="P"),
    "png_port_writer": png.encode_png(_SQ),
    "jpeg": _pil_bytes(_SQ, fmt="JPEG"),
    "npy_hw3": _npy(_SQ),
    "npy_1hw3": _npy(_SQ[None]),
    "png_off_size_up": _pil_bytes(_R.integers(0, 256, (11, 13, 3), dtype=np.uint8)),
    "png_off_size_down": _pil_bytes(_R.integers(0, 256, (40, 24, 3), dtype=np.uint8)),
}


@pytest.mark.parametrize("name", sorted(_BODIES))
def test_decode_image_is_jax_s_bit_for_bit(name):
    """Request bodies decode to JAX's float32 pixels exactly: size² PNGs of
    every colour type through utils/png, a JPEG and off-size PNGs through
    Pillow (resampled by Pillow's own resize, as JAX does), .npy as is."""
    got = server._decode_image(_BODIES[name], 16)
    want = jserver._decode_image(_BODIES[name], 16)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", [0, 1])
def test_png_bytes_decode_to_jax_s_pixels(i):
    """The port writes its PNGs with utils/png, JAX with Pillow: other bytes,
    the same pixels."""
    img = _batches()[i][0]
    got, want = server._png_bytes(img), jserver._png_bytes(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(got))),
                                  np.asarray(Image.open(io.BytesIO(want))))
    np.testing.assert_array_equal(png.decode_png(got), png.decode_png(want))


_ERRORS = [
    ("spec_not_object", lambda m: m.SampleSpec([1])),
    ("spec_null_num", lambda m: m.SampleSpec({"num": None})),
    ("spec_text_num", lambda m: m.SampleSpec({"num": "many"})),
    ("spec_num_range", lambda m: m.SampleSpec({"num": 65})),
    ("spec_num_zero", lambda m: m.SampleSpec({"num": 0})),
    ("spec_format", lambda m: m.SampleSpec({"format": "jpeg"})),
    ("spec_segments", lambda m: m.SampleSpec({"stream": True, "segments": 10**9})),
    ("spec_stream_num", lambda m: m.SampleSpec({"stream": True, "num": 2})),
    ("image_format", lambda m: m._image_format({"format": ["jpeg"]})),
    ("npy_dtype", lambda m: m._decode_image(_npy(np.zeros((16, 16, 3), np.float32)), 16)),
    ("npy_rank", lambda m: m._decode_image(_npy(np.zeros((16, 16), np.uint8)), 16)),
    ("npy_channels", lambda m: m._decode_image(_npy(np.zeros((16, 16, 4), np.uint8)), 16)),
    ("npy_batch", lambda m: m._decode_image(_npy(np.zeros((2, 16, 16, 3), np.uint8)), 16)),
    ("npy_size", lambda m: m._decode_image(_npy(np.zeros((32, 32, 3), np.uint8)), 16)),
    ("npy_truncated", lambda m: m._decode_image(b"\x93NUMPY garbage", 16)),
]


@pytest.mark.parametrize("call", [c for _, c in _ERRORS], ids=[n for n, _ in _ERRORS])
def test_error_strings_are_jax_s(call):
    """SampleSpec's, _image_format's and the .npy validation's ValueErrors
    (the 400 bodies) read as JAX's, word for word."""
    with pytest.raises(ValueError) as got:
        call(server)
    with pytest.raises(ValueError) as want:
        call(jserver)
    assert str(got.value) == str(want.value)


def test_garbage_bodies_are_value_errors():
    """Undecodable uploads are a client error (400), PNG-signed or not."""
    for body in (b"garbage", png.SIGNATURE + b"garbage"):
        with pytest.raises(ValueError, match="not a decodable image"):
            server._decode_image(body, 16)
