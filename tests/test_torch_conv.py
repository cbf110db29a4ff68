"""Port parity: gan_class_transfer2_tpu_torch.ops (conv, fused_down_conv,
image) against the TF goldens in tests/golden/conv_golden.npz and against
the JAX functions, on the same numpy inputs.

Tolerances: 1e-4 against the TF goldens (the bound test_conv.py holds the
JAX package to); 1e-5 between the two packages' float32 convs (both IEEE
float32 with different summation orders, over at most a few hundred terms);
1e-5 for the B4 plain version against the Pallas kernel in interpret mode
(the bound test_conv.py uses for that kernel)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.ops import conv as jconv  # noqa: E402
from gan_class_transfer2_tpu.ops import image as jimage  # noqa: E402
from gan_class_transfer2_tpu.ops import pallas_conv  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import _build  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import conv  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import image  # noqa: E402

torch.set_num_threads(1)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "conv_golden.npz"))


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _rand(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize(
    "x, k, b, stride, y",
    [
        ("x", "k_conv", "b_conv", 2, "y_conv"),
        ("x", "k3", "b3", 1, "y_conv3"),
        ("x7", "k_conv", None, 2, "y_conv7"),  # odd input: TF-SAME pads (1, 2)
    ],
)
def test_conv2d_matches_tf_golden(x, k, b, stride, y):
    out = conv.conv2d(T(GOLDEN[x]), T(GOLDEN[k]), T(GOLDEN[b]) if b else None, stride=stride)
    np.testing.assert_allclose(out.numpy(), GOLDEN[y], atol=1e-4)


def test_conv2d_transpose_matches_tf_golden():
    k = GOLDEN["k_convt_tf"].transpose(0, 1, 3, 2)  # TF (kh,kw,out,in) -> HWIO
    out = conv.conv2d_transpose(T(GOLDEN["x"]), T(k), T(GOLDEN["b_convt"]), stride=2)
    np.testing.assert_allclose(out.numpy(), GOLDEN["y_convt"], atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 7, 5), (1, 4, 6, 7)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ksize", [3, 4])
def test_conv2d_and_transpose_match_jax(shape, stride, ksize):
    x, k, b = _rand(0, shape, (ksize, ksize, shape[-1], 6), (6,))
    y = conv.conv2d(T(x), T(k), T(b), stride=stride, relu=True)
    y_ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride, relu=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    if stride == 2:
        yt = conv.conv2d_transpose(T(x), T(k), T(b), stride=2, relu=True)
        yt_ref = jconv.conv2d_transpose(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=2,
                                        relu=True)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yt_ref), atol=1e-5)


def test_dense_matches_jax():
    x, k, b = _rand(4, (2, 4, 4, 7), (7, 3), (3,))
    np.testing.assert_allclose(
        conv.dense(T(x), T(k), T(b)).numpy(),
        np.asarray(jconv.dense(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))), atol=1e-5)


@pytest.mark.parametrize("x_shape, o", [((2, 16, 16, 128), 256), ((1, 16, 16, 256), 256)])
def test_fused_down_conv_plain_matches_pallas_interpret(x_shape, o):
    """B4's plain version against the Pallas kernel run in interpret mode
    (as test_conv.py runs it); (1,16,16,256)→256 is the ntile=128 branch.
    On the CPU the wrapper takes the plain version and launches nothing."""
    r = np.random.default_rng(0)
    x = r.normal(size=x_shape).astype(np.float32)
    k = (r.normal(size=(4, 4, x_shape[-1], o)) * 0.05).astype(np.float32)
    b = r.normal(size=(o,)).astype(np.float32)
    assert fdc.supported(x.shape, k.shape) and pallas_conv.supported(x.shape, k.shape)
    ref = np.asarray(pallas_conv.down_conv_fused(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), True, True))
    before = fdc.down_conv_fused.launches
    np.testing.assert_allclose(fdc.down_conv_plain(T(x), T(k), T(b)).numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(fdc.down_conv_fused(T(x), T(k), T(b)).numpy(), ref, atol=1e-5)
    via_dispatch = conv.down_conv(T(x), T(k), T(b))
    np.testing.assert_allclose(via_dispatch.numpy(), ref, atol=1e-5)
    assert fdc.down_conv_fused.launches == before == 0


@pytest.mark.parametrize(
    "x_shape, k_shape",
    [
        ((2, 256, 256, 3), (4, 4, 3, 128)),  # stem: C=3
        ((2, 8, 8, 512), (4, 4, 512, 512)),  # bottleneck
        ((2, 128, 128, 128), (4, 4, 128, 256)),
        ((1, 16, 16, 256), (4, 4, 256, 192)),  # o not a multiple of the 128 tile
        ((1, 16, 16, 256), (4, 4, 256, 256)),
        ((1, 16, 16, 128), (4, 4, 128, 256)),
        ((1, 18, 16, 128), (4, 4, 128, 256)),
        ((1, 17, 16, 128), (4, 4, 128, 256)),  # odd H
        ((1, 16, 16, 128), (3, 3, 128, 256)),  # not k4
    ],
)
def test_supported_gate_matches_jax(x_shape, k_shape):
    assert fdc.supported(x_shape, k_shape) == pallas_conv.supported(x_shape, k_shape)


def test_plain_version_casts_operands_like_the_kernel():
    """bf16 input: weight and bias are rounded to bf16 first, the sum is
    float32, the result is bf16 — the kernel's arithmetic."""
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(size=(1, 16, 16, 128)).astype(np.float32)).bfloat16()
    k, b = T(r.normal(size=(4, 4, 128, 128)) * 0.05), T(r.normal(size=(128,)))
    y = fdc.down_conv_plain(x, k, b)
    assert y.dtype == torch.bfloat16 and y.is_contiguous()
    ref = fdc.down_conv_plain(x.float(), k.bfloat16().float(), b.bfloat16().float())
    np.testing.assert_array_equal(y.float().numpy(), ref.bfloat16().float().numpy())


def test_plain_version_keeps_float64():
    """A float64 x is summed in float64, not float32: the plain version (and
    so the CPU's route through B4's wrapper) equals ``F.conv2d`` in float64
    to 1e-12."""
    x, k, b = (torch.from_numpy(a).double() for a in _rand(8, (2, 16, 16, 128), (4, 4, 128, 256),
                                                          (256,)))
    y = fdc.down_conv_plain(x, k, b, relu=False)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b,
                                      stride=2, padding=1).permute(0, 2, 3, 1)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(conv.down_conv(x, k, b, relu=False), y)


def test_down_conv_dispatch_routes_unsupported_shapes_to_conv2d():
    x, k, b = _rand(6, (1, 16, 16, 8), (4, 4, 8, 16), (16,))
    y = conv.down_conv(T(x), T(k), T(b))
    np.testing.assert_allclose(
        y.numpy(), conv.conv2d(T(x), T(k), T(b), stride=2, relu=True).numpy(), atol=0)


@pytest.mark.parametrize("shape, window", [((2, 16, 16, 3), 4), ((1, 7, 9, 2), 4), ((1, 6, 6, 1), 3)])
def test_image_ops_match_jax(shape, window):
    x, d = _rand(7, shape, (shape[1], shape[2], 8, shape[3]))
    np.testing.assert_allclose(image.avg_pool(T(x), window).numpy(),
                               np.asarray(jimage.avg_pool(jnp.asarray(x), window)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(image.upsample_nearest(T(x), 2).numpy(),
                                  np.asarray(jimage.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(image.roll2d(T(x), 1, 2).numpy(),
                                  np.asarray(jimage.roll2d(jnp.asarray(x), 1, 2)))
    np.testing.assert_array_equal(image.vq_quantise(T(x), T(d)).numpy(),
                                  np.asarray(jimage.vq_quantise(jnp.asarray(x), jnp.asarray(d))))


@pytest.mark.parametrize("relu", [True, False])
def test_fused_down_conv_backward_matches_jax_vjp(relu):
    """B4's autograd on the CPU against ``jax.vjp`` of the Pallas kernel in
    interpret mode, at (2, 16, 16, 128) → 128: dx, dK and db. Both backwards
    are plain float32 convs (the ReLU mask from the saved output, db a
    float32 sum); they differ in summation order over at most
    4·O = 512 (dx) and B·H/2·W/2 = 128 (dK, db) terms: atol 1e-5 relative
    to the largest gradient of each."""
    r = np.random.default_rng(8)
    x = r.normal(size=(2, 16, 16, 128)).astype(np.float32)
    k = (r.normal(size=(4, 4, 128, 128)) * 0.05).astype(np.float32)
    b = (r.normal(size=(128,)) * 0.1).astype(np.float32)
    g = r.normal(size=(2, 8, 8, 128)).astype(np.float32)
    import jax

    _, vjp = jax.vjp(lambda x, k, b: pallas_conv.down_conv_fused(x, k, b, relu, True),
                     jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    xt, kt, bt = (T(a).requires_grad_() for a in (x, k, b))
    before = fdc.down_conv_fused.launches
    y = fdc.down_conv_fused(xt, kt, bt, relu)
    got = torch.autograd.grad(y, (xt, kt, bt), T(g))
    assert fdc.down_conv_fused.launches == before  # the CPU takes the plain version
    for name, a, w in zip(("dx", "dK", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max(), err_msg=name)


# the four down convs of the default U-Net that B4's gate admits, (H=W, C, O)
_B4_SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 512), (16, 512, 512))


def _k_ranges(p, c, dtype):
    """A plan's K ranges as the kernel walks them: for each split z, its
    whole slices as (di, dj, c0, c1), the tap (row di, column dj of the 4×4
    window) and the channels [c0, c1) of that tap, in the order summed."""
    bk = fdc.K_SLICE[dtype]
    per = p.k_slices // p.split
    out = []
    for z in range(p.split):
        part = []
        for kt in range(z * per, (z + 1) * per):
            tap, c0 = divmod(kt * bk, c)
            part.append((tap >> 2, tap & 3, c0, c0 + bk))
        out.append(part)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("shape", _B4_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
def test_down_conv_plan_fills_the_card(shape, batch, dtype):
    """B4's plan at the main path's shapes: the split divides the K slices,
    every slice stays within one tap, the workspace holds split × M × Opad,
    the tiles cover the output, and at least 7/8 of a full wave of blocks
    runs (132 SMs × 2 blocks in float32, × 1 in the 16-bit types, whose
    kernels share one body and so one plan)."""
    hw, c, o = shape
    dt = getattr(torch, dtype)
    p = fdc.plan(batch, hw, hw, c, o, dt)
    bk = fdc.K_SLICE[dt]
    assert p.k_slices * bk == 16 * c and p.k_slices % p.split == 0
    assert c % bk == 0  # so no K slice straddles two taps
    m = batch * (hw // 2) ** 2
    assert p.o_pad % 128 == 0 and o <= p.o_pad < o + 128 and p.tiles_n == p.o_pad // 128
    assert p.ws_elems == (p.split * m * p.o_pad if p.split > 1 else 0)
    if dt != torch.float32:
        assert p == fdc.plan(batch, hw, hw, c, o, torch.bfloat16)
        tw, th, tb = p.box
        assert tw * th * tb == 128 and 2 * tw <= 256 and 2 * th <= 256
        assert p.tiles_m * 128 >= m
    else:
        assert p.box == (0, 0, 0) and p.tiles_m == -(-m // 128)
    assert p.blocks >= fdc.FILL_TARGET[dt] >= 7 * _build.SM_COUNT // 8
    # 132 blocks or more; a 16-bit kernel (one block an SM) may stop at one
    # wave of 128 blocks, 4 SMs idle
    assert p.blocks >= _build.SM_COUNT or (dt != torch.float32 and p.blocks >= 128)
    # the smallest such split: half of it would not fill the card
    assert p.split == 1 or p.tiles_m * p.tiles_n * p.split // 2 < fdc.FILL_TARGET[dt]
    ranges = _k_ranges(p, c, dt)
    assert len(ranges) == p.split
    assert [s for part in ranges for s in part] == [
        (t >> 2, t & 3, c0, c0 + bk) for t in range(16) for c0 in range(0, c, bk)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_down_conv_plan_k_ranges_sum_to_the_conv(dtype):
    """The plan's K ranges, each summed as partial products over its taps and
    channels (the (tap, channel) indexing the kernel mirrors) and the ranges
    then summed in order, give the plain version's conv to 1e-5."""
    dt = getattr(torch, dtype)
    b, hw, c, o = 1, 16, 128, 128  # split 64 (f32) / 16 (bf16): one or two taps a range
    x, k, bias = (T(a) for a in _rand(21, (b, hw, hw, c), (4, 4, c, o), (o,)))
    k = k / np.sqrt(16 * c)
    p = fdc.plan(b, hw, hw, c, o, dt)
    assert p.split > 1
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # the SAME pad of even inputs
    h2 = hw // 2
    total = torch.zeros((b, h2, h2, o), dtype=torch.float64)
    for part in _k_ranges(p, c, dt):
        acc = torch.zeros((b, h2, h2, o), dtype=torch.float64)
        for di, dj, c0, c1 in part:
            window = xp[:, di:di + 2 * h2:2, dj:dj + 2 * h2:2, c0:c1].double()
            acc += window @ k[di, dj, c0:c1].double()
        total += acc
    got = (total + bias.double()).float()
    want = fdc.down_conv_plain(x, k, bias, relu=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
