"""The conv epilogue (ops/conv_epilogue.py): ``act(other + (y + bias))``
after a conv, with its hand-written CUDA kernel pair on the card.

On the CPU the op is the torch-op composition the convs ran before, so the
Function's value and every gradient equal that composition's bit for bit,
once and twice differentiated. On the card (tests marked ``cuda``) the
kernel is held against the plain version at the train cell's six up-conv
outputs and its first down conv's (batch 2), and at shapes that take the
scalar route: float32 forwards bit for bit (the same float32 adds in the
same order), bfloat16 and float16 within a few output roundings of
max|out| (the kernel rounds once where the composition rounds after each
op: 1e-2 and 2e-3), gs bit for bit, db within 1e-5 of max|db| in float32
(sums in another order), 1e-2 in bfloat16 and 2e-3 in float16 (db rounded
to the 16-bit type); a float32 bias takes a float32 db whatever
the gradient's dtype, B4's backward included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu_torch.ops import conv  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import conv_epilogue as ce  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402

torch.set_num_threads(1)

# the train cell's (ddpm-unet256, batch 256) up-conv outputs, and down0's,
# at batch 2: (H, W, C) and whether a (branch, skip) pair sums into it
CELL_SHAPES = (((256, 256, 64), True), ((128, 128, 128), True), ((64, 64, 256), True),
               ((32, 32, 512), True), ((16, 16, 512), True), ((8, 8, 512), False),
               ((128, 128, 128), False))
FWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2, torch.float16: 2e-3}
DB_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _inputs(seed, shape, dtype, two, bias, device="cpu"):
    r = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(r.normal(size=s)).to(device=device, dtype=dtype)  # noqa: E731
    y = mk(*shape)
    other = mk(*shape) if two else None
    b = mk(shape[-1]) if bias else None
    return y, b, other


def _leaves(*ts):
    return [None if t is None else t.clone().requires_grad_() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("branches", [1, 2])
def test_epilogue_matches_torch_composition(branches, bias, relu, dtype):
    """The Function and the op against ``y + bias``, ``other + ·``, ``relu``
    in torch ops: value and the gradients of y, bias and other, equal."""
    y, b, o = _inputs(branches * 8 + bias * 4 + relu * 2, (2, 5, 6, 7), dtype, branches == 2,
                      bias)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 5, 6, 7))).to(dtype)
    got_in, want_in = _leaves(y, b, o), _leaves(y, b, o)
    launches = ce.conv_epilogue.launches
    got = ce.ConvEpilogue.apply(got_in[0], got_in[1], relu, got_in[2])
    want = ce.epilogue_plain(want_in[0], want_in[1], relu, want_in[2])
    assert torch.equal(got, want)
    assert torch.equal(ce.conv_epilogue(y, b, relu, o), want.detach())
    live = [i for i, t in enumerate(got_in) if t is not None]
    gg = torch.autograd.grad(got, [got_in[i] for i in live], g)
    gw = torch.autograd.grad(want, [want_in[i] for i in live], g)
    for i, a, w in zip(live, gg, gw):
        assert a.dtype == w.dtype and torch.equal(a, w), ("y", "bias", "other")[i]
    assert ce.conv_epilogue.launches == launches  # the CPU takes the torch ops


def test_epilogue_returns_its_input_when_there_is_nothing_to_do():
    y = torch.ones(2, 3, 3, 4)
    assert ce.conv_epilogue(y) is y
    assert conv.conv2d(y, torch.ones(1, 1, 4, 4)).shape == (2, 3, 3, 4)


def _second_order(fn, y, b, o, relu, g):
    """d/d(y, bias, other, g) of Σ(dL/dy)² + Σ dL/dbias with dL/dy and
    dL/dbias taken with create_graph (R1's pattern)."""
    ins = [t for t in (y, b, o) if t is not None]
    out = fn(y, b, relu, o)
    gy, gb = torch.autograd.grad(out, [y, b], g, create_graph=True)
    loss = (gy * gy).sum() + (gb * torch.arange(gb.numel(), dtype=gb.dtype, device=gb.device)).sum()
    return torch.autograd.grad(loss, ins + [g], allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_double_backward_matches_and_is_counted(relu):
    """A ``create_graph=True`` backward through the Function keeps torch
    ops, counts one ``graph_backwards`` and differentiates again as the
    composition does."""
    y, b, o = _inputs(3, (2, 4, 4, 6), torch.float64, True, True)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 4, 4, 6)))
    before = ce.ConvEpilogue.graph_backwards
    got = _second_order(ce.ConvEpilogue.apply, *_leaves(y, b, o), relu, g.clone().requires_grad_())
    assert ce.ConvEpilogue.graph_backwards == before + 1
    want = _second_order(ce.epilogue_plain, *_leaves(y, b, o), relu, g.clone().requires_grad_())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)


def test_down_conv_double_backward_through_the_epilogue():
    """B4's backward takes its ReLU mask and db from ``epilogue_backward``:
    with create_graph it keeps torch ops, counts one ``graph_backwards``
    and its second-order gradients match autograd's twice through the
    plain version within 1e-5 of the largest: on the CPU both convolve in
    the input's float64 (``down_conv_plain``, B4's backward)."""
    r = np.random.default_rng(5)
    x, k, b = (torch.from_numpy(r.normal(size=s)) for s in ((2, 8, 8, 4), (4, 4, 4, 6), (6,)))

    def second(fn):
        xs, ks, bs = _leaves(x, k, b)
        y = fn(xs, ks, bs, True)
        gx, gk, gb = torch.autograd.grad(y.square().sum(), [xs, ks, bs], create_graph=True)
        return torch.autograd.grad(gx.square().sum() + gb.sum(), [xs, ks, bs])

    before = ce.ConvEpilogue.graph_backwards
    got = second(fdc.down_conv_fused)
    assert ce.ConvEpilogue.graph_backwards == before + 1
    for a, w in zip(got, second(fdc.down_conv_plain)):
        assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_plan_cuts_by_shape():
    """16-byte vectors where C allows it, one element otherwise; lanes the
    least power of 2 over the channel vectors, at most 32; the grid within
    8 blocks an SM."""
    assert ce.plan(256 * 256 * 256, 64, 2, True) == (8, 8, 132 * 8)
    assert ce.plan(256 * 16 * 16, 512, 4, True) == (4, 32, 132 * 8 // 4)  # 4 blocks along C
    assert ce.plan(100, 3, 2, True) == (1, 4, 1)
    assert ce.plan(100, 64, 2, False).vec == 1
    assert ce.plan(1, 12, 4, True) == (4, 4, 1)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    y = torch.empty((2, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ce.epilogue_fused(y, None, True)
    for kind in ("fwd", "bwd"):  # a float64 CUDA tensor raises
        with pytest.raises(TypeError, match="float32, bfloat16 or float16 only"):
            ce._entry(kind, torch.float64)


@pytest.mark.parametrize("route", ["conv2d", "up_conv", "pair"])
def test_conv_routes_take_the_epilogue_by_impl(route, monkeypatch):
    """ops/conv.py hands every TF-SAME conv's tail to ``conv_epilogue``:
    ``conv2d``, ``up_conv`` and a concat pair (``other``, summed in the
    second conv's epilogue); on the CPU the value is ``epilogue_plain``'s
    over the raw convs, bit for bit."""
    calls = []
    real = ce.conv_epilogue

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(conv, "conv_epilogue", spy)
    x = _inputs(11, (2, 6, 6, 5), torch.float64, False, False)[0]
    kernel = torch.from_numpy(np.random.default_rng(12).normal(size=(3, 3, 5, 4)))
    bias = torch.ones(4, dtype=torch.float64)
    if route == "conv2d":
        got = conv.conv2d(x, kernel, bias, relu=True)
        want = ce.epilogue_plain(conv._conv_strided_raw(x, kernel, 1), bias, True)
    elif route == "up_conv":
        k4 = kernel[:2, :2].repeat(2, 2, 1, 1)
        got = conv.up_conv(x, k4, bias, relu=True)
        want = ce.epilogue_plain(conv._convt_raw(x, k4, 2), bias, True)
        assert got.shape == (2, 12, 12, 4)
    else:
        a = x.flip(1)
        ya = conv.conv2d(a, kernel, None)
        got = conv.conv2d(x, kernel, bias, relu=True, other=ya)
        want = ce.epilogue_plain(conv._conv_strided_raw(x, kernel, 1), bias, True,
                                 conv._conv_strided_raw(a, kernel, 1))
    assert torch.equal(got, want)
    assert calls[-1][1] is bias and calls[-1][2] is True
    assert len(calls) == (2 if route == "pair" else 1)
    assert (calls[-1][3] is ya) if route == "pair" else calls[-1][3] is None


# ------------------------------------------------------------------ card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _rel(a, w):
    scale = w.float().abs().max().item()
    return (a.float() - w.float()).abs().max().item() / (scale or 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_epilogue_kernel_matches_plain_on_card(dtype):
    """Forward and backward kernels against the plain version at the cell's
    shapes at batch 2 and at scalar-route shapes (C = 3, C = 12, a
    misaligned view); two launches bit-identical; launches counted: 1 a
    forward, 2 a backward with db. Prints the worst relative errors."""
    _needs_card()
    worst = {"out": 0.0, "db": 0.0}
    cases = [((2,) + s, two) for s, two in CELL_SHAPES] + [((3, 5, 7, 3), True),
                                                          ((2, 9, 4, 12), False)]
    for n, (shape, two) in enumerate(cases):
        y, b, o = _inputs(n, shape, dtype, two, True, "cuda")
        for relu in (True, False):
            before = ce.conv_epilogue.launches
            out = ce.epilogue_fused(y, b, relu, o)
            assert ce.conv_epilogue.launches == before + 1
            want = ce.epilogue_plain(y, b, relu, o)
            err = _rel(out, want)
            assert err <= FWD_RTOL[dtype], (shape, relu, err)
            worst["out"] = max(worst["out"], err)
            assert torch.equal(out, ce.epilogue_fused(y, b, relu, o))
            g = torch.randn(shape, device="cuda", dtype=dtype)
            saved = out if relu else None
            before = ce.conv_epilogue.launches
            gs, db = ce._backward_fused(g, saved, True, True, dtype)
            assert ce.conv_epilogue.launches == before + 2
            gw, dbw = ce._backward_plain(g, saved, True, True, dtype)
            assert torch.equal(gs, gw), (shape, relu)
            err = _rel(db, dbw)
            assert err <= DB_RTOL[dtype], (shape, relu, err)
            worst["db"] = max(worst["db"], err)
            gs2, db2 = ce._backward_fused(g, saved, True, True, dtype)
            assert torch.equal(gs, gs2) and torch.equal(db, db2)
            only, dbo = ce._backward_fused(g, saved, False, True, dtype)
            assert only is None and torch.equal(dbo, db)
    flat = torch.randn(2 * 4 * 4 * 8 + 1, device="cuda", dtype=dtype)
    y = flat[1:].view(2, 4, 4, 8)  # 2 bytes past a 16-byte boundary: the scalar route
    out = ce.epilogue_fused(y, None, True, None)
    assert torch.equal(out, torch.relu(y))
    print(f"conv_epilogue {dtype}: worst relative error out {worst['out']:.3e}, "
          f"db {worst['db']:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_float32_bias_gradient_on_card(dtype):
    """A float32 bias gets its gradient summed and kept in float32 whatever
    the gradient's dtype: the epilogue's db, and B4's db at D's C256 input
    (batch 2) against ``g·[y > 0]`` summed in float32, within 1e-5 of the
    largest."""
    _needs_card()
    y, b, o = _inputs(13, (2, 64, 64, 128), dtype, True, True, "cuda")
    out = ce.epilogue_fused(y, b, True, o)
    g = torch.randn(out.shape, device="cuda", dtype=dtype)
    _, db = ce._backward_fused(g, out, False, True, torch.float32)
    want = torch.where(out > 0, g, torch.zeros_like(g)).float().sum((0, 1, 2))
    assert db.dtype == torch.float32 and _rel(db, want) <= 1e-5, _rel(db, want)
    r = np.random.default_rng(14)
    x = torch.from_numpy(r.normal(size=(2, 32, 32, 256))).to("cuda", dtype).requires_grad_()
    k = torch.from_numpy(r.normal(size=(4, 4, 256, 256)) / 64).float().cuda().requires_grad_()
    bias = torch.from_numpy(r.normal(size=256)).float().cuda().requires_grad_()
    yb4 = fdc.down_conv_fused(x, k, bias, True)
    g = torch.randn(yb4.shape, device="cuda", dtype=dtype)
    (gb,) = torch.autograd.grad(yb4, [bias], g)
    want = torch.where(yb4 > 0, g, torch.zeros_like(g)).float().sum((0, 1, 2))
    assert gb.dtype == torch.float32 and _rel(gb, want) <= 1e-5, _rel(gb, want)


@pytest.mark.cuda
def test_epilogue_graph_backward_on_card():
    """On the card a create_graph backward takes the torch ops and is
    counted; a plain backward takes the kernels and is not."""
    _needs_card()
    y, b, o = _inputs(7, (2, 8, 8, 64), torch.float32, True, True, "cuda")
    g = torch.randn(2, 8, 8, 64, device="cuda", dtype=torch.float64)
    ins = _leaves(y, b, o)
    before = (ce.ConvEpilogue.graph_backwards, ce.conv_epilogue.launches)
    out = ce.conv_epilogue(ins[0], ins[1], True, ins[2])
    torch.autograd.grad(out, ins, g.float())
    assert (ce.ConvEpilogue.graph_backwards, ce.conv_epilogue.launches) == (before[0],
                                                                           before[1] + 3)
    got = _second_order(ce.ConvEpilogue.apply, *_leaves(y, b, o), True,
                        g.float().requires_grad_())
    assert ce.ConvEpilogue.graph_backwards == before[0] + 1
    want = _second_order(ce.epilogue_plain, *_leaves(y, b, o), True, g.float().requires_grad_())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
