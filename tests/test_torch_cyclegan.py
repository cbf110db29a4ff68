"""The published CycleGAN on the port (arXiv 1703.10593): the ResNet
generator (``models/resnet``), the 70×70 PatchGAN (``d_layout="patchgan70"``),
least squares, the image pool (``train/image_pool``) and Adam's β₁, through
the port's normal path, against ``plain_cyclegan.py`` (plain float32
PyTorch after the authors' code) on the CPU at 16², ngf 4, two residual
blocks; the published widths' counts and shapes on the meta device; the
explicit-pad convs against NCHW ``torch.nn.functional``; the refusals under
tensor, spatial and pipeline parallelism; ``gan_loop``, ``cli gan-train``,
checkpoints, transfer and the serving bundle; the spans and counters."""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import plain_cyclegan as plain  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import discriminator as d_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.models import resnet  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import conv as conv_ops  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import norm  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, image_pool  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import profiler  # noqa: E402

torch.set_num_threads(1)
NETS = ("g_ab", "g_ba", "d_a", "d_b")
CYCLEGAN = dict(generator="resnet", g_norm="instance", resnet_blocks=2, d_layout="patchgan70",
                d_norm="instance", d_pixel_size=4, d_octaves=2, gan_loss="lsgan",
                identity_weight=5.0, optimizer="adam", adam_b1=0.5, adam_eps=1e-8,
                learning_rate=2e-4, lr_schedule="constant", warm_up=0, batch_size=2)
PUBLISHED = Config(generator="resnet", g_norm="instance", pixel_size=64, octaves=2,
                   max_size=512, d_layout="patchgan70", d_norm="instance", d_pixel_size=64,
                   d_octaves=3, compute_dtype="bfloat16").validate()


def _cfg(**kw):
    return tiny_test_config(**{**CYCLEGAN, **kw})


def _weights(cfg, seed=0, bias_std=0.0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for net in NETS:
        shapes = (plain.generator_shapes if net.startswith("g") else
                  plain.discriminator_shapes)(cfg)
        for k, v in plain.init_weights(shapes, g, bias_std).items():
            out[f"{net}.{k}"] = v
    return out


def _load(state, weights):
    with torch.no_grad():
        for net in NETS:
            params = dict(getattr(state, net).named_parameters())
            assert set(params) == {k[len(net) + 1:] for k in weights if k.startswith(net + ".")}
            for k, p in params.items():
                p.copy_(weights[f"{net}.{k}"])
    return state


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _images(n, size=16, seed=0):
    return torch.rand(n, size, size, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


# ------------------------------------------------------------- the networks


def test_published_parameter_counts_and_256_shapes_on_meta():
    with torch.device("meta"):
        g, d = resnet.ResnetGenerator(PUBLISHED), d_lib.Discriminator(PUBLISHED)
    assert resnet.param_count(g) == 11_378_179 == plain.param_count(
        plain.generator_shapes(PUBLISHED))
    assert d_lib.param_count(d) == 2_764_737 == plain.param_count(
        plain.discriminator_shapes(PUBLISHED))
    x = torch.empty(2, 256, 256, 3, device="meta")
    assert tuple(resnet.resnet_apply(PUBLISHED, g, x).shape) == (2, 256, 256, 3)
    assert tuple(d_lib.discriminator_apply(PUBLISHED, d, x).shape) == (2, 30, 30, 1)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_forward_matches_the_plain_reference(net):
    """float32 on the CPU: the NHWC convs and the NCHW reference sum in other
    orders, a few float32 spacings of the outputs' scale (~1)."""
    cfg = _cfg()
    prefix = "g_ab." if net == "generator" else "d_a."
    w = {k[len(prefix):]: v for k, v in _weights(cfg, 1, bias_std=0.1).items()
         if k.startswith(prefix)}
    module = (resnet.ResnetGenerator(cfg) if net == "generator" else d_lib.Discriminator(cfg))
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.copy_(w[k])
        x = _images(3, seed=2)
        got = (resnet.resnet_apply if net == "generator" else d_lib.discriminator_apply)(
            cfg, module, x)
        want = getattr(plain, net)(cfg, w, _nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_init_is_normal_002_with_zero_biases():
    g = resnet.ResnetGenerator(PUBLISHED).reset_parameters(torch.Generator().manual_seed(0))
    kernels = torch.cat([p.detach().flatten() for k, p in g.named_parameters()
                         if k.endswith("kernel")])
    assert abs(float(kernels.std()) - 0.02) < 2e-4 and abs(float(kernels.mean())) < 1e-4
    assert all(float(p.detach().abs().max()) == 0 for k, p in g.named_parameters()
               if k.endswith("bias"))


# ----------------------------------------------------------------- the ops

CONVS = {
    # name: (port(x, k, b), reference(x_nchw, k, b), kernel shape)
    "zero-pad k3/s2": (lambda x, k, b: conv_ops.conv2d_padded(x, k, b, stride=2, pad=1),
                       lambda x, k, b: F.conv2d(x, k.permute(3, 2, 0, 1), b, stride=2, padding=1),
                       (3, 3, 5, 6)),
    "k4/s1 pad 1": (lambda x, k, b: conv_ops.conv2d_padded(x, k, b, stride=1, pad=1),
                    lambda x, k, b: F.conv2d(x, k.permute(3, 2, 0, 1), b, padding=1),
                    (4, 4, 5, 6)),
    "reflect k7": (lambda x, k, b: conv_ops.conv2d_padded(x, k, b, pad=3, reflect=True),
                   lambda x, k, b: F.conv2d(F.pad(x, (3, 3, 3, 3), mode="reflect"),
                                            k.permute(3, 2, 0, 1), b),
                   (7, 7, 5, 6)),
    "reflect k3": (lambda x, k, b: conv_ops.conv2d_padded(x, k, b, pad=1, reflect=True),
                   lambda x, k, b: F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                                            k.permute(3, 2, 0, 1), b),
                   (3, 3, 5, 6)),
    "transposed k3/s2": (lambda x, k, b: conv_ops.conv2d_transpose_padded(x, k, b),
                         lambda x, k, b: F.conv_transpose2d(x, k.permute(2, 3, 0, 1), b, stride=2,
                                                            padding=1, output_padding=1),
                         (3, 3, 5, 6)),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_explicit_pad_convs_match_nchw_functional(name):
    """The same sums in the same order on the CPU: equal to float32 rounding
    of one output (1e-6 at outputs of ~1)."""
    port, ref, kshape = CONVS[name]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 10, 12, 5, generator=g)
    k, b = torch.randn(kshape, generator=g) * 0.1, torch.randn(kshape[-1], generator=g)
    got = port(x, k, b)
    want = ref(_nchw(x), k, b).permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,p", [(5, 6, 1), (8, 7, 3), (4, 4, 3)])
def test_reflect_pad_is_reflection_pad2d_on_the_nhwc_tensor(h, w, p):
    """Forward exact (copies); backward in float64 to a few spacings: the
    mirrored edges' gradients add onto their sources in another order."""
    x = torch.randn(2, h, w, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(h))
    x.requires_grad_(True)
    got = conv_ops.reflect_pad(x, p)
    xr = _nchw(x.detach()).requires_grad_(True)
    want = torch.nn.ReflectionPad2d(p)(xr)
    assert torch.equal(got, want.permute(0, 2, 3, 1)) and got.is_contiguous()
    g = torch.randn(got.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(w))
    (dx,) = torch.autograd.grad(got, x, g)
    (dxr,) = torch.autograd.grad(want, xr, _nchw(g))
    torch.testing.assert_close(dx, dxr.permute(0, 2, 3, 1), rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_without_affine(dtype):
    """B3 with γ and β absent, forward and backward, against
    ``F.instance_norm`` (no affine): float32 statistics on both sides; in
    bfloat16 one rounding of the output."""
    x = torch.randn(2, 6, 7, 5, generator=torch.Generator().manual_seed(4)).to(dtype)
    x.requires_grad_(True)
    y = norm.instance_norm(x, None, None)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(dtype)
    (dx,) = torch.autograd.grad(y, x, dy)
    xr = _nchw(x.detach().float()).requires_grad_(True)
    yr = F.instance_norm(xr)
    (dxr,) = torch.autograd.grad(yr, xr, _nchw(dy.float()))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yr.permute(0, 2, 3, 1), rtol=0, atol=tol)
    torch.testing.assert_close(dx.float(), dxr.permute(0, 2, 3, 1), rtol=0, atol=tol)


# ------------------------------------------------------------ the image pool


def test_image_pool_fills_then_swaps_as_the_authors_loop():
    """Distinct images through a pool of 2 in batches of 3, against the
    reference's image-by-image loop on the same draws: the first query
    fills the pool (and draws once, for its third image), later ones swap
    about half their images, a later image of a batch taking back an
    earlier one that swapped into its slot. Exact: only copies."""
    cfg = Config(image_pool=2, size=4)
    (pool, _), ref = image_pool.init_pools(cfg, torch.float32, "cpu"), plain.ImagePool(2)
    gp, gr = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    returned_old = 0
    for q in range(6):
        fakes = torch.arange(3 * q, 3 * q + 3, dtype=torch.float32).reshape(3, 1, 1, 1).expand(
            3, 4, 4, 3).contiguous()
        pool, got = image_pool.query(pool, fakes, gp)
        want = ref.query(fakes, gr)
        assert torch.equal(got, want), q
        assert torch.equal(pool.stored, torch.stack(ref.images)) and pool.filled == 2
        returned_old += int((got[:, 0, 0, 0] < 3 * q).sum())
    assert ref.swaps > 4 and returned_old > 4


def test_image_pool_counts_queries_and_images_on_the_host():
    profiler.reset()
    pool = image_pool.init_pools(Config(image_pool=3, size=4), torch.float32, "cpu")[0]
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        pool, _ = image_pool.query(pool, torch.zeros(2, 4, 4, 3), g)
    assert profiler.counters() == {"image_pool.queries": 3, "image_pool.images": 6}
    profiler.reset()


# -------------------------------------------------------------- the G/D step


def _train(cfg, weights, steps, seed=7):
    state = _load(gan.init_gan_state(cfg, device="cpu"), weights)
    step = gan.make_gan_train_step(cfg)
    gen = torch.Generator().manual_seed(seed)
    start = {f"{n}.{k}": p.detach().clone() for n in NETS
             for k, p in getattr(state, n).named_parameters()}
    losses, first = [], None
    for i in range(steps):
        state, m = step(state, _images(2, seed=100 + i), _images(2, seed=200 + i), gen)
        losses.append((float(m["g_loss"]), float(m["d_loss"])))
        if i == 0:  # Adam's m₁ = (1 − β₁)·g₁, over g_ab + g_ba and d_a + d_b
            mus = [*state.g_opt[0][0].mu, *state.d_opt[0][0].mu]
            first = dict(zip(start, (m / (1 - cfg.adam_b1) for m in mus)))
    delta = {f"{n}.{k}": p.detach() - start[f"{n}.{k}"] for n in NETS
             for k, p in getattr(state, n).named_parameters()}
    return state, losses, first, delta


def test_five_steps_match_the_reference_through_pool_swaps():
    """Five G/D steps at 16² with an image pool of 2 a class (batch 2: the
    first step fills it, the other four swap), against the reference on the
    same weights and draws. Tolerances: float32 sums in other orders on
    both sides, a few spacings of each number's scale, grown by Adam's
    normalised updates over five steps. Leaves whose reference gradient
    is under 1e-3 of the median's (the biases ahead of an instance norm,
    whose mean the norm takes out) are round-off on both sides and left
    out of the gradient and change checks."""
    cfg = _cfg(image_pool=2)
    weights = _weights(cfg, 5, bias_std=0.02)
    state, losses, first, delta = _train(cfg, weights, 5)
    ref = plain.CycleGANTrainer(cfg, weights, torch.Generator().manual_seed(7))
    ref_losses = [ref.step(_images(2, seed=100 + i), _images(2, seed=200 + i))
                  for i in range(5)]
    assert all(p.swaps >= 2 for p in ref.pools)
    assert state.pools[0].filled == state.pools[1].filled == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-6)
    norms = {k: float(v.norm()) for k, v in ref.grads[0].items()}
    median = float(np.median(list(norms.values())))
    moved = [k for k, v in norms.items() if v >= 1e-3 * median]
    assert len(moved) > len(norms) // 2
    for k in moved:
        torch.testing.assert_close(first[k], ref.grads[0][k], rtol=0,
                                   atol=1e-4 * norms[k] / math.sqrt(ref.grads[0][k].numel()) + 1e-7)
        want = ref.params[k] - weights[k]
        torch.testing.assert_close(delta[k], want, rtol=0, atol=2e-3 * float(want.abs().max()))


def test_the_pool_changes_what_d_sees():
    """The same steps without the pool give other D losses once the pool
    swaps, and the same ones before."""
    cfg = _cfg(image_pool=2)
    weights = _weights(cfg, 5)
    _, with_pool, _, _ = _train(cfg, weights, 3)
    _, without, _, _ = _train(cfg.replace(image_pool=0), weights, 3)
    assert with_pool[0] == without[0]
    assert with_pool[2][1] != without[2][1]


def _refusals():
    from types import SimpleNamespace

    from gan_class_transfer2_tpu_torch.parallel import mesh, spatial_train

    return {
        "tensor config": lambda: _cfg(mesh_model=2),
        "tensor mesh": lambda: mesh.make_parallel_gan_train_step(
            _cfg(), SimpleNamespace(shape={"model": 2})),
        "spatial": lambda: spatial_train._check(_cfg()),
        "pipeline": lambda: _cfg(pipeline_stages=2),
    }


@pytest.mark.parametrize("layout", ["tensor config", "tensor mesh", "spatial", "pipeline"])
def test_model_parallel_layouts_refuse_the_published_networks(layout):
    with pytest.raises(ValueError, match=f"not under {layout.split()[0]} parallelism"):
        _refusals()[layout]()


def test_the_conditional_gan_refuses_the_published_networks():
    from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan

    with pytest.raises(ValueError, match="generator='unet'"):
        cgan.init_conditional_gan_state(_cfg(num_classes=2), device="cpu")


# ------------------------------------------------------------ the normal path


def _runner(tmp_path, **kw):
    from gan_class_transfer2_tpu_torch.data.pipeline import ArrayDataset
    from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner

    cfg = _cfg(steps_per_epoch=2, epochs=1, classes=("a", "b"), image_pool=3,
               log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ckpt"),
               checkpoint_every=2, **kw)
    ds = [ArrayDataset(np.random.default_rng(s).integers(0, 256, (6, 16, 16, 3),
                                                         dtype=np.uint8), 2, seed=s)
          for s in (0, 1)]
    return GANRunner(cfg, dataset_a=ds[0], dataset_b=ds[1], device="cpu")


def test_gan_loop_trains_and_the_checkpoint_restores_parameters_and_pools(tmp_path):
    runner = _runner(tmp_path)
    assert isinstance(runner.state.g_ab, resnet.ResnetGenerator)
    runner.fit()
    runner.close()
    assert runner.state.step == 2 and ckpt_lib.all_steps(str(tmp_path / "ckpt")) == [2]
    assert runner.state.pools[0].filled == 3 and runner.state.pools[1].filled == 3
    again = _runner(tmp_path)
    flat, back = {}, {}
    ckpt_lib._walk(runner.state, "", flat)
    ckpt_lib._walk(again.state, "", back)
    assert set(flat) == set(back) and "pools.1.stored" in flat and back["pools.0.filled"] == 3
    for k, v in flat.items():
        assert torch.equal(v, back[k]) if isinstance(v, torch.Tensor) else v == back[k], k
    again.close()


def test_cli_gan_train_runs_the_published_networks(tmp_path, capsys):
    from PIL import Image

    r = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(4):
            Image.fromarray(r.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
                tmp_path / cls / f"{i}.png")
    ckpt = str(tmp_path / "ckpt")
    argv = ["gan-train", "--device", "cpu", "--size", "16", "--pixel-size", "4",
            "--max-size", "8", "--octaves", "2", "--batch-size", "2", "--steps-per-epoch", "2",
            "--epochs", "1", "--generator", "resnet", "--resnet-blocks", "2", "--g-norm",
            "instance", "--d-layout", "patchgan70", "--d-pixel-size", "4", "--d-octaves", "2",
            "--d-norm", "instance", "--image-pool", "2", "--gan-loss", "lsgan", "--adam-b1",
            "0.5", "--identity-weight", "5", "--lr-schedule", "constant",
            "--classes", str(tmp_path / "a" / "*.png"), str(tmp_path / "b" / "*.png"),
            "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir", ckpt,
            "--checkpoint-every", "2", "--data-workers", "1", "--native-loader", "false"]
    assert cli.main(argv) == 0
    assert "epoch 0: g=" in capsys.readouterr().out
    assert ckpt_lib.all_steps(ckpt) == [2]
    saved = ckpt_lib.load_config(ckpt)
    assert (saved.generator, saved.d_layout, saved.image_pool, saved.adam_b1) == (
        "resnet", "patchgan70", 2, 0.5)


def test_transfer_and_the_serving_bundle_take_the_resnet_generator(tmp_path):
    from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib

    cfg = _cfg()
    weights = _weights(cfg, 9, bias_std=0.05)
    state = _load(gan.init_gan_state(cfg, device="cpu"), weights)
    x = _images(3, seed=4)
    with torch.no_grad():
        want = {d: plain.generator(cfg, {k[5:]: v for k, v in weights.items()
                                         if k.startswith(f"g_{d}.")}, _nchw(x)).permute(0, 2, 3, 1)
                for d in ("ab", "ba")}
        for d in ("ab", "ba"):
            torch.testing.assert_close(gan.transfer(cfg, state, x, d), want[d], rtol=0, atol=2e-5)
            torch.testing.assert_close(gan.make_transfer_fn(cfg)(state.g_ab if d == "ab" else
                                                                 state.g_ba, x),
                                       want[d], rtol=0, atol=2e-5)
    manifest = bundle_lib.export_bundle(cfg, state, str(tmp_path / "b"), model="gan",
                                        platforms=("cpu",))
    assert sorted(manifest["programs"]) == ["transfer_ab", "transfer_ba"]
    b = bundle_lib.load_bundle(str(tmp_path / "b"), "cpu")
    for d in ("ab", "ba"):
        with torch.inference_mode():
            assert torch.equal(b.call(f"transfer_{d}", x), gan.transfer(cfg, state, x, d))


# ------------------------------------------------------------ spans, counters


def test_trunk_spans_six_a_step_under_the_step_and_the_pool_counters(tmp_path, capsys):
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(image_pool=2)
    state = gan.init_gan_state(cfg, device="cpu")
    step, gen = gan.make_gan_train_step(cfg), torch.Generator().manual_seed(0)
    state, _ = step(state, _images(2), _images(2, seed=1), gen)  # outside the capture
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            state, _ = step(state, _images(2), _images(2, seed=1), gen)
    recs = profiler.spans()

    def top(r):
        while r["parent"] is not None:
            r = recs[r["parent"]]
        return r["name"]

    trunks = [r for r in recs if r["name"] == "resnet.trunk"]
    assert len(trunks) == 12 and {top(r) for r in trunks} == {"gan.step"}
    assert sorted(r["step"] for r in trunks) == [1] * 6 + [2] * 6
    assert sum(r["name"] == "gan.image_pool" for r in recs) == 4
    assert profiler.counters() == {"image_pool.queries": 4, "image_pool.images": 8}
    profiler.reset()
    args = ["profile", "--device", "cpu", "--model", "gan", "--size", "16", "--pixel-size", "4",
            "--max-size", "8", "--octaves", "2", "--batch-size", "2", "--profile-steps", "2",
            "--trace-dir", str(tmp_path / "trace"), "--generator", "resnet", "--resnet-blocks",
            "2", "--g-norm", "instance", "--d-layout", "patchgan70", "--d-pixel-size", "4",
            "--d-octaves", "2", "--d-norm", "instance", "--image-pool", "2"]
    assert cli.main(args) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    rows = {r["span"]: r for r in lines if "span" in r}
    assert rows["resnet.trunk"]["calls_per_step"] == 6
    assert rows["gan.image_pool"]["calls_per_step"] == 2
    assert lines[-1]["counters"] == {"image_pool.queries": 4, "image_pool.images": 8}
    assert os.path.exists(tmp_path / "trace" / "trace.json")
