"""The port as a package: weight round trips against the JAX package's
formats, the CLI surface on the CPU, the device rule, the import boundary,
and (on a card only) the CUDA kernel against its plain version.

The JAX package is imported inside the tests that compare against it, so
that the card test also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_port.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import unet  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import png, weights  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4"]


@pytest.fixture
def ref():
    """The JAX package's pieces these tests compare against."""
    import types

    import jax
    import jax.numpy as jnp

    from gan_class_transfer2_tpu.config import tiny_test_config
    from gan_class_transfer2_tpu.models import unet as junet
    from gan_class_transfer2_tpu.sample import sampler
    from gan_class_transfer2_tpu.utils import tf_import

    def params(jcfg):
        return jax.tree_util.tree_map(np.asarray, junet.init_unet(jax.random.PRNGKey(0), jcfg))

    return types.SimpleNamespace(jax=jax, jnp=jnp, tiny=tiny_test_config, params=params,
                                 sampler=sampler, tf_import=tf_import)


@pytest.mark.parametrize("overrides", [dict(), dict(skip_mode="residual", block_depth=1)])
def test_jax_params_round_trip(ref, overrides):
    jcfg, cfg = ref.tiny(**overrides), tiny_test_config(**overrides)
    params = ref.params(jcfg)
    back = weights.to_jax_params(weights.from_jax_params(cfg, params, device="cpu"))
    tree = ref.jax.tree_util
    assert tree.tree_structure(back) == tree.tree_structure(params)
    for a, b in zip(tree.tree_leaves(back), tree.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [dict(), dict(skip_mode="residual", block_depth=1)])
def test_flat_weights_match_the_jax_keras_order(ref, overrides):
    """export_flat_weights lists what the JAX package's export lists, in the
    same order, and import_flat_weights takes it back."""
    jcfg, cfg = ref.tiny(**overrides), tiny_test_config(**overrides)
    params = ref.params(jcfg)
    model = weights.from_jax_params(cfg, params, device="cpu")
    flat = weights.export_flat_weights(model)
    jflat = ref.tf_import.export_flat_weights(jcfg, params)
    assert len(flat) == len(jflat)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = weights.import_flat_weights(unet.Denoiser(cfg), jflat)
    for a, b in zip(again.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="order mismatch"):
        weights.import_flat_weights(unet.Denoiser(cfg), jflat[:-1])


def test_cli_sample_writes_pngs_that_match_the_jax_sampler(ref, tmp_path):
    """The user path: JAX weights exported as the JAX CLI's npz, sampled by
    the port's CLI on the CPU. The init batch is the JAX CLI's
    (default_rng(seed).normal), so the PNGs equal the JAX sampler's images
    up to one uint8 level (rounding at a level boundary)."""
    jcfg = ref.tiny(steps=4, sample_stride=2)
    params = ref.params(jcfg)
    npz = tmp_path / "w.npz"
    weights.save_flat_npz(npz, ref.tf_import.export_flat_weights(jcfg, params))
    out = tmp_path / "samples"
    rc = cli.main(["sample", "--device", "cpu", *TINY, "--sample-stride", "2",
                   "--weights", str(npz), "--num", "3", "--out", str(out), "--seed", "5"])
    assert rc == 0
    assert sorted(os.listdir(out)) == [f"sample_{i}.png" for i in range(3)]
    init = np.random.default_rng(5).normal(size=(3, 16, 16, 3)).astype(np.float32)
    images = ref.sampler.sample(jcfg, params, ref.jnp.asarray(init), snapshots=False).images
    images = np.asarray(images)
    from PIL import Image

    for i in range(3):
        got = png.read_png(out / f"sample_{i}.png")
        assert got.shape == (16, 16, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(out / f"sample_{i}.png")))
        diff = np.abs(got.astype(int) - png.to_uint8(images[i]).astype(int))
        assert diff.max() <= 1


def test_cli_sample_without_weights_warns(tmp_path, capsys):
    rc = cli.main(["sample", "--device", "cpu", *TINY, "--num", "2", "--out",
                   str(tmp_path / "s")])
    assert rc == 0
    assert "randomly initialised" in capsys.readouterr().err
    assert len(os.listdir(tmp_path / "s")) == 2


def test_cli_edit_writes_each_edit(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, (20, 18, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "in.png")
    rc = cli.main(["edit", "--device", "cpu", *TINY, "--input", str(tmp_path / "in.png"),
                   "--out", str(tmp_path / "e"), "--edits", "pixelate", "shift"])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "e")) == [
        "pixelate.png", "reconstruction.png", "shift.png"]
    np.testing.assert_array_equal(
        cli.decode_image(tmp_path / "in.png", 16),
        arr[2:18, 1:17].astype(np.float32) / 128.0 - 1.0)


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["sample", *TINY, "--num", "1", "--out", str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["sample", "--device", "cuda", *TINY, "--out", str(tmp_path / "s")])


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 16, 16, 128), device="meta")
    k = torch.empty((4, 4, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fdc.down_conv_fused(x, k, torch.empty((128,), device="meta"))


def test_png_round_trip(tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    png.write_png(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), arr)


def test_port_imports_no_jax():
    """Every module of the port imports without jax and without any module
    of the JAX package (whose name is a prefix of the port's)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gan_class_transfer2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'gan_class_transfer2_tpu_torch.cli' in names, names\n"
        "new = ['data.native_loader', 'data.cache', 'utils.metrics', 'utils.fid_extractor',\n"
        "       'serve.server', 'serve.aio', 'models.conditional', 'train.conditional_gan',\n"
        "       'train.conditional_gan_loop', 'train.distill', 'utils.bundle',\n"
        "       'parallel.multihost', 'parallel.mesh', 'utils.inception']\n"
        "missing = [n for n in new if p.__name__ + '.' + n not in names]\n"
        "assert not missing, missing\n"
        "from gan_class_transfer2_tpu_torch.utils import fid_extractor\n"
        "fid_extractor.load_params()  # the JAX package's weights file, read as data\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'gan_class_transfer2_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'gan_class_transfer2_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) >= 15


def _needs_card(monkeypatch):
    """Skip without a card; else turn cuDNN's TF32 off for this test only
    (monkeypatch restores the process-wide flag, so no test depends on the
    order the others ran in)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.cuda
def test_fused_down_conv_kernel_matches_plain_on_card(monkeypatch):
    """The CUDA kernel against its plain version, at a tile-ragged shape
    with O = 64 (padded to 128), and at full-width shapes whose plan splits
    K (batch 1, 4 and 16) or not, in both dtypes; its launch count; and two
    launches on the same inputs give bit-identical y (the split partials
    are summed in a fixed order). Tolerances relative to max|y|: 1e-4 in
    float32 (summation order over 16·C terms), 2e-2 in bfloat16 (one bf16
    output rounding is ~4e-3)."""
    _needs_card(monkeypatch)
    r = np.random.default_rng(0)
    for (bsz, h, c, o) in ((3, 18, 128, 64), (4, 32, 512, 512), (1, 16, 512, 512),
                           (16, 16, 512, 512), (4, 64, 256, 512), (1, 128, 128, 256)):
        x = torch.from_numpy(r.normal(size=(bsz, h, h, c)).astype(np.float32)).cuda()
        k = torch.from_numpy((r.normal(size=(4, 4, c, o)) / np.sqrt(16 * c)).astype(np.float32))
        b = torch.from_numpy(r.normal(size=(o,)).astype(np.float32))
        k, b = k.cuda(), b.cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            before = fdc.down_conv_fused.launches
            with torch.inference_mode():
                y = fdc.down_conv_fused(x.to(dtype), k, b)
                ref = fdc.down_conv_plain(x.to(dtype), k, b)
            torch.cuda.synchronize()
            assert fdc.down_conv_fused.launches == before + 1
            err = (y.float() - ref.float()).abs().max().item()
            assert err <= tol * ref.float().abs().max().item(), (bsz, h, c, o, dtype, err)
            with torch.inference_mode():
                again = fdc.down_conv_fused(x.to(dtype), k, b)
            assert torch.equal(y, again), (bsz, h, c, o, dtype)


@pytest.mark.cuda
def test_down_conv_gradient_matches_plain_autograd_on_card(monkeypatch):
    """B4's backward (cuDNN's input and weight gradients around the kernel's
    forward) against autograd through the plain version, at one full-width
    shape: relative to the largest gradient, 1e-5 in float32 (IEEE convs,
    other summation orders), 4e-2 in bfloat16: the plain version's gradient
    is float32 rounded once to bf16, cuDNN's bf16 dgrad rounds its partial
    sums over 4·O = 2048 terms too (2.0e-2 seen on an H100 at dx). An output
    whose pre-activation lies within rounding of 0 may pass one ReLU and not
    the other; the upstream gradient is 0 there for both."""
    _needs_card(monkeypatch)
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(4, 64, 64, 256)).astype(np.float32)).cuda()
    k = torch.from_numpy((r.normal(size=(4, 4, 256, 512)) / 64).astype(np.float32)).cuda()
    b = torch.from_numpy((r.normal(size=(512,)) * 0.1).astype(np.float32)).cuda()
    g = torch.from_numpy(r.normal(size=(4, 32, 32, 512)).astype(np.float32)).cuda()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-2)):
        leaves, ys = [], []
        for fn in (fdc.down_conv_fused, fdc.down_conv_plain):
            leaves.append([t.to(dtype).requires_grad_() for t in (x, k, b)])
            ys.append(fn(*leaves[-1]))
        gm = torch.where((ys[0] > 0) == (ys[1] > 0), g.to(dtype), 0)
        grads = [torch.autograd.grad(y, ts, gm) for y, ts in zip(ys, leaves)]
        for name, a, w in zip(("dx", "dK", "db"), *grads):
            err = (a.float() - w.float()).abs().max().item()
            assert err <= tol * w.float().abs().max().item(), (dtype, name, err)


@pytest.mark.cuda
def test_diffuse_kernel_matches_plain_on_card(monkeypatch):
    """B1 against its plain version (the same table gather and the same
    Philox words in int64 torch ops, on the card) at batch 1, 16 and 64 and
    N = 16²×3, 256²×3 and a ragged tail of the kernel's tiling (groups of 4
    elements, 1024 groups a block per pass): within 4e-6 absolute (|ε| < 6,
    a few float32 ulps; the IEEE log and cos make it 0 on an H100); two
    launches bit-identical; with sn = 0 exactly x·ss; one launch per call; a
    t past the table gives NaN; an unaligned or non-float32 x is refused."""
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd

    _needs_card(monkeypatch)
    r = np.random.default_rng(2)
    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64, device="cuda")
    table = fd.scale_table(200, "quadratic", "cuda")
    for b, n in ((1, 768), (16, 768), (64, 768), (1, 256 * 256 * 3), (16, 256 * 256 * 3),
                 (64, 256 * 256 * 3), (3, 4 * (3 * 1024 + 37))):
        x = torch.from_numpy(r.uniform(-1, 1, (b, n)).astype(np.float32)).cuda()
        t = torch.from_numpy(r.integers(0, 201, b).astype(np.int32)).cuda()
        before = fd.diffuse_fused.launches
        y = fd.diffuse_fused(x, t, table, seed)
        torch.cuda.synchronize()
        assert fd.diffuse_fused.launches == before + 1
        assert (y - fd.diffuse_plain(x, t, table, seed)).abs().max().item() <= 4e-6, (b, n)
        assert torch.equal(y, fd.diffuse_fused(x, t, table, seed)), (b, n)
        ss_only = torch.stack([table[:, 0], torch.zeros_like(table[:, 0])], 1)
        ss = table[t.long(), 0]
        assert torch.equal(fd.diffuse_fused(x, t, ss_only, seed), x * ss[:, None]), (b, n)
    x = torch.zeros((2, 768), device="cuda")
    past = torch.tensor([3, 201], dtype=torch.int32, device="cuda")
    y = fd.diffuse_fused(x, past, table, seed)
    assert torch.isfinite(y[0]).all() and torch.isnan(y[1]).all()
    buf = torch.zeros(2 * 768 + 1, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        fd.diffuse_fused(buf[1:].view(2, 768), past, table, seed)
    with pytest.raises(TypeError, match="float32"):
        fd.diffuse_fused(x.double(), past, table, seed)


@pytest.mark.cuda
def test_b1s_folds_per_rank_on_card(monkeypatch):
    """B1s (B1 on one rank's block, the seed folded by the rank's linear
    position inside the kernel): at batch 16 × 256²×3 split into two blocks
    of 8, each block at positions 0 and 1 equals B1 on the block with the
    folded seed bit for bit and its plain version within 4e-6; the two
    positions draw different ε; one launch a call, counted apart from B1's;
    the fold leaves the seed's high word alone."""
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd

    _needs_card(monkeypatch)
    r = np.random.default_rng(6)
    seed = torch.tensor([0x7ABC_DEF0_1234_5678], dtype=torch.int64, device="cuda")
    table = fd.scale_table(200, "quadratic", "cuda")
    x = torch.from_numpy(r.uniform(-1, 1, (16, 256 * 256 * 3)).astype(np.float32)).cuda()
    t = torch.from_numpy(r.integers(1, 201, 16).astype(np.int32)).cuda()
    for block in range(2):
        xb, tb = x[8 * block:8 * block + 8], t[8 * block:8 * block + 8]
        for pos in range(2):
            b1s, b1 = fd.diffuse_fused_sharded.launches, fd.diffuse_fused.launches
            y = fd.diffuse_fused_sharded(xb, tb, table, seed, pos)
            torch.cuda.synchronize()
            assert fd.diffuse_fused_sharded.launches == b1s + 1
            assert fd.diffuse_fused.launches == b1
            assert torch.equal(y, fd.diffuse_fused(xb, tb, table, fd.fold_seed(seed, pos)))
            ref = fd.diffuse_sharded_plain(xb, tb, table, seed, pos)
            assert (y - ref).abs().max().item() <= 4e-6, (block, pos)
    noise = torch.tensor([[0.0, 1.0]], device="cuda")
    zero, t0 = torch.zeros((8, 768), device="cuda"), torch.zeros(8, dtype=torch.int32,
                                                                   device="cuda")
    eps = [fd.diffuse_fused_sharded(zero, t0, noise, seed, p) for p in range(2)]
    assert (eps[0] == eps[1]).double().mean().item() < 1e-3
    assert int(fd.fold_seed(seed, 1).item()) >> 32 == 0x7ABC_DEF0


@pytest.mark.cuda
def test_adam_kernel_matches_plain_on_card(monkeypatch):
    """B2 against its plain version on the card, bit for bit (the kernel
    rounds every operation as the plain version's separate torch ops do),
    over leaves of sizes that are and are not multiples of 4 and 128, with
    float32 and bfloat16 moments, and more leaves than one launch takes."""
    from gan_class_transfer2_tpu_torch.ops import adam_kernel

    _needs_card(monkeypatch)
    r = np.random.default_rng(3)
    sizes = [1, 3, 128, 1000, 4096, 70_001] * 9  # 54 leaves: two launches
    for mdt in (torch.float32, torch.bfloat16):
        def leaves():
            return [torch.from_numpy(r.normal(size=n).astype(np.float32)).cuda() for n in sizes]

        p, g = leaves(), leaves()
        m = [t.mul(0.1).to(mdt) for t in leaves()]
        v = [t.square().mul(0.01).to(mdt) for t in leaves()]
        step = torch.tensor([3.7e-4], device="cuda")
        ref = [[t.clone() for t in ts] for ts in (p, m, v)]
        before = adam_kernel.adam_fused.launches
        adam_kernel.adam_fused(p, m, v, g, step, 1e-7)
        torch.cuda.synchronize()
        assert adam_kernel.adam_fused.launches == before + adam_kernel.launches_per_step(
            len(sizes)) == before + 2
        adam_kernel.adam_plain(*ref, g, step, 1e-7)
        for got, want in zip(p + m + v, ref[0] + ref[1] + ref[2]):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_fp32_conv_gradients_stay_ieee_through_the_step_on_card(monkeypatch):
    """The train step's float32 gradients on the card, with cuDNN's TF32
    flag at its default (True) before the step, match a float64 CPU
    gradient to 1e-5 of the largest gradient of each leaf; TF32 (a 10-bit
    mantissa) would be ~1e-3 off. The flag is restored after the step."""
    from gan_class_transfer2_tpu_torch.train import trainer

    _needs_card(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = tiny_test_config(size=32, pixel_size=32, max_size=64, octaves=2)
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    eps = torch.from_numpy(r.normal(size=x.shape).astype(np.float32))
    t = torch.tensor([1, 3, 6, 9], dtype=torch.int32)
    model = unet.Denoiser(cfg).reset_parameters(torch.Generator().manual_seed(0))
    _, grads = trainer.loss_and_grads(cfg, model.cuda(), x.cuda(), None, t_int=t,
                                      epsilon_in=eps.cuda())
    assert torch.backends.cudnn.allow_tf32 is True
    monkeypatch.setitem(unet.DTYPES, "float32", torch.float64)  # the reference in float64
    _, want = trainer.loss_and_grads(cfg, model.cpu().double(), x.double(), None,
                                     t_int=t, epsilon_in=eps.double())
    for a, w in zip(grads, want):
        err = (a.double().cpu() - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), err


@pytest.mark.cuda
def test_remat_recomputes_through_b4_in_ieee_fp32_on_card(monkeypatch):
    """cfg.remat on the card: the checkpointed inner octave holds B4 (a
    128-channel 16² down conv), which the backward recomputes (two launches
    a step, one without remat); with cuDNN's TF32 flag at its default, the
    gradients match a float64 CPU gradient to 1e-5 of each leaf's largest
    (the recompute runs in IEEE float32) and the loss equals the step's
    without remat."""
    from gan_class_transfer2_tpu_torch.train import trainer

    _needs_card(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = tiny_test_config(size=32, pixel_size=128, max_size=256, octaves=2, conv_impl="pallas")
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    eps = torch.from_numpy(r.normal(size=x.shape).astype(np.float32))
    t = torch.tensor([2, 7], dtype=torch.int32)
    model = unet.Denoiser(cfg).reset_parameters(torch.Generator().manual_seed(0)).cuda()
    out = {}
    for remat in (False, True):
        fdc.down_conv_fused.launches = 0
        out[remat] = trainer.loss_and_grads(cfg.replace(remat=remat), model, x.cuda(), None,
                                            t_int=t, epsilon_in=eps.cuda())
        assert fdc.down_conv_fused.launches == (2 if remat else 1)
    assert torch.equal(out[True][0], out[False][0])
    monkeypatch.setitem(unet.DTYPES, "float32", torch.float64)
    _, want = trainer.loss_and_grads(cfg.replace(conv_impl="lax"), model.cpu().double(),
                                     x.double(), None, t_int=t, epsilon_in=eps.double())
    for a, w in zip(out[True][1], want):
        err = (a.double().cpu() - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), err


@pytest.mark.cuda
def test_instance_norm_kernel_matches_plain_on_card(monkeypatch):
    """B3 against its plain version at ragged shapes (C not a multiple of
    32 or of the 16-byte vector, H·W not a multiple of the block's rows, H·W
    below the cluster: 2×2 pixels over 8 blocks, C = 96, batch 1), at a
    large mean (x = 3·N(0, 1) + 100, where a one-pass E[x²] − m² would lose
    the variance's digits), and at the GAN path's largest, a middle and
    its smallest maps, in both dtypes; one launch per call, and bit-identical y
    from two launches. The forward within 1e-5 (float32: Welford/Chan
    against two-pass statistics, other orders) and 1e-2 (bfloat16: one
    output rounding is 2^-8 of the value) of max|y|; the Function's dx, dγ,
    dβ against autograd through the plain version within 1e-5 / 4e-2 of the
    largest gradient."""
    from gan_class_transfer2_tpu_torch.ops import norm

    _needs_card(monkeypatch)
    r = np.random.default_rng(5)
    for (b, hw, c, mean) in ((3, 5, 40, 2.0), (1, 2, 96, 2.0), (1, 7, 43, 2.0), (4, 32, 512, 100.0),
                             (16, 256, 64, 2.0), (16, 64, 256, 2.0), (16, 4, 512, 2.0)):
        x = torch.from_numpy(r.normal(mean, 3.0, (b, hw, hw, c)).astype(np.float32)).cuda()
        g = torch.from_numpy(r.normal(1.0, 0.2, c).astype(np.float32)).cuda()
        beta = torch.from_numpy(r.normal(0.0, 0.2, c).astype(np.float32)).cuda()
        dy = torch.from_numpy(r.normal(size=x.shape).astype(np.float32)).cuda()
        for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-2, 4e-2)):
            leaves = [[t.to(dtype if i == 0 else torch.float32).clone().requires_grad_()
                       for i, t in enumerate((x, g, beta))] for _ in range(2)]
            before = norm.instance_norm_fused.launches
            y = norm.instance_norm(*leaves[0])
            torch.cuda.synchronize()
            assert norm.instance_norm_fused.launches == before + 1
            assert torch.equal(y, norm.instance_norm_fused(*leaves[0]))
            want = norm.instance_norm_plain(*leaves[1])
            assert y.dtype == dtype
            err = (y.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item(), (b, hw, c, dtype, err)
            got = torch.autograd.grad(y, leaves[0], dy.to(dtype))
            ref = torch.autograd.grad(want, leaves[1], dy.to(dtype))
            for name, a, w in zip(("dx", "dgamma", "dbeta"), got, ref):
                gerr = (a.float() - w.float()).abs().max().item()
                assert gerr <= gtol * w.float().abs().max().item(), (b, hw, c, dtype, name, gerr)


@pytest.mark.cuda
def test_down_conv_without_relu_matches_plain_on_card(monkeypatch):
    """B4 with ``relu=False``, as every down conv of the GAN path calls it
    (a branch of the kernel the diffusion path never takes): forward within
    1e-4 / 2e-2 of max|y| and dx, dK, db within 1e-5 / 4e-2 of the largest
    gradient, as the ReLU tests above."""
    _needs_card(monkeypatch)
    r = np.random.default_rng(6)
    for bsz, h in ((4, 32), (1, 32), (16, 16)):  # split K 8 / 32 / 8 ways (float32)
        x = torch.from_numpy(r.normal(size=(bsz, h, h, 512)).astype(np.float32)).cuda()
        k = torch.from_numpy((r.normal(size=(4, 4, 512, 512)) / 90).astype(np.float32)).cuda()
        b = torch.from_numpy((r.normal(size=(512,)) * 0.1).astype(np.float32)).cuda()
        g = torch.from_numpy(r.normal(size=(bsz, h // 2, h // 2, 512)).astype(np.float32)).cuda()
        for dtype, tol, gtol in ((torch.float32, 1e-4, 1e-5), (torch.bfloat16, 2e-2, 4e-2)):
            leaves = [[t.to(dtype).clone().requires_grad_() for t in (x, k, b)] for _ in range(2)]
            y = fdc.down_conv_fused(*leaves[0], relu=False)
            want = fdc.down_conv_plain(*leaves[1], relu=False)
            assert (y < 0).any()  # no ReLU applied
            err = (y.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item(), (bsz, dtype, err)
            grads = [torch.autograd.grad(out, ts, g.to(dtype))
                     for out, ts in ((y, leaves[0]), (want, leaves[1]))]
            for name, a, w in zip(("dx", "dK", "db"), *grads):
                gerr = (a.float() - w.float()).abs().max().item()
                assert gerr <= gtol * w.float().abs().max().item(), (bsz, dtype, name, gerr)


@pytest.mark.cuda
def test_serve_sample_launches_b4_on_card(monkeypatch):
    """/sample over HTTP on the card at a tiny width whose two down convs B4
    takes (block_depth 1 gives 128 channels at 32² and 16²): num 3 is one device batch of
    4, and each denoiser call of the stride-3 sample launches B4 once per
    down conv it admits; the uint8 answer is within 1 level, on at most
    1e-3 of the values, of the service's own program run in process on the
    replayed noise (the same kernels; a level can flip only at a boundary)."""
    import io
    import json
    import urllib.request

    from gan_class_transfer2_tpu_torch.sample import sampler
    from gan_class_transfer2_tpu_torch.serve.server import ModelService, Server

    _needs_card(monkeypatch)
    cfg = tiny_test_config(size=32, pixel_size=128, max_size=128, block_depth=1,
                           conv_impl="pallas", sample_stride=3)
    per_call, c = 0, cfg.pixel_size if cfg.block_depth else 3
    for i in range(cfg.octaves):
        f, hw = cfg.octave_filters(i), cfg.size >> i
        per_call += fdc.supported((4, hw, hw, c), (4, 4, c, f))
        c = f
    assert per_call == 2
    srv = Server(ModelService(cfg, device="cuda")).start()
    svc = srv.service
    try:
        g = torch.Generator(device="cuda")
        g.set_state(svc._gen.get_state())
        init = torch.randn((4, cfg.size, cfg.size, 3), generator=g, device="cuda")
        fdc.down_conv_fused.launches = 0
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/sample",
                                     data=json.dumps({"num": 3, "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        assert fdc.down_conv_fused.launches == per_call * len(sampler.sample_timesteps(cfg))
        assert svc.counters["device_batches"] == 1
        want = svc._sample_prog(svc._model, init)[:3].cpu().numpy()
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert got.shape == (3, 32, 32, 3) and diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    finally:
        srv.stop()


@pytest.mark.cuda
def test_conditional_forward_through_b4_matches_the_plain_path_on_card(monkeypatch):
    """The class-conditional U-Net at a width whose two down convs B4 takes
    (block_depth 1: 128 channels at 32² and 16²; the 3 + 8 embedded input
    channels reach only the pre_block conv), a mixed-class batch: the kernel
    path against cuDNN (``conv_impl="lax"``) within 1e-4 of the output's
    scale (IEEE float32 sums in other orders), B4 launched once per down
    conv, and the class moving the output."""
    from gan_class_transfer2_tpu_torch.models import api, conditional

    _needs_card(monkeypatch)
    cfg = tiny_test_config(num_classes=3, size=32, pixel_size=128, max_size=256,
                           block_depth=1, conv_impl="pallas")
    model = api.init_denoiser(cfg, device="cuda")
    assert isinstance(model, conditional.ConditionalDenoiser)
    x = torch.from_numpy(np.random.default_rng(20).uniform(-1, 1, (2, 32, 32, 3))
                         .astype(np.float32)).cuda()
    c = torch.tensor([2, 0], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        fdc.down_conv_fused.launches = 0
        y = api.apply_denoiser(cfg, model, x, class_idx=c)
        assert fdc.down_conv_fused.launches == 2
        ref = api.apply_denoiser(cfg.replace(conv_impl="lax"), model, x, class_idx=c)
        other = api.apply_denoiser(cfg, model, x, class_idx=torch.ones_like(c))
    scale = max(1.0, ref.abs().max().item())
    assert (y - ref).abs().max().item() <= 1e-4 * scale
    assert (other - y).abs().max().item() > 1e-3


@pytest.mark.cuda
def test_custom_ops_launch_the_kernel_once_per_call_on_card(monkeypatch):
    """``gct2::down_conv_k4s2`` and ``gct2::instance_norm`` on CUDA tensors
    launch the hand-written kernel once per call (never the plain version)
    and equal the direct wrapper's output bit for bit."""
    from gan_class_transfer2_tpu_torch.ops import norm

    _needs_card(monkeypatch)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 32, 32, 128), generator=g, device="cuda")
    k = torch.randn((4, 4, 128, 256), generator=g, device="cuda") * 0.05
    b = torch.randn((256,), generator=g, device="cuda")
    gamma, beta = torch.randn((128,), generator=g, device="cuda"), torch.zeros(128, device="cuda")
    for relu in (True, False):
        fdc.down_conv_fused.launches = 0
        y = torch.ops.gct2.down_conv_k4s2(x, k, b, relu)
        assert fdc.down_conv_fused.launches == 1
        assert torch.equal(y, fdc._forward(x, k, b, relu))
    norm.instance_norm_fused.launches = 0
    y = torch.ops.gct2.instance_norm(x, gamma, beta)
    assert norm.instance_norm_fused.launches == 1
    assert torch.equal(y, norm.instance_norm_fused(x, gamma, beta))


@pytest.mark.cuda
def test_bundle_sample_launches_b4_on_card(monkeypatch, tmp_path):
    """A bundle exported on the card at the default width (stride 50: 4
    denoiser calls) launches B4 4 times a call through the exported custom
    op, and agrees with the in-process sampler within 1e-4 of the scale."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.sample import sampler
    from gan_class_transfer2_tpu_torch.train import trainer
    from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib

    _needs_card(monkeypatch)
    cfg = Config(conv_impl="pallas", sample_stride=50).validate()
    state = trainer.init_state(cfg, device="cuda")
    bundle_lib.export_bundle(cfg, state, str(tmp_path), programs=["sample"])
    bundle = bundle_lib.load_bundle(str(tmp_path), "cuda")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 256, 256, 3))
                         .astype(np.float32)).cuda()
    fdc.down_conv_fused.launches = 0
    got = bundle.call("sample", x)
    assert fdc.down_conv_fused.launches == 4 * len(sampler.sample_timesteps(cfg)) == 16
    want = sampler.sample(cfg, state.model, x, snapshots=False).images
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_inception_pool3_on_card_matches_the_cpu(monkeypatch):
    """InceptionV3 pool3 on the card (cuDNN convs inside the port's
    ieee_fp32 region) against the port on the CPU, both variants, on the
    seeded synthetic state dict, upsampled 256² and downsampled 320²
    inputs: within 1e-4 of the features' scale (IEEE float32 sums in other
    orders through 94 convs)."""
    from gan_class_transfer2_tpu_torch.utils import inception

    _needs_card(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # the region turns it off
    params = inception.fold_state_dict(inception.synthetic_state_dict(0))
    on_card = {k: {n: t.cuda() for n, t in p.items()} for k, p in params.items()}
    r = np.random.default_rng(3)
    for shape in ((2, 256, 256, 3), (1, 320, 320, 3)):
        x = torch.from_numpy(r.uniform(-1, 1, shape).astype(np.float32))
        for variant in ("fid", "torchvision"):
            want = inception.pool3_features(params, x, variant).numpy()
            got = inception.pool3_features(on_card, x.cuda(), variant).cpu().numpy()
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-4 * scale, (shape, variant)
    assert torch.backends.cudnn.allow_tf32  # restored after the region


@pytest.mark.cuda
def test_two_replica_service_on_card_equals_one_replica(monkeypatch):
    """A service over two replicas sharing cuda:0 (parallel/mesh.LocalMesh)
    against the service without a mesh on the same weights: /sample num 3
    within 1 level on at most 1e-3 of the values, /denoise within 2e-4;
    each replica's block launches B4 once per admitted down conv a
    denoiser call, so the two-replica sample launches exactly 2 × that;
    /sample num 1 runs on the first replica alone, with one replica's
    launches."""
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.sample import sampler
    from gan_class_transfer2_tpu_torch.serve.server import ModelService
    from gan_class_transfer2_tpu_torch.train import trainer

    _needs_card(monkeypatch)
    cfg = tiny_test_config(size=32, pixel_size=128, max_size=128, block_depth=1,
                           conv_impl="pallas", sample_stride=3)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    one = ModelService(cfg, state=state, device="cuda")
    two = ModelService(cfg, state=state, mesh=mesh_lib.make_mesh(devices=["cuda:0", "cuda:0"]),
                       device="cuda")
    try:
        calls = len(sampler.sample_timesteps(cfg))
        fdc.down_conv_fused.launches = 0
        a = one.sample(3)
        assert fdc.down_conv_fused.launches == 2 * calls  # 2 admitted down convs a call
        fdc.down_conv_fused.launches = 0
        b = two.sample(3)
        assert fdc.down_conv_fused.launches == 2 * 2 * calls
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        fdc.down_conv_fused.launches = 0
        a = one.sample(1)
        alone = fdc.down_conv_fused.launches
        fdc.down_conv_fused.launches = 0
        b = two.sample(1)  # fewer rows than replicas: the first replica alone
        assert alone > 0 and fdc.down_conv_fused.launches == alone
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        img = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(two.denoise(img), one.denoise(img), rtol=2e-4, atol=2e-4)
    finally:
        one.close()
        two.close()
