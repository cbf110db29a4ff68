"""Compiled model bundles in the port: gan_class_transfer2_tpu_torch's
utils/bundle.py, the B4/B3 custom ops it exports through, and the
``export-model`` / ``sample --bundle`` commands, against the port in process
and against gan_class_transfer2_tpu's bundles and sampler, on the CPU.

Tolerances, each with its reason:
  * bundle against the port in process: bit for bit — the exported graph
    keeps the eager op order, and the bundle runs the sampler's own step body
    once per timestep of the manifest's visit list;
  * against JAX (its ``export_bundle(..., platforms=("cpu",))`` and its
    in-process sampler, on carried weights): test_torch_sampler.py's 1e-4 of
    the array's scale; GAN transfers 1e-5 of the scale (one float32
    generator forward each side).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.models import api as japi  # noqa: E402
from gan_class_transfer2_tpu.sample import sampler as jsampler  # noqa: E402
from gan_class_transfer2_tpu.train import gan as jgan  # noqa: E402
from gan_class_transfer2_tpu.utils import bundle as jbundle  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import norm  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
# a small width at which a down conv of a 2-octave U-Net passes B4's gate
# (C % 128 == 0, a ≥ 16² input): the second, 16² × 128 channels; the first
# (the 3-channel image) is an aten convolution, as at the default width
GATED = dict(size=32, pixel_size=128, max_size=256, octaves=2, steps=6, test_step=3)
CONV_TARGETS = ("aten.conv2d.default", "aten.convolution.default")


def _jcfg(**overrides):
    return jconfig.tiny_test_config(**overrides)


def _port(jcfg) -> Config:
    return Config.from_json(jcfg.to_json())


def _noise(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale)


def _state_from_jax(cfg, jparams):
    """A port TrainState whose model holds the JAX params (no EMA)."""
    model = weights.from_jax_params(cfg, jparams, device="cpu")
    return trainer.TrainState(0, model, None, None, None)


def _gated_downs(cfg):
    """(down convs of one denoiser call, those B4's gate admits)."""
    stem = 3 + (cfg.class_embed_dim if cfg.num_classes > 0 else 0)
    gated, c = 0, cfg.pixel_size if cfg.block_depth else stem
    for i in range(cfg.octaves):
        f, hw = cfg.octave_filters(i), cfg.size >> i
        gated += fdc.supported((1, hw, hw, c), (4, 4, c, f))
        c = f
    return cfg.octaves, gated


def _graph_counts(path):
    """(gct2::down_conv_k4s2 nodes, gct2::instance_norm nodes, stride-2
    aten convolutions) of a saved program."""
    ep = torch.export.load(path)
    targets = [(str(n.target), n.args) for n in ep.graph.nodes if n.op == "call_function"]
    downs = sum(t == "gct2.down_conv_k4s2.default" for t, _ in targets)
    norms = sum(t == "gct2.instance_norm.default" for t, _ in targets)
    strided = sum(t in CONV_TARGETS and list(a[3]) == [2, 2] for t, a in targets)
    return downs, norms, strided


# ----------------------------------------------------------- the custom ops


@pytest.mark.parametrize("b", [1, 3])
def test_custom_ops_pass_opcheck(b):
    """Schema, fake implementation (symbolic batch under aot dispatch) and
    autograd registration of both ops, on the CPU."""
    g = torch.Generator().manual_seed(b)
    x = torch.randn((b, 16, 16, 128), generator=g)
    k, bias = torch.randn((4, 4, 128, 256), generator=g), torch.randn((256,), generator=g)
    for relu in (True, False):
        torch.library.opcheck(fdc.down_conv_op, (x, k, bias, relu))
    y = torch.randn((b, 8, 8, 64), generator=g)
    torch.library.opcheck(norm.instance_norm_op,
                          (y, torch.randn((64,), generator=g), torch.randn((64,), generator=g)))


def test_custom_ops_are_the_plain_versions_on_the_cpu_and_count_no_launch():
    g = torch.Generator().manual_seed(0)
    x, k, bias = (torch.randn(s, generator=g) for s in ((2, 16, 16, 128), (4, 4, 128, 128),
                                                          (128,)))
    y, gamma, beta = (torch.randn(s, generator=g) for s in ((2, 8, 8, 32), (32,), (32,)))
    n4, n3 = fdc.down_conv_fused.launches, norm.instance_norm_fused.launches
    assert torch.equal(torch.ops.gct2.down_conv_k4s2(x, k, bias, True),
                       fdc.down_conv_plain(x, k, bias, True))
    assert torch.equal(torch.ops.gct2.instance_norm(y, gamma, beta),
                       norm.instance_norm_plain(y, gamma, beta))
    assert (fdc.down_conv_fused.launches, norm.instance_norm_fused.launches) == (n4, n3)


# ------------------------------------------------------- diffusion bundles


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """A bundle of a U-Net whose down convs pass B4's gate, exported on the
    CPU, and the port's state it came from (random weights, an EMA)."""
    cfg = Config(**GATED, ema_decay=0.9).validate()
    state = trainer.init_state(cfg, device="cpu")
    with torch.no_grad():
        for e in state.ema_params:
            e.mul_(0.5)  # the EMA is what a bundle holds
    out = str(tmp_path_factory.mktemp("bundles") / "gated")
    manifest = bundle_lib.export_bundle(cfg, state, out)
    return cfg, state, out, manifest


def test_exported_graphs_hold_the_kernels_by_name(gated):
    cfg, _, out, manifest = gated
    downs, gated_downs = _gated_downs(cfg)
    assert (downs, gated_downs) == (2, 1)
    for name in ("denoise", "sample", "invert", "preview"):
        got = _graph_counts(os.path.join(out, manifest["programs"][name]["file"]))
        # each program is one denoiser call (sample and invert: the step body)
        assert got == (gated_downs, 0, downs - gated_downs), name


def test_lax_bundle_has_no_custom_op(tmp_path):
    """At 64 channels B4's gate refuses every down conv: the bundle holds
    aten convolutions only."""
    cfg = Config(**dict(GATED, pixel_size=64, max_size=64)).validate()
    assert _gated_downs(cfg) == (2, 0)
    out = str(tmp_path / "b")
    bundle_lib.export_bundle(cfg, trainer.init_state(cfg, device="cpu"), out,
                             programs=["denoise"])
    assert _graph_counts(os.path.join(out, "denoise.pt2")) == (0, 0, 2)


@pytest.mark.parametrize("b", [1, 3])
def test_gated_bundle_equals_the_port_in_process(gated, b):
    """Batch-polymorphic programs, bit for bit with the in-process sampler
    on the EMA weights."""
    cfg, state, out, _ = gated
    bundle = bundle_lib.load_bundle(out, "cpu")
    model = trainer.eval_model(state)
    x = torch.from_numpy(_noise((b, cfg.size, cfg.size, 3), b))
    n = torch.from_numpy(_noise((b, cfg.size, cfg.size, 3), b + 10))
    t = torch.arange(1, b + 1, dtype=torch.int32)
    with torch.inference_mode():
        assert torch.equal(bundle.call("sample", x),
                           sampler.sample(cfg, model, x, snapshots=False).images)
        gx, ge = bundle.call("invert", x)
        wx, we = sampler.invert(cfg, model, x)
        assert torch.equal(gx, wx) and torch.equal(ge, we)
        assert torch.equal(bundle.call("preview", x, n), sampler.preview(cfg, model, x, n)[0])
        assert torch.equal(bundle.call("denoise", x, t),
                           api.apply_denoiser(cfg, model, x, t).float())


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX's bundle of the tiny config (exported for the CPU) and the port's
    bundle of the same weights carried across."""
    jcfg = _jcfg()
    cfg = _port(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, japi.init_denoiser(jax.random.PRNGKey(0),
                                                                     jcfg))
    base = tmp_path_factory.mktemp("carried")
    jstate = jax.tree_util.tree_map(jnp.asarray, {"params": jparams})
    jmanifest = jbundle.export_bundle(
        jcfg, _JaxState(jnp.zeros((), jnp.int32), jstate["params"], None), str(base / "jax"),
        platforms=("cpu",))
    manifest = bundle_lib.export_bundle(cfg, _state_from_jax(cfg, jparams), str(base / "port"))
    return jcfg, cfg, jparams, jbundle.load_bundle(str(base / "jax")), jmanifest, \
        bundle_lib.load_bundle(str(base / "port"), "cpu"), manifest


class _JaxState:
    """The fields of a JAX TrainState that export_bundle reads."""

    def __init__(self, step, params, ema_params):
        self.step, self.params, self.ema_params = step, params, ema_params


@pytest.mark.parametrize("b", [1, 3])
def test_bundle_programs_match_the_jax_bundle(carried, b):
    jcfg, cfg, jparams, jb, _, pb, _ = carried
    x = _noise((b, cfg.size, cfg.size, 3), b)
    n = _noise((b, cfg.size, cfg.size, 3), b + 5)
    t = np.arange(1, b + 1, dtype=np.int32)
    _close(pb.call("sample", x), jb.call("sample", jnp.asarray(x)))
    _close(pb.call("sample", x), jsampler.sample(jcfg, jparams, jnp.asarray(x)).images)
    for got, want in zip(pb.call("invert", x), jb.call("invert", jnp.asarray(x))):
        _close(got, want)
    _close(pb.call("preview", x, n), jb.call("preview", jnp.asarray(x), jnp.asarray(n)))
    _close(pb.call("denoise", x, t), jb.call("denoise", jnp.asarray(x), jnp.asarray(t)))


def test_manifest_keeps_the_jax_keys(carried):
    _, cfg, _, _, jmanifest, pb, manifest = carried
    assert set(manifest) == set(jmanifest) - {"jax_version", "calling_convention_version"} | {
        "torch_version"}
    assert manifest["torch_version"] == torch.__version__
    assert manifest["platforms"] == ["cuda", "cpu"] and manifest["format_version"] == 1
    assert manifest["config"] == json.loads(cfg.to_json())
    assert sorted(manifest["programs"]) == sorted(jmanifest["programs"]) == pb.programs
    for name, entry in manifest["programs"].items():
        assert entry["file"] == f"{name}.pt2"
        # the user's signature, "b" for the batch, as JAX's manifest gives it
        assert entry["inputs"] == jmanifest["programs"][name]["inputs"], name
        assert len(entry["outputs"]) == len(jmanifest["programs"][name]["outputs"]), name
    assert manifest["programs"]["sample"]["timesteps"] == list(
        sampler.sample_timesteps(cfg))
    assert manifest["programs"]["invert"]["timesteps"] == list(range(1, cfg.steps + 1))


def test_conditional_bundle_matches_jax_and_the_port(tmp_path):
    jcfg = _jcfg(num_classes=3, sample_stride=2)
    cfg = _port(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, japi.init_denoiser(jax.random.PRNGKey(1),
                                                                     jcfg))
    state = _state_from_jax(cfg, jparams)
    manifest = bundle_lib.export_bundle(cfg, state, str(tmp_path / "b"))
    assert len(manifest["programs"]["sample"]["inputs"]) == 2
    b = bundle_lib.load_bundle(str(tmp_path / "b"), "cpu")
    x = _noise((3, cfg.size, cfg.size, 3), 0)
    c = np.asarray([2, 0, 1], np.int32)
    got = b.call("sample", x, c)
    assert torch.equal(got, sampler.sample(cfg, state.model, torch.from_numpy(x),
                                           torch.from_numpy(c), snapshots=False).images)
    _close(got, jsampler.sample(jcfg, jparams, jnp.asarray(x), class_idx=jnp.asarray(c)).images)
    n = _noise((3, cfg.size, cfg.size, 3), 1)
    _close(b.call("preview", x, n, c), jsampler.preview(jcfg, jparams, jnp.asarray(x),
                                                        jnp.asarray(n), jnp.asarray(c))[0])


# ---------------------------------------------------------------- GANs


def test_gan_bundle_matches_jax_and_the_port(tmp_path):
    jcfg = _jcfg(g_norm="instance", d_norm="instance")
    cfg = _port(jcfg)
    jst = jax.tree_util.tree_map(np.asarray, jgan.init_gan_state(jcfg, jax.random.PRNGKey(0)))
    state = weights.from_jax_gan_state(cfg, jst, device="cpu")
    manifest = bundle_lib.export_bundle(cfg, state, str(tmp_path / "g"), model="gan")
    assert sorted(manifest["programs"]) == ["transfer_ab", "transfer_ba"]
    b = bundle_lib.load_bundle(str(tmp_path / "g"), "cpu")
    x = _noise((3, cfg.size, cfg.size, 3), 2)
    for d in ("ab", "ba"):
        got = b.call(f"transfer_{d}", x)
        with torch.inference_mode():
            assert torch.equal(got, gan.transfer(cfg, state, torch.from_numpy(x), d))
        _close(got, jgan.transfer(jcfg, jax.tree_util.tree_map(jnp.asarray, jst),
                                  jnp.asarray(x), d), tol=1e-5)
        # each transfer is one generator: its norms are gct2::instance_norm
        downs, norms, _ = _graph_counts(os.path.join(str(tmp_path / "g"), f"transfer_{d}.pt2"))
        assert norms == 2 * cfg.octaves and downs == 0


def test_cgan_bundle_matches_the_port(tmp_path):
    cfg = Config(**dict(GATED, num_classes=3, g_norm="instance", d_norm="instance")).validate()
    state = cgan.init_conditional_gan_state(cfg, device="cpu")
    manifest = bundle_lib.export_bundle(cfg, state, str(tmp_path / "c"), model="cgan")
    assert list(manifest["programs"]) == ["transfer"]
    assert _graph_counts(os.path.join(str(tmp_path / "c"), "transfer.pt2"))[:2] == (
        _gated_downs(cfg)[1], 2 * cfg.octaves)
    b = bundle_lib.load_bundle(str(tmp_path / "c"), "cpu")
    x = torch.from_numpy(_noise((2, cfg.size, cfg.size, 3), 3))
    target = torch.tensor([2, 1], dtype=torch.int32)
    with torch.inference_mode():
        assert torch.equal(b.call("transfer", x, target), cgan.transfer(cfg, state, x, target))


# ---------------------------------------------------- manifest and errors


def test_program_subsets_are_refused_as_jax_refuses_them(tmp_path):
    jcfg = _jcfg()
    cfg = _port(jcfg)
    state = trainer.init_state(cfg, device="cpu")
    jstate = _JaxState(0, japi.init_denoiser(jax.random.PRNGKey(0), jcfg), None)
    for programs in ([], ["denoise", "banana"]):
        with pytest.raises(ValueError) as want:
            jbundle.export_bundle(jcfg, jstate, str(tmp_path / "j"), programs=programs,
                                  platforms=("cpu",))
        with pytest.raises(ValueError) as got:
            bundle_lib.export_bundle(cfg, state, str(tmp_path / "p"), programs=programs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown model kind 'vae'"):
        bundle_lib.export_bundle(cfg, state, str(tmp_path / "p"), model="vae")
    with pytest.raises(ValueError, match="platforms"):
        bundle_lib.export_bundle(cfg, state, str(tmp_path / "p"), platforms=("tpu",))
    out = str(tmp_path / "d")
    manifest = bundle_lib.export_bundle(cfg, state, out, programs=["denoise"],
                                        platforms=("cuda",))
    assert list(manifest["programs"]) == ["denoise"]
    with pytest.raises(ValueError, match=r"runs on \['cuda'\], not on 'cpu'"):
        bundle_lib.load_bundle(out, "cpu")


def test_load_errors_match_jax(tmp_path):
    cfg = _port(_jcfg())
    out = str(tmp_path / "b")
    bundle_lib.export_bundle(cfg, trainer.init_state(cfg, device="cpu"), out,
                             programs=["denoise"])
    b = bundle_lib.load_bundle(out, "cpu")
    with pytest.raises(KeyError, match=r"no program 'sample'; available: \['denoise'\]"):
        b.call("sample", np.zeros((1, 16, 16, 3), np.float32))
    path = os.path.join(out, "manifest.json")
    with open(path) as fh:
        m = json.load(fh)
    m["format_version"] = 99
    with open(path, "w") as fh:
        json.dump(m, fh)
    for d in (out, str(tmp_path / "missing")):
        with pytest.raises((ValueError, FileNotFoundError)) as want:
            jbundle.load_bundle(d)
        with pytest.raises(type(want.value)) as got:
            bundle_lib.load_bundle(d, "cpu")
        assert str(got.value) == str(want.value)


# -------------------------------------------------------------- the CLI


TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4", "--batch-size", "2"]


def test_cli_export_model_and_sample_bundle_equal_the_checkpoint(tmp_path, capsys):
    """export-model → sample --bundle: PNGs byte-equal to sample
    --checkpoint-dir at the same seed, JAX's printed lines; a bundle with no
    sample program and class indices are refused with JAX's messages."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    for classes in (0, 3):
        cfg = Config.from_json(_jcfg(steps=4, num_classes=classes, ema_decay=0.9).to_json())
        ckpt = str(tmp_path / f"ckpt{classes}")
        ckpt_lib.save(ckpt, trainer.init_state(cfg, device="cpu")._replace(step=5), cfg.replace(
            checkpoint_dir=ckpt))
        out = str(tmp_path / f"bundle{classes}")
        assert cli.main(["export-model", "--device", "cpu", "--checkpoint-dir", ckpt,
                         "--out", out]) == 0
        printed = capsys.readouterr().out
        assert (f"wrote bundle to {out}: programs [denoise, invert, preview, sample] "
                "(step 5, platforms ['cuda', 'cpu'])") in printed
        cls = ["--class-idx", "2"] if classes else []
        for kind, src in (("b", ["--bundle", out]), ("c", ["--checkpoint-dir", ckpt])):
            assert cli.main(["sample", "--device", "cpu", *src, "--num", "3", *cls,
                             "--out", str(tmp_path / f"{kind}{classes}")]) == 0
        for i in range(3):
            with open(tmp_path / f"b{classes}" / f"sample_{i}.png", "rb") as a, \
                    open(tmp_path / f"c{classes}" / f"sample_{i}.png", "rb") as c:
                assert a.read() == c.read()
    assert "(bundle step 5," in capsys.readouterr().out
    with pytest.raises(SystemExit, match=r"--class-idx must be in \[0, 3\)"):
        cli.main(["sample", "--device", "cpu", "--bundle", str(tmp_path / "bundle3"),
                  "--class-idx", "3"])
    with pytest.raises(SystemExit, match="--class-idx: bundle is unconditional"):
        cli.main(["sample", "--device", "cpu", "--bundle", str(tmp_path / "bundle0"),
                  "--class-idx", "0"])
    gcfg = Config.from_json(_jcfg(g_norm="instance").to_json())
    gckpt = str(tmp_path / "gckpt")
    ckpt_lib.save(gckpt, gan.init_gan_state(gcfg, device="cpu"), gcfg.replace(
        checkpoint_dir=gckpt))
    assert cli.main(["export-model", "--device", "cpu", "--checkpoint-dir", gckpt, "--model",
                     "gan", "--out", str(tmp_path / "gb"), "--export-platforms", "cpu"]) == 0
    with pytest.raises(SystemExit, match=r"has no 'sample' program \(model=gan, programs="
                       r"\['transfer_ab', 'transfer_ba'\]\)"):
        cli.main(["sample", "--device", "cpu", "--bundle", str(tmp_path / "gb")])
    with pytest.raises(SystemExit, match="export needs trained weights"):
        cli.main(["export-model", "--device", "cpu", "--checkpoint-dir",
                  str(tmp_path / "none"), "--out", str(tmp_path / "x")])
