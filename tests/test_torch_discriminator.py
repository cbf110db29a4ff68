"""Port parity: the GAN discriminator of gan_class_transfer2_tpu_torch against
gan_class_transfer2_tpu.models.discriminator, with the same weights carried
across by utils/weights.py, on the same numpy inputs, on the CPU.

Tolerances: 1e-5 absolute on the float32 logits at the tiny widths (IEEE
float32 on both sides, summation order only); 1e-4 at the 128-channel config
whose k4/s2 sums run over 2048 and 4096 terms and which reaches B4's plain
version with ``relu=False``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.config import Config as JConfig  # noqa: E402
from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.models import discriminator as jdisc  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import discriminator as disc  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)

B4_REACHING = dict(size=32, d_pixel_size=128, max_size=256, d_octaves=2)


def jax_disc_params(jcfg, num_classes=0, seed=0):
    """JAX-initialised discriminator params, with random biases and norm
    γ/β (so a misplaced norm or activation shows), as numpy."""
    params = jdisc.init_discriminator(jax.random.PRNGKey(seed), jcfg, num_classes=num_classes)
    r = np.random.default_rng(seed)

    def leaf(path, p):
        p = np.asarray(p)
        key = getattr(path[-1], "key", None)
        if key in ("bias", "beta"):
            return (r.normal(size=p.shape) * 0.1).astype(np.float32)
        if key == "gamma":
            return r.normal(1.0, 0.3, p.shape).astype(np.float32)
        return p

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("patch", [True, False], ids=["patch", "pooled"])
@pytest.mark.parametrize("d_norm", ["none", "instance", "batch"])
def test_discriminator_apply_matches_jax(patch, d_norm):
    jcfg = jax_tiny(d_norm=d_norm, patch_discriminator=patch)
    cfg = tiny_test_config(d_norm=d_norm, patch_discriminator=patch)
    params = jax_disc_params(jcfg)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    x = np.random.default_rng(1).uniform(-1, 1, (3, cfg.size, cfg.size, 3)).astype(np.float32)
    want = np.asarray(jdisc.discriminator_apply(jcfg, params, jnp.asarray(x)))
    got = disc.discriminator_apply(cfg, model, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    s = cfg.size // 2 ** cfg.octaves
    assert want.shape == ((3, s, s, 1) if patch else (3, 1))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert ("convs.1.norm.gamma" in dict(model.named_parameters())) == (d_norm != "none")
    assert "convs.0.norm.gamma" not in dict(model.named_parameters())  # CycleGAN: not layer 0


@pytest.mark.parametrize("d_norm", ["none", "instance"])
def test_discriminator_reaches_the_down_conv_kernels_plain_version(d_norm):
    """At 128 channels the B4 gate admits layer 1 (16²×128 → 8²×256): it
    goes through ``down_conv_fused`` with ``relu=False`` (its plain version
    on the CPU) and still matches JAX."""
    jcfg = jax_tiny(d_norm=d_norm, **B4_REACHING)
    cfg = tiny_test_config(d_norm=d_norm, **B4_REACHING)
    assert fused_down_conv.supported((2, 16, 16, 128), (4, 4, 128, 256))
    params = jax_disc_params(jcfg, seed=2)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jdisc.discriminator_apply(jcfg.replace(conv_impl="lax"), params,
                                                jnp.asarray(x)))
    calls = []
    orig = fused_down_conv.down_conv_fused

    def spy(x, kernel, bias, relu=True):
        calls.append((tuple(x.shape), relu))
        return orig(x, kernel, bias, relu)

    try:
        fused_down_conv.down_conv_fused = spy
        got = disc.discriminator_apply(cfg, model, torch.from_numpy(x))
    finally:
        fused_down_conv.down_conv_fused = orig
    assert calls == [((2, 16, 16, 128), False)]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


@pytest.mark.parametrize("patch", [True, False], ids=["patch", "pooled"])
def test_projection_term_matches_jax(patch):
    """The class-conditional projection ⟨embed_y, feat⟩ (the conditional
    GAN's discriminator; the port's Config still refuses num_classes > 0,
    the module takes it)."""
    jcfg = jax_tiny(d_norm="instance", patch_discriminator=patch)
    cfg = tiny_test_config(d_norm="instance", patch_discriminator=patch)
    params = jax_disc_params(jcfg, num_classes=3, seed=4)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    assert model.class_embed.shape == (3, 8)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    labels = np.array([2, 0])
    want = np.asarray(jdisc.discriminator_apply(jcfg, params, jnp.asarray(x),
                                                jnp.asarray(labels)))
    got = disc.discriminator_apply(cfg, model, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_bfloat16_logits_are_float32_and_close():
    jcfg = jax_tiny(d_norm="instance", compute_dtype="bfloat16")
    cfg = tiny_test_config(d_norm="instance", compute_dtype="bfloat16")
    params = jax_disc_params(jcfg, seed=6)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    x = np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jdisc.discriminator_apply(jcfg, params, jnp.asarray(x)))
    got = disc.discriminator_apply(cfg, model, torch.from_numpy(x))
    assert got.dtype == torch.float32
    # bfloat16 rounds at other places in the two frameworks: 5e-2 of max|logit|
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("overrides", [dict(), dict(d_norm="instance", d_pixel_size=6,
                                                    d_octaves=1)])
def test_params_round_trip_and_count(overrides):
    jcfg, cfg = jax_tiny(**overrides), tiny_test_config(**overrides)
    params = jax_disc_params(jcfg, num_classes=2)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    back = weights.to_jax_discriminator_params(model)
    tree = jax.tree_util
    assert tree.tree_structure(back) == tree.tree_structure(params)
    for a, b in zip(tree.tree_leaves(back), tree.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert disc.param_count(model) == jdisc.param_count(params)


def test_default_discriminator_size_matches_jax():
    """The default config's discriminator (6 layers, 128 → 512 filters):
    the same parameter count as the JAX init's, ≈15.2 M."""
    jparams = jax.eval_shape(lambda k: jdisc.init_discriminator(k, JConfig(d_norm="instance")),
                             jax.random.PRNGKey(0))
    n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jparams))
    model = disc.Discriminator(Config(d_norm="instance").validate())
    assert disc.param_count(model) == n
    assert 15.0e6 < n < 15.5e6


def test_init_is_seeded_glorot_with_unit_norms():
    cfg = tiny_test_config(d_norm="instance")
    a = disc.init_discriminator(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = disc.init_discriminator(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    k = a.convs[1].kernel
    limit = (6.0 / (16 * k.shape[2] + 16 * k.shape[3])) ** 0.5
    assert 0.5 * limit < k.abs().max().item() <= limit
    assert torch.equal(a.convs[1].norm.gamma, torch.ones(8))
    assert torch.equal(a.convs[1].norm.beta, torch.zeros(8))
    assert torch.equal(a.convs[0].bias, torch.zeros(4))


def test_init_discriminator_defaults_to_the_card():
    """Like ``init_denoiser``, the entry point runs on the card unless the
    caller asks for the CPU; without a card the default raises and names
    the CPU option, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default would succeed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        disc.init_discriminator(tiny_test_config(), torch.Generator().manual_seed(0))
