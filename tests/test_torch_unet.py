"""Port parity: the Denoiser U-Net of gan_class_transfer2_tpu_torch against
gan_class_transfer2_tpu.models.unet, with the same weights carried across by
utils/weights.py, on the same numpy inputs.

Tolerances: 2e-4 against the Keras golden (the bound
test_reference_parity.py holds the JAX package to); 1e-5 against the JAX
forward at tiny widths (both IEEE float32, summation order only); 1e-4 at
the 128-channel config whose k4/s2 sums run over 2048 terms."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.models import unet as junet  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api, unet  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(1)


def jax_params(jcfg, seed=0):
    """JAX-initialised params with random biases, as numpy."""
    params = junet.init_unet(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)

    def leaf(path, p):
        p = np.asarray(p)
        if getattr(path[-1], "key", None) == "bias":
            return (r.normal(size=p.shape) * 0.1).astype(np.float32)
        return p

    return jax.tree_util.tree_map_with_path(leaf, params)


def test_default_config_param_count():
    assert unet.param_count(unet.Denoiser(Config().validate())) == 41_691_660


def test_forward_parity_against_golden_npz():
    path = os.path.join(os.path.dirname(__file__), "golden", "forward_parity.npz")
    data = np.load(path)
    cfg = tiny_test_config(size=32, pixel_size=8, max_size=32, octaves=3)
    model = weights.import_flat_weights(unet.Denoiser(cfg), weights.load_flat_npz(path))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, torch.from_numpy(data["x"]))
    np.testing.assert_allclose(y.numpy(), data["y"], atol=2e-4)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(),
        dict(skip_mode="residual"),
        dict(skip_mode="none"),
        dict(block_depth=1),
        dict(block_depth=1, concat_elision=False),
        dict(per_step_output=True),
        dict(conv_impl="shuffle"),
    ],
    ids=["concat", "residual", "none", "depth1", "depth1-no-elision", "per-step", "shuffle"],
)
def test_from_jax_params_forward_parity(overrides):
    """The port's config from the JAX config's JSON; the JAX forward takes
    the conv route its config names, the port the one route it has."""
    jcfg = jax_tiny(**overrides)
    cfg = Config.from_json(jcfg.to_json())
    params = jax_params(jcfg)
    model = weights.from_jax_params(cfg, params, device="cpu")
    r = np.random.default_rng(1)
    x = r.uniform(-1, 1, (2, cfg.size, cfg.size, 3)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    ref = np.asarray(junet.unet_apply(jcfg, params, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, torch.from_numpy(x), torch.from_numpy(t))
    assert y.shape == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)


def test_a_jax_config_naming_a_conv_route_loads_and_writes_none():
    """The JAX package's conv route has no field in the port: its JSON
    (here naming ``pallas``, as the benchmark's configurations do) loads
    with the key dropped, the port writes no such key, and the JAX package
    reads the port's JSON back at its default route."""
    cfg = Config.from_json(jconfig.Config(conv_impl="pallas").to_json())
    assert cfg == Config().validate()
    assert "conv_impl" not in json.loads(cfg.to_json())
    assert jconfig.Config.from_json(cfg.to_json()).conv_impl == jconfig.Config().conv_impl


def test_pallas_impl_runs_the_fused_down_conv_path(monkeypatch):
    """A config wide enough for the kernel's gate (C = 128 into a 16² down
    conv): the port routes that conv to fused_down_conv (its plain version
    on the CPU, launching nothing) and matches the JAX forward."""
    kw = dict(size=32, pixel_size=128, max_size=256, octaves=2)
    jcfg, cfg = jax_tiny(**kw), tiny_test_config(**kw)
    assert fused_down_conv.supported((1, 16, 16, 128), (4, 4, 128, 256))
    params = jax_params(jcfg)
    model = weights.from_jax_params(cfg, params, device="cpu")
    x = np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(junet.unet_apply(jcfg.replace(conv_impl="lax"), params, jnp.asarray(x)))
    calls = []
    real = fused_down_conv.down_conv_plain
    monkeypatch.setattr(fused_down_conv, "down_conv_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, torch.from_numpy(x))
    assert len(calls) == 1 and fused_down_conv.down_conv_fused.launches == 0
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-4)


def test_bf16_compute_casts_params_at_apply():
    cfg = tiny_test_config(compute_dtype="bfloat16")
    model = api.init_denoiser(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, x)
        y32 = api.apply_denoiser(cfg.replace(compute_dtype="float32"), model, x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), atol=5e-2)


def test_init_is_seeded_glorot():
    cfg = tiny_test_config()
    a = api.init_denoiser(cfg, device="cpu")
    b = api.init_denoiser(cfg, device="cpu")
    c = api.init_denoiser(cfg, torch.Generator().manual_seed(1), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.octaves[0].down.kernel, c.octaves[0].down.kernel)
    k = a.octaves[1].up.kernel.detach()  # transposed conv: TF fans on (kh, kw, out, in)
    kh, kw, i, o = k.shape
    limit = (6.0 / (kh * kw * o + kh * kw * i)) ** 0.5
    assert k.abs().max() <= limit and k.abs().max() > 0.9 * limit
    assert not any(layer.bias.detach().any() for layer in (a.head, a.octaves[0].down))


def test_refused_features_name_the_missing_piece():
    from gan_class_transfer2_tpu_torch.parallel import pipeline

    cfg = tiny_test_config(pipeline_stages=2)  # pipeline parallelism is ported
    # what the pipeline cannot take it refuses by name, as JAX does
    with pytest.raises(ValueError, match="unconditional Denoiser only"):
        pipeline.PipelineTrainer(cfg.replace(num_classes=2), device="cpu")
    assert tiny_test_config(mesh_model=2).mesh_model == 2  # tensor parallelism is ported
    assert tiny_test_config(zero1=True).zero1  # ZeRO-1 is ported (parallel/mesh.py)
    assert tiny_test_config(num_classes=2).num_classes == 2  # the conditional model is ported
    with pytest.raises(ValueError, match="unknown norm"):
        tiny_test_config(g_norm="layer")
    with pytest.raises(ValueError, match="unknown norm"):
        tiny_test_config(d_norm="banana")


@pytest.mark.parametrize("overrides", [
    dict(g_norm="instance"),
    dict(g_norm="batch"),
    dict(g_norm="instance", block_depth=1, concat_elision=False),
    dict(g_norm="instance", skip_mode="residual"),
    dict(g_norm="instance", size=32, pixel_size=128, max_size=256),
], ids=["instance", "batch", "instance-depth1-no-elision", "instance-residual",
        "instance-pallas"])
def test_g_norm_forward_parity(overrides):
    """g_norm on: the norms sit between each k4/s2 conv and its ReLU, on the
    summed pre-activation of a (branch, skip) pair, as unet.py:163-213 has
    them. Norm γ/β are drawn at random so a misplaced norm or ReLU shows.
    1e-5 at the tiny widths; 1e-4 at the 128-channel config (k4/s2 sums over
    2048 terms) that reaches B4's plain version with ``relu=False``."""
    jcfg, cfg = jax_tiny(**overrides), tiny_test_config(**overrides)
    params = jax_params(jcfg)
    r = np.random.default_rng(4)
    for level in params["octaves"]:
        for name in ("down_norm", "up_norm"):
            c = level[name]["gamma"].shape[0]
            level[name] = {"gamma": r.normal(1.0, 0.3, c).astype(np.float32),
                           "beta": r.normal(0.0, 0.3, c).astype(np.float32)}
    model = weights.from_jax_params(cfg, params, device="cpu", out_channels=3)
    x = r.uniform(-1, 1, (2, cfg.size, cfg.size, 3)).astype(np.float32)
    ref = np.asarray(junet.unet_apply(jcfg.replace(conv_impl="lax"), params, jnp.asarray(x)))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, torch.from_numpy(x))
    assert "octaves.0.down_norm.gamma" in dict(model.named_parameters())
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-4 if cfg.pixel_size == 128 else 1e-5)


def _loss_and_grads(cfg, model, x):
    """The mean square of the forward, its gradients, and how many tensors
    autograd saved for the backward."""
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(1) or t, lambda t: t):
        loss = api.apply_denoiser(cfg, model, x).float().square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads, len(saved)


@pytest.mark.parametrize("overrides", [dict(octaves=3), dict(octaves=3, g_norm="instance")],
                         ids=["plain", "instance-norm"])
def test_remat_rematerialises_with_equal_loss_and_gradients(overrides):
    """cfg.remat wraps each inner octave in torch.utils.checkpoint, as JAX
    wraps it in jax.checkpoint (unet.py:255-257): the loss and every
    gradient equal those without remat bit for bit (the recompute runs the
    same ops), autograd keeps fewer tensors, and the gradients equal JAX's
    with remat on (1e-5 of the largest gradient: float32 summation order; a
    conv bias right before a norm gets only rounding noise)."""
    jcfg = jax_tiny(remat=True, **overrides)
    params = jax_params(jcfg)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    out = {}
    for remat in (False, True):
        cfg = tiny_test_config(remat=remat, **overrides)
        model = weights.from_jax_params(cfg, params, device="cpu",
                                        out_channels=3 if cfg.g_norm != "none" else None)
        out[remat] = _loss_and_grads(cfg, model, torch.from_numpy(x))
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert n1 < n0, (n1, n0)

    def jloss(p):
        return jnp.mean(jnp.square(junet.unet_apply(jcfg.replace(conv_impl="lax"), p,
                                                    jnp.asarray(x))))

    jl, jg = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-6)
    got = jax.tree_util.tree_leaves(weights.to_jax_params(model, g1))
    want = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    largest = max(np.abs(b).max() for b in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5 * largest)


def test_remat_keeps_the_gan_steps_r1_double_backward():
    """remat on in the GAN step with R1 (a double backward through D) and
    instance norms: the same losses and updated parameters as with remat
    off, bit for bit."""
    from gan_class_transfer2_tpu_torch.train import gan

    x = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    out = {}
    for remat in (False, True):
        cfg = tiny_test_config(remat=remat, r1_weight=1.0, g_norm="instance",
                               d_norm="instance", learning_rate=1e-3)
        state = gan.init_gan_state(cfg, device="cpu")
        state, metrics = gan.make_gan_train_step(cfg)(state, x, -x, torch.Generator())
        out[remat] = ({k: float(v) for k, v in metrics.items()},
                      [p.detach().clone() for p in gan.g_params(state) + gan.d_params(state)])
    assert out[True][0] == out[False][0] and out[True][0]["r1"] > 0
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_overlapping_ieee_fp32_regions_keep_tf32_off(monkeypatch):
    """Two threads' ieee_fp32 regions overlap: A opens, B opens, A closes
    while B is still inside. TF32 must stay off until the last region
    closes, then come back as it was (a saved-and-restored pair per region
    turned it back on under B). The flags are set on a CPU build too, so
    the regions run on the CPU with a CUDA device named."""
    import threading

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cuda = torch.device("cuda")
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    def region_a():
        with unet.ieee_fp32(torch.float32, cuda):
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def region_b():
        a_in.wait(10)
        with unet.ieee_fp32(torch.float32, cuda):
            b_in.set()
            a_out.wait(10)
            seen["b after a closed"] = flags()
            with unet.ieee_fp32(torch.bfloat16, cuda):  # bf16 regions leave the flags alone
                seen["bf16 inside b"] = flags()

    threads = [threading.Thread(target=f) for f in (region_a, region_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert seen == {"b after a closed": (False, False), "bf16 inside b": (False, False)}
    assert flags() == (True, True)
    with unet.ieee_fp32(torch.float32, torch.device("cpu")):
        assert flags() == (True, True)  # no card: nothing to change
