"""Port parity of the class-conditional denoiser (models/conditional.py,
models/api.py) and the paths that thread a class through it: the
diffusion loss and train step on labeled batches, the sampler's preview,
invert, sample and edit_image with ``class_idx``, ``LabeledDataset`` and
its position through ``DeviceIterator``, the ``Runner`` with labels
(resume bit for bit, class-0 eval files), the checkpoint round trip and
``cli train --num-classes`` / ``sample --class-idx`` / ``edit
--class-idx`` — against gan_class_transfer2_tpu on the same numpy inputs
with the weights carried by utils/weights.py.

Tolerances, each with its reason:
  * the forward in float32: 1e-5 of the output's scale (IEEE float32 on
    both sides, summation order only, as test_torch_unet.py);
  * in bfloat16: 5e-2 of the output's scale, test_torch_unet.py's bound
    for bfloat16 against float32 (the two frameworks round at other
    places);
  * the loss and one step from a carried state: test_torch_trainer.py's
    golden replay bounds (loss rtol 2e-5, weights atol 2e-5);
  * the sampler: test_torch_sampler.py's 1e-4 of the array's scale.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.models import api as japi  # noqa: E402
from gan_class_transfer2_tpu.models import conditional as jcond  # noqa: E402
from gan_class_transfer2_tpu.sample import sampler as jsampler  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data import pipeline  # noqa: E402
from gan_class_transfer2_tpu_torch.models import api, conditional  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.train.loop import Runner  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import png, weights  # noqa: E402

torch.set_num_threads(1)
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4", "--batch-size", "2"]


def _cfgs(**overrides):
    """The tiny conditional config in both packages (the port's from the
    JAX JSON, so one file drives both)."""
    overrides.setdefault("num_classes", 3)
    jcfg = jax_tiny(**overrides)
    return jcfg, Config.from_json(jcfg.to_json())


def _jax_params(jcfg, seed=0):
    """JAX-initialised conditional params with random biases, as numpy."""
    params = japi.init_denoiser(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)

    def leaf(path, p):
        p = np.asarray(p)
        if getattr(path[-1], "key", None) == "bias":
            return (r.normal(size=p.shape) * 0.1).astype(np.float32)
        return p

    return jax.tree_util.tree_map_with_path(leaf, params)


def _u(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _close(port, ref, rel):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rel, atol=rel * scale)


# ----------------------------------------------------------------- model


def test_init_shapes_and_the_embedding_s_glorot_fans():
    cfg = tiny_test_config(num_classes=3, class_embed_dim=5)
    model = api.init_denoiser(cfg, device="cpu")
    assert isinstance(model, conditional.ConditionalDenoiser)
    names = [n for n, _ in model.named_parameters()]
    assert names[0] == "embed" and all(n.startswith("unet.") for n in names[1:])
    assert tuple(model.embed.shape) == (3, 5)
    assert model.unet.octaves[0].down.kernel.shape[2] == 3 + 5  # block_depth 0: the stem
    limit = (6.0 / (3 + 5)) ** 0.5
    assert 0.5 * limit < model.embed.abs().max() <= limit
    jparams = _jax_params(jax_tiny(num_classes=3, class_embed_dim=5))
    want = jax.tree_util.tree_map(np.shape, jparams)
    got = jax.tree_util.tree_map(np.shape, weights.to_jax_params(model))
    assert got == want
    # the param count equals the JAX package's
    assert conditional.param_count(model) == jcond.param_count(jparams)


@pytest.mark.parametrize("dtype, rel", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_conditional_forward_matches_jax_per_class(dtype, rel):
    """Each class, a mixed-class batch and ``class_idx=None`` (class 0)
    against JAX's apply_denoiser on the same carried weights."""
    jcfg, cfg = _cfgs(compute_dtype=dtype)
    params = _jax_params(jcfg)
    model = weights.from_jax_params(cfg, params, device="cpu")
    assert isinstance(model, conditional.ConditionalDenoiser)
    x = _u(1, (3, cfg.size, cfg.size, 3))
    t = np.array([1, 5, 9], np.int32)
    outs = {}
    for classes in ([0, 0, 0], [1, 1, 1], [2, 2, 2], [2, 0, 1], None):
        c = None if classes is None else np.asarray(classes, np.int32)
        want = np.asarray(japi.apply_denoiser(
            jcfg, params, jnp.asarray(x), jnp.asarray(t),
            class_idx=None if c is None else jnp.asarray(c)).astype(jnp.float32))
        with torch.inference_mode():
            got = api.apply_denoiser(cfg, model, torch.from_numpy(x), torch.from_numpy(t),
                                     class_idx=None if c is None else torch.from_numpy(c))
        assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        _close(got.float().numpy(), want, rel)
        outs[str(classes)] = got.float().numpy()
    np.testing.assert_array_equal(outs["None"], outs["[0, 0, 0]"])
    assert np.abs(outs["[1, 1, 1]"] - outs["[2, 2, 2]"]).max() > 1e-3  # the class matters
    # each row of the mixed batch is its class's row
    np.testing.assert_array_equal(outs["[2, 0, 1]"][1], outs["[0, 0, 0]"][1])


def test_the_embedding_reaches_only_the_first_conv_and_b4_sees_the_unconditional_shapes(
        monkeypatch):
    """At a width that reaches B4's gate (C = 128 into a 16² down conv) the
    down convs see the unconditional model's shapes: 3 + E channels only at
    the stem, which B4's gate refuses; the result matches JAX."""
    kw = dict(size=32, pixel_size=128, max_size=256, octaves=2, block_depth=1)
    jcfg, cfg = _cfgs(**kw)
    params = _jax_params(jcfg)
    model = weights.from_jax_params(cfg, params, device="cpu")
    seen = []
    real = fused_down_conv.supported
    monkeypatch.setattr(fused_down_conv, "supported",
                        lambda xs, ks: seen.append((tuple(xs), tuple(ks))) or real(xs, ks))
    x = _u(2, (1, 32, 32, 3))
    with torch.inference_mode():
        y = api.apply_denoiser(cfg, model, torch.from_numpy(x),
                               class_idx=torch.tensor([2], dtype=torch.int32))
    assert model.unet.pre_block[0].kernel.shape[2] == 3 + cfg.class_embed_dim
    assert [k[2] for _, k in seen] == [128, 128] and all(real(*s) for s in seen)
    ref = np.asarray(japi.apply_denoiser(jcfg.replace(conv_impl="lax"), params, jnp.asarray(x),
                                         class_idx=jnp.asarray([2], jnp.int32)))
    _close(y.numpy(), ref, 1e-4)


# ------------------------------------------------------------ training


def _carried_state(jcfg):
    """A JAX conditional TrainState moved off its init by one JAX step on a
    labeled batch (so the moments and EMA are not zero), as numpy."""
    st = jtrainer.init_state(jcfg, jax.random.PRNGKey(1))
    batch = {"image": jnp.asarray(_u(7, (2, 16, 16, 3))),
             "label": jnp.asarray([2, 1], jnp.int32)}
    st, _ = jtrainer.make_injected_train_step(jcfg)(st, batch, np.array([3, 6], np.int32),
                                                    jnp.asarray(_u(8, (2, 16, 16, 3))))
    return jax.tree_util.tree_map(np.asarray, st)


@pytest.mark.parametrize("overrides", [dict(optimizer="adam_tf"),
                                       dict(optimizer="adam_fused", parameterization="epsilon")],
                         ids=["adam_tf-x", "adam_fused-epsilon"])
def test_labeled_loss_and_train_step_from_a_carried_jax_state(overrides):
    """The loss on a labeled batch with injected t and ε, and one injected
    step (the fused Adam's plain version under adam_fused), from a JAX
    state carried into the port: the loss and every weight after the step
    within the golden replay's bounds; the carry itself round-trips."""
    jcfg, cfg = _cfgs(learning_rate=1e-3, warm_up=1, **overrides)
    jst = _carried_state(jcfg)
    x, eps = _u(3, (2, 16, 16, 3)), _u(4, (2, 16, 16, 3))
    t, labels = np.array([2, 9], np.int32), np.array([1, 0], np.int32)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    jnew, jloss = jtrainer.make_injected_train_step(jcfg)(
        jax.tree_util.tree_map(jnp.asarray, jst), jbatch, t, jnp.asarray(eps))

    state = weights.from_jax_train_state(cfg, jst, device="cpu")
    assert isinstance(state.model, conditional.ConditionalDenoiser)
    back = weights.to_jax_train_state(state)
    for a, b in zip(jax.tree_util.tree_leaves(back["opt_state"]),
                    jax.tree_util.tree_leaves(jst.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    with torch.no_grad():
        loss = trainer.diffusion_loss(cfg, state.model, batch, None,
                                      t_int=torch.from_numpy(t), epsilon_in=torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5, atol=1e-7)
    new, loss2 = trainer.make_injected_train_step(cfg)(state, batch, torch.from_numpy(t),
                                                       torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss2), float(jloss), rtol=2e-5, atol=1e-7)
    got = weights.to_jax_params(new.model)
    assert sorted(got) == ["embed", "unet"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jnew.params))):
        np.testing.assert_allclose(a, b, atol=2e-5)
    # the label reached the model: another label gives another loss
    with torch.no_grad():
        other = trainer.diffusion_loss(cfg, new.model, dict(batch, label=torch.tensor([2, 2])),
                                       None, t_int=torch.from_numpy(t),
                                       epsilon_in=torch.from_numpy(eps))
    assert abs(float(other) - float(loss2)) > 1e-6


def test_train_step_on_labeled_device_iterator_batches():
    """``train_step`` on the dict batches a DeviceIterator gives
    (``LabeledDataset``; int32 labels), fused diffusion's plain version on:
    a finite loss, every parameter moved, the embedding's rows of the
    classes seen included."""
    cfg = tiny_test_config(num_classes=3, fused_diffusion=True, learning_rate=1e-2, warm_up=1)
    data = [pipeline.ArrayDataset(np.full((4, 16, 16, 3), 40 * k, np.uint8), 2, seed=k)
            for k in range(3)]
    it = pipeline.DeviceIterator(pipeline.LabeledDataset(data), "cpu")
    state = trainer.init_state(cfg, device="cpu")
    before = state.model.embed.detach().clone()
    step, gen = trainer.make_train_step(cfg), torch.Generator().manual_seed(0)
    for _ in range(2):
        batch = next(it)
        assert batch["label"].dtype == torch.int32
        state, loss = step(state, batch, gen)
        assert np.isfinite(float(loss))
    moved = (state.model.embed.detach() - before).abs().amax(dim=1)
    assert moved[0] > 0 and moved[1] > 0 and moved[2] == 0  # classes 0 and 1 only


def test_conditional_train_state_checkpoint_round_trip_is_bit_exact(tmp_path):
    """A conditional TrainState (EMA, bf16 moments) through save/restore and
    through the async saver: every tensor equal, the embedding included."""
    cfg = tiny_test_config(num_classes=2, optimizer="adam_fused", moment_dtype="bfloat16",
                           ema_decay=0.9, learning_rate=1e-2, warm_up=1)
    state = trainer.init_state(cfg, device="cpu")
    batch = {"image": torch.from_numpy(_u(5, (2, 16, 16, 3))), "label": torch.tensor([1, 0])}
    state, _ = trainer.make_train_step(cfg)(state, batch, torch.Generator().manual_seed(1))
    ckpt_lib.save(str(tmp_path / "sync"), state, cfg)
    saver = ckpt_lib.AsyncSaver()
    saver.submit(str(tmp_path / "async"), ckpt_lib.host_complete(state), cfg)
    saver.close()
    want = {}
    ckpt_lib._walk(state, "", want)
    assert "model.embed" in want
    for d in ("sync", "async"):
        fresh = trainer.init_state(cfg, torch.Generator().manual_seed(7), device="cpu")
        back = ckpt_lib.restore(str(tmp_path / d), fresh)
        got = {}
        ckpt_lib._walk(back, "", got)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                    if isinstance(v, torch.Tensor) else got[k] == v), (d, k)


# ------------------------------------------------------------- sampler


@pytest.fixture(scope="module")
def carried():
    jcfg, cfg = _cfgs(sample_stride=3)
    params = _jax_params(jcfg, 3)
    return jcfg, cfg, params, weights.from_jax_params(cfg, params, device="cpu")


def test_preview_sample_and_stream_with_a_class_match_jax(carried):
    jcfg, cfg, params, model = carried
    img, noise = _u(10, (2, 16, 16, 3)), _u(11, (2, 16, 16, 3))
    c = np.array([2, 1], np.int32)
    jd, jr = jsampler.preview(jcfg, params, jnp.asarray(img), jnp.asarray(noise), jnp.asarray(c))
    d, r = sampler.preview(cfg, model, torch.from_numpy(img), torch.from_numpy(noise),
                           torch.from_numpy(c))
    _close(d.numpy(), jd, 1e-4)
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-4)
    want = jsampler.sample(jcfg, params, jnp.asarray(noise), jnp.asarray(c))
    got = sampler.sample(cfg, model, torch.from_numpy(noise), torch.from_numpy(c))
    _close(got.images.numpy(), want.images, 1e-4)
    _close(got.snapshots.numpy(), want.snapshots, 1e-4)
    frames = list(sampler.sample_stream(cfg, model, torch.from_numpy(noise), 2,
                                        class_idx=torch.from_numpy(c)))
    jframes = list(jsampler.sample_stream(jcfg, params, jnp.asarray(noise), 2,
                                          class_idx=jnp.asarray(c)))
    assert len(frames) == len(jframes) == 2
    for a, b in zip(frames, jframes):
        _close(a, b, 1e-4)
    other = sampler.sample(cfg, model, torch.from_numpy(noise), torch.tensor([0, 0]),
                           snapshots=False).images
    assert np.abs(other.numpy() - got.images.numpy()).max() > 1e-3


@pytest.mark.parametrize("param", ["x", "ode"])
def test_invert_and_edit_image_with_a_class_match_jax(param):
    """ODE inversion grows x̂ geometrically: held relative to its scale."""
    jcfg, cfg = _cfgs(parameterization=param)
    params = _jax_params(jcfg, 4)
    model = weights.from_jax_params(cfg, params, device="cpu")
    img = _u(12, (1, 16, 16, 3))
    c = np.array([1], np.int32)
    jx, je = jsampler.invert(jcfg, params, jnp.asarray(img), jnp.asarray(c))
    x, e = sampler.invert(cfg, model, torch.from_numpy(img), torch.from_numpy(c))
    _close(x.numpy(), jx, 1e-4)
    _close(e.numpy(), je, 1e-4)
    dictionary = np.random.default_rng(13).normal(
        size=(16, 16, 2**cfg.bits_per_pixel, 3)).astype(np.float32)
    want = jsampler.edit_image(jcfg, params, jnp.asarray(img), ("shift", "quantise"),
                               dictionary=jnp.asarray(dictionary), class_idx=jnp.asarray(c))
    got = sampler.edit_image(cfg, model, torch.from_numpy(img), ("shift", "quantise"),
                             dictionary=torch.from_numpy(dictionary),
                             class_idx=torch.from_numpy(c))
    assert sorted(got) == sorted(want) == ["quantise", "reconstruction", "shift"]
    for k in want:
        _close(got[k].numpy(), want[k], 1e-4)


# ------------------------------------------------------------- the data


def test_labeled_dataset_round_robin_state_and_device_iterator_position():
    """Labels cycle 0, 1, 2; ``set_state`` resumes the round robin and each
    class's stream exactly; a DeviceIterator's ``consumed_state`` is one
    batch behind its prefetch, ``k`` included."""
    data = [pipeline.ArrayDataset(np.full((3, 4, 4, 3), 50 * k, np.uint8), 2, seed=k)
            for k in range(3)]
    ds = pipeline.LabeledDataset(data)
    it = iter(ds)
    first = [next(it) for _ in range(4)]
    assert [int(b["label"][0]) for b in first] == [0, 1, 2, 0]
    assert all(b["label"].dtype == np.int32 and b["label"].shape == (2,) for b in first)
    assert all(np.all(b["image"] == 50 * k / 128.0 - 1) for b, k in zip(first, [0, 1, 2, 0]))
    saved = ds.state_dict()
    assert saved["k"] == 1 and len(saved["datasets"]) == 3
    rest = [next(it) for _ in range(3)]
    data2 = [pipeline.ArrayDataset(np.full((3, 4, 4, 3), 50 * k, np.uint8), 2, seed=k)
             for k in range(3)]
    ds2 = pipeline.LabeledDataset(data2)
    ds2.set_state(saved)
    it2 = iter(ds2)
    for want in rest:
        got = next(it2)
        np.testing.assert_array_equal(got["label"], want["label"])
        np.testing.assert_array_equal(got["image"], want["image"])

    dev = pipeline.DeviceIterator(pipeline.LabeledDataset(
        [pipeline.ArrayDataset(np.zeros((3, 4, 4, 3), np.uint8), 2) for _ in range(2)]), "cpu")
    assert dev.consumed_state() is None
    b = next(dev)
    assert torch.is_tensor(b["label"]) and b["label"].dtype == torch.int32
    assert dev.consumed_state()["k"] == 1  # the prefetched class-1 batch is not counted
    next(dev)
    assert dev.consumed_state()["k"] == 0


def _class_pngs(root, n=5, side=18):
    r = np.random.default_rng(0)
    globs = []
    for k in range(3):
        d = os.path.join(str(root), f"c{k}")
        os.makedirs(d)
        for i in range(n):
            img = (r.integers(0, 80, (side, side, 3)) + 60 * k).astype(np.uint8)
            png.write_png(os.path.join(d, f"{i}.png"), img)
        globs.append(os.path.join(d, "*.png"))
    return globs


def test_runner_with_labels_resumes_bit_for_bit_and_holds_out_class_0_only(tmp_path):
    """N steps + restore + N steps equal 2N steps bit for bit (params,
    moments, EMA; the data sidecar carries the round-robin position), on
    three class folders decoded into per-class uint8 pools (``data_hbm``:
    the pools' streams replay exactly, where threaded decode cannot); with
    fid_samples the held-out files are class 0's only, as in JAX."""
    from gan_class_transfer2_tpu.train.loop import Runner as JRunner

    globs = _class_pngs(tmp_path / "data")

    def run(name, budgets):
        cfg = tiny_test_config(num_classes=3, classes=tuple(globs), steps=4, steps_per_epoch=2,
                               epochs=2, checkpoint_every=2, ema_decay=0.9, data_hbm=18,
                               learning_rate=1e-2, warm_up=1,
                               log_dir=str(tmp_path / name / "logs"),
                               checkpoint_dir=str(tmp_path / name / "ckpt"))
        for epochs in budgets:
            runner = Runner(cfg.replace(epochs=epochs), device="cpu")
            assert isinstance(runner.dataset, pipeline.LabeledDataset)
            runner.fit(log_samples=False)
            runner.close()
        return runner

    a, b = run("a", [2]), run("b", [1, 2])
    assert a.state.step == b.state.step == 4
    fa, fb = {}, {}
    ckpt_lib._walk(a.state, "", fa)
    ckpt_lib._walk(b.state, "", fb)
    for k, v in fa.items():
        assert torch.equal(v, fb[k]) if isinstance(v, torch.Tensor) else v == fb[k], k
    assert ckpt_lib.load_extra(str(tmp_path / "b" / "ckpt"))["data"]["dataset"]["k"] == 1

    kw = dict(num_classes=3, classes=tuple(globs), fid_samples=2, checkpoint_dir=None)
    runner = Runner(tiny_test_config(log_dir=str(tmp_path / "e"), **kw), device="cpu")
    jr = JRunner(jax_tiny(mesh_data=1, log_dir=str(tmp_path / "je"), **kw))
    assert runner._eval_files == jr._eval_files
    assert len(runner._eval_files) == 2 and all("/c0/" in f for f in runner._eval_files)
    runner.close()
    jr.close()


# ------------------------------------------------------------ the CLI


def test_cli_train_classes_then_sample_and_edit_by_class(tmp_path, capsys):
    globs = _class_pngs(tmp_path / "data")
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", "--device", "cpu", *TINY, "--classes", *globs, "--num-classes",
                     "3", "--steps-per-epoch", "2", "--epochs", "1", "--fused-diffusion",
                     "false", "--checkpoint-dir", ckpt, "--checkpoint-every", "2",
                     "--log-dir", str(tmp_path / "logs"), "--log-images-every", "0",
                     "--native-loader", "false", "--data-workers", "1"]) == 0
    assert ckpt_lib.latest_step(ckpt) == 2
    images = {}
    for k in (0, 1, 2):
        out = str(tmp_path / f"s{k}")
        assert cli.main(["sample", "--device", "cpu", "--checkpoint-dir", ckpt, "--num", "2",
                         "--class-idx", str(k), "--out", out]) == 0
        images[k] = png.read_png(os.path.join(out, "sample_0.png"))
        assert images[k].shape == (16, 16, 3)
    assert cli.main(["sample", "--device", "cpu", "--checkpoint-dir", ckpt, "--num", "2",
                     "--out", str(tmp_path / "sd")]) == 0
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "sd" / "sample_0.png")), images[0])
    assert not np.array_equal(images[1], images[2])  # the same noise, another class
    png.write_png(str(tmp_path / "in.png"), np.full((16, 16, 3), 90, np.uint8))
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", ckpt, "--input",
                     str(tmp_path / "in.png"), "--class-idx", "1", "--edits", "shift",
                     "--out", str(tmp_path / "ed")]) == 0
    assert sorted(os.listdir(tmp_path / "ed")) == ["reconstruction.png", "shift.png"]
    with pytest.raises(SystemExit, match=r"must be in \[0, 3\)"):
        cli.main(["sample", "--device", "cpu", "--checkpoint-dir", ckpt, "--class-idx", "3"])
    with pytest.raises(SystemExit, match="requires a conditional checkpoint"):
        cli.main(["sample", "--device", "cpu", *TINY, "--class-idx", "0", "--checkpoint-dir",
                  str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="conditional"):
        cli.main(["export-weights", "--device", "cpu", "--checkpoint-dir", ckpt,
                  "--out", str(tmp_path / "w.npz")])
