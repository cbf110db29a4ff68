"""Port parity of the conditional GAN (train/conditional_gan.py,
train/conditional_gan_loop.py, cli cgan-train / eval --model cgan /
profile --model cgan): one step from a JAX ``ConditionalGANState`` carried
into the port, with the JAX step's own target classes computed here from
its key and injected (``jax.random`` cannot be reproduced by a
``torch.Generator``); R1 with labels; the elided zero-weight terms; the
state carry and checkpoint round trip; transfer and the runner's transfer
FID/KID; the commands end to end on the CPU.

Tolerances, each with its reason (test_torch_gan.py's and
test_torch_eval.py's):
  * losses: 1e-5 relative (IEEE float32 on both sides);
  * params and EMA after a step under ``sgd`` (linear in the gradient):
    the change within 1e-5 of the largest change of that net; under
    ``adam``, within 1e-3·lr for all but 1e-4 of the elements, conv biases
    right before a norm, and the stem's embedding channels (a norm takes
    its output), compared by their first moments (their gradient is
    rounding noise, or nearly, on both sides, which Adam scales up to
    ±lr);
  * R1 and its gradient: 1e-4 of the largest value (a double backward);
  * transfer: 1e-5 absolute; FID 1e-3 and KID 1e-5 relative.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.models import discriminator as jdisc  # noqa: E402
from gan_class_transfer2_tpu.train import conditional_gan as jcgan  # noqa: E402
from gan_class_transfer2_tpu.train import gan as jgan  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import conditional  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan  # noqa: E402
from gan_class_transfer2_tpu_torch.train.conditional_gan_loop import (  # noqa: E402
    ConditionalGANRunner,
)
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import png, tensorboard as tb, weights  # noqa: E402
from test_torch_gan import _adam_state, _close_state, _named, _perturb, _same  # noqa: E402

torch.set_num_threads(1)
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--batch-size", "2"]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfgs(**overrides):
    base = dict(num_classes=3, g_norm="instance", d_norm="instance", learning_rate=0.1,
                lr_schedule="constant", ema_decay=0.9, donate_state=False)
    base.update(overrides)
    jcfg = jconfig.tiny_test_config(**base)
    return jcfg, Config.from_json(jcfg.to_json())


def _batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    return {"image": r.uniform(-1, 1, (cfg.batch_size, cfg.size, cfg.size, 3)).astype(np.float32),
            "label": np.array([2, 0][: cfg.batch_size], np.int32)}


def _jax_state(jcfg, moved=True):
    """A JAX ConditionalGANState, numpy leaves: perturbed biases and norms,
    then (``moved``) one JAX step, so moments and the EMA are off init."""
    st = jcgan.init_conditional_gan_state(jcfg, jax.random.PRNGKey(0))
    st = st._replace(generator=_perturb(st.generator, 1),
                     discriminator=_perturb(st.discriminator, 2))
    if moved:
        b = _batch(jcfg, 9)
        st, _ = jcgan.make_conditional_gan_train_step(jcfg)(
            st, jax.tree_util.tree_map(jnp.asarray, b), jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray, st)


def _jax_targets(jcfg, step, rng, labels):
    """The targets JAX's step draws at ``step`` from ``rng``
    (conditional_gan.py:65-76)."""
    k_shift = jax.random.split(jax.random.fold_in(rng, step), 5)[0]
    shift = jax.random.randint(k_shift, labels.shape, 1, jcfg.num_classes)
    return np.asarray((jnp.asarray(labels) + shift) % jcfg.num_classes)


_STEM = "unet.octaves.0.down.kernel"


def _feeds_a_norm(cfg, name):
    """Whether leaf ``name`` is a conv bias right before a norm."""
    if re.fullmatch(r"(unet\.)?octaves\.\d+\.(down|up)\.bias", name):
        return cfg.g_norm != "none"
    if re.fullmatch(r"convs\.[1-9]\d*\.bias", name):
        return cfg.d_norm != "none"
    return False


def test_init_needs_two_classes_and_has_the_jax_trees():
    jcfg, cfg = _cfgs()
    state = cgan.init_conditional_gan_state(cfg, device="cpu")
    jst = jcgan.init_conditional_gan_state(jcfg, jax.random.PRNGKey(0))
    back = weights.to_jax_conditional_gan_state(state)
    for name in ("generator", "discriminator", "ema_generator"):
        assert (jax.tree_util.tree_map(np.shape, back[name])
                == jax.tree_util.tree_map(np.shape, getattr(jst, name))), name
    assert isinstance(state.generator, conditional.ConditionalDenoiser)
    assert tuple(state.discriminator.class_embed.shape)[0] == 3
    with pytest.raises(ValueError, match="num_classes >= 2"):
        cgan.init_conditional_gan_state(cfg.replace(num_classes=1), device="cpu")


STEP_CASES = [
    dict(optimizer="sgd"),
    dict(optimizer="adam"),
    dict(optimizer="sgd", r1_weight=1.0, gan_loss="lsgan", d_learning_rate=0.05),
    dict(optimizer="sgd", loss_anneal_steps=4, cycle_weight_final=2.0, identity_weight_final=0.0,
         reconstruction_weight=1.0),
    dict(optimizer="sgd", gan_loss="hinge", cycle_weight=0.0, identity_weight=0.0,
         patch_discriminator=False),
]


@pytest.mark.parametrize("overrides", STEP_CASES,
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_cgan_step_from_a_carried_jax_state_matches_jax(overrides):
    jcfg, cfg = _cfgs(**overrides)
    jst = _jax_state(jcfg)
    b = _batch(jcfg)
    rng = jax.random.PRNGKey(7)
    targets = _jax_targets(jcfg, int(jst.step), rng, b["label"])
    jnew, jm = jcgan.make_conditional_gan_train_step(jcfg)(
        jax.tree_util.tree_map(jnp.asarray, jst), jax.tree_util.tree_map(jnp.asarray, b), rng)
    jnew = jax.tree_util.tree_map(np.asarray, jnew)

    state = weights.from_jax_conditional_gan_state(cfg, jst, device="cpu")
    _same(weights.to_jax_conditional_gan_state(state), jst._asdict())  # the carry round-trips
    new, m = cgan.make_conditional_gan_train_step(cfg)(
        state, {"image": T(b["image"]), "label": torch.tensor(b["label"])},
        torch.Generator().manual_seed(0), targets=torch.tensor(targets))
    back = weights.to_jax_conditional_gan_state(new)
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert new.step == int(jnew.step) == 2
    lr = cfg.learning_rate
    for name in ("generator", "discriminator", "ema_generator"):
        before = _named(getattr(jst, name))
        got = {k: v - before[k] for k, v in _named(back[name]).items()}
        want = {k: v - before[k] for k, v in _named(getattr(jnew, name)).items()}
        largest = max(np.abs(w).max() for w in want.values())
        assert sorted(got) == sorted(want) and largest > 0, name
        for k in want:
            diff = np.abs(got[k] - want[k])
            if cfg.optimizer == "sgd":
                assert diff.max() <= 1e-5 * largest, (name, k, diff.max(), largest)
            elif not _feeds_a_norm(cfg, k):
                if k.endswith(_STEM) and cfg.g_norm != "none" and cfg.block_depth == 0:
                    # the embedding's channels of the stem, whose output a
                    # norm takes: a channel constant over H×W is removed by
                    # the norm's mean but for the SAME border, so their
                    # gradient is small and Adam scales its rounding up;
                    # their moments are held below with the rest
                    diff = diff[:, :, :3]
                assert (diff > 1e-3 * lr).mean() <= 1e-4, (name, k, diff.max(), lr)
    if cfg.optimizer == "adam":
        for mu in (jnew.g_opt, back["g_opt"], jnew.d_opt, back["d_opt"]):
            moments = _named(_adam_state(mu).mu)
            top = max(np.abs(v).max() for v in moments.values())
            noise = [k for k in moments if _feeds_a_norm(cfg, k)]
            assert noise and all(np.abs(moments[k]).max() <= 1e-6 * top for k in noise)
    for name in ("g_opt", "d_opt"):
        _close_state(back[name], getattr(jnew, name), name)


def test_drawn_targets_differ_from_the_source_and_zero_weight_terms_are_elided(monkeypatch):
    """The step's own draw gives a target other than each source; with the
    cycle and identity weights 0 the generator runs once a step (twice
    with cycle only, three times with both) and the elided terms report 0,
    as in JAX."""
    _, cfg = _cfgs(optimizer="sgd", batch_size=8)
    calls = []
    real = conditional.conditional_unet_apply
    monkeypatch.setattr(conditional, "conditional_unet_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    labels = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    seen = []
    real_targets = cgan._target_classes
    monkeypatch.setattr(cgan, "_target_classes",
                        lambda *a: seen.append(real_targets(*a)) or seen[-1])
    for (cw, iw), n in (((0.0, 0.0), 1), ((10.0, 0.0), 2), ((10.0, 0.5), 3)):
        c = cfg.replace(cycle_weight=cw, identity_weight=iw)
        state = cgan.init_conditional_gan_state(c, device="cpu")
        calls.clear()
        x = T(np.random.default_rng(0).uniform(-1, 1, (8, 16, 16, 3)))
        _, m = cgan.make_conditional_gan_train_step(c)(state, {"image": x, "label": labels},
                                                      torch.Generator().manual_seed(1))
        assert len(calls) == n, (cw, iw, len(calls))
        assert (float(m["cycle"]) == 0.0) == (cw == 0.0)
        assert (float(m["identity"]) == 0.0) == (iw == 0.0)
    assert all(bool((t != labels).all()) and int(t.min()) >= 0 and int(t.max()) < 3
               for t in seen)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(size=32, d_pixel_size=128, max_size=256, d_octaves=2),
], ids=["tiny", "b4-reaching"])
def test_r1_with_labels_and_its_gradient_match_jax(overrides):
    """R1 through the projection-conditioned discriminator with the class
    held fixed, and its gradient with respect to D (the class embedding
    included): a double backward through the norm and the projection."""
    jcfg, cfg = _cfgs(**overrides)
    params = _perturb(jdisc.init_discriminator(jax.random.PRNGKey(0), jcfg, num_classes=3), 5)
    real = np.random.default_rng(2).uniform(-1, 1, (2, cfg.size, cfg.size, 3)).astype(np.float32)
    labels = np.array([1, 2], np.int32)
    jc = jcfg.replace(conv_impl="lax")
    want, want_g = jax.value_and_grad(lambda p: jgan.r1_penalty(
        jc, p, jnp.asarray(real), jnp.asarray(labels)))(params)
    model = weights.from_jax_discriminator_params(cfg, params, device="cpu")
    pen = gan.r1_penalty(cfg, model, T(real), torch.from_numpy(labels))
    grads = torch.autograd.grad(pen, list(model.parameters()), materialize_grads=True)
    np.testing.assert_allclose(float(pen.detach()), float(want), rtol=1e-4)
    flat = _named(want_g)
    top = max(np.abs(w).max() for w in flat.values())
    assert np.abs(flat["class_embed"]).max() > 0
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), flat[name], atol=1e-4 * top, err_msg=name)


def test_cgan_state_checkpoint_round_trip_is_bit_exact(tmp_path):
    """Save / restore and the async saver: every tensor equal (G, D, both
    optimizer states, G's EMA); the runner's torch.Generator is kept apart
    from the state's module named ``generator``."""
    _, cfg = _cfgs(optimizer="adam", learning_rate=1e-3)
    state = cgan.init_conditional_gan_state(cfg, device="cpu")
    b = _batch(cfg, 1)
    gen = torch.Generator().manual_seed(3)
    state, _ = cgan.make_conditional_gan_train_step(cfg)(
        state, {"image": T(b["image"]), "label": torch.tensor(b["label"])}, gen)
    ckpt_lib.save(str(tmp_path / "sync"), state, cfg, generator=gen)
    saver = ckpt_lib.AsyncSaver()
    saver.submit(str(tmp_path / "async"), ckpt_lib.host_complete(state, gen), cfg)
    saver.close()
    want = {}
    ckpt_lib._walk(state, "", want)
    assert any(k.startswith("generator.unet.") for k in want) and "ema_generator.embed" in want
    for d in ("sync", "async"):
        gen2 = torch.Generator().manual_seed(99)
        back = ckpt_lib.restore(str(tmp_path / d), cgan.init_conditional_gan_state(
            cfg, torch.Generator().manual_seed(4), device="cpu"), generator=gen2)
        got = {}
        ckpt_lib._walk(back, "", got)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, (d, k)
        assert torch.equal(gen2.get_state(), gen.get_state())


def test_transfer_matches_jax():
    jcfg, cfg = _cfgs()
    jst = _jax_state(jcfg, moved=False)
    state = weights.from_jax_conditional_gan_state(cfg, jst, device="cpu")
    x = np.random.default_rng(4).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    for target in (0, 2, np.array([1, 2, 0], np.int32)):
        want = np.asarray(jcgan.transfer(jcfg, jax.tree_util.tree_map(jnp.asarray, jst),
                                         jnp.asarray(x), target))
        with torch.inference_mode():
            got = cgan.transfer(cfg, state, T(x), torch.as_tensor(target)).numpy()
            fn = cgan.make_transfer_fn(cfg)(cgan.select_generator(state), T(x),
                                            torch.as_tensor(target).expand(3))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(fn.numpy(), got)
    # on a mesh of one rank the transfer is the same function
    # (tests/test_torch_parallel.py splits it over two ranks)
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib

    one = cgan.make_transfer_fn(cfg, mesh=mesh_lib.make_mesh(device="cpu"))
    with torch.inference_mode():
        tv = torch.tensor([1, 2, 0])
        assert torch.equal(one(cgan.select_generator(state), T(x), tv),
                           cgan.make_transfer_fn(cfg)(cgan.select_generator(state), T(x), tv))


def _class_dirs(root, n=6):
    r = np.random.default_rng(0)
    globs = []
    for k in range(3):
        d = os.path.join(str(root), f"c{k}")
        os.makedirs(d)
        for i in range(n):
            img = (r.integers(0, 100, (18, 18, 3)) + 70 * k).astype(np.uint8)
            png.write_png(os.path.join(d, f"{i}.png"), img)
        globs.append(os.path.join(d, "*.png"))
    return tuple(globs)


def test_runner_transfer_scores_match_jax(tmp_path):
    from gan_class_transfer2_tpu.train.conditional_gan_loop import (
        ConditionalGANRunner as JRunner,
    )

    classes = _class_dirs(tmp_path / "data")
    kw = dict(classes=classes, fid_samples=3, g_norm="instance", d_norm="instance",
              checkpoint_dir=None, native_loader=False, data_workers=1)
    jr = JRunner(jconfig.tiny_test_config(mesh_data=1, log_dir=str(tmp_path / "jl"), **kw))
    runner = ConditionalGANRunner(tiny_test_config(log_dir=str(tmp_path / "l"), **kw),
                                  device="cpu")
    assert runner.cfg.num_classes == jr.cfg.num_classes == 3
    runner.state = weights.from_jax_conditional_gan_state(runner.cfg, jax.device_get(jr.state),
                                                          device="cpu")
    for src, tgt in ((0, 1), (2, 0), (1, 2)):
        np.testing.assert_array_equal(runner._class_eval_sets()[src], jr._eval_sets[src])
        want = jr.transfer_scores(src, tgt)
        got = runner.transfer_scores(src, tgt)
        assert got["fid"] == pytest.approx(want["fid"], rel=1e-3)
        assert got["kid"] == pytest.approx(want["kid"], rel=1e-5)
        assert runner.transfer_fid(src, tgt) == got["fid"]
    assert sorted(runner._eval_feat_cache) == [0, 1, 2]  # one extraction per target class
    jr.close()
    runner.close()


def test_runner_checks_the_class_count_and_logs_every_target(tmp_path):
    from gan_class_transfer2_tpu_torch.data.pipeline import ArrayDataset

    cfg = tiny_test_config(g_norm="instance", d_norm="instance", steps_per_epoch=3, epochs=1,
                           log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ck"),
                           checkpoint_every=3)
    data = [ArrayDataset(np.full((4, 16, 16, 3), 60 * k, np.uint8), 2, seed=k)
            for k in range(3)]
    with pytest.raises(ValueError, match="num_classes=2 but 3"):
        ConditionalGANRunner(cfg.replace(num_classes=2), datasets=data, device="cpu")
    with pytest.raises(ValueError, match=">= 2 classes"):
        ConditionalGANRunner(cfg, datasets=data[:1], device="cpu")
    runner = ConditionalGANRunner(cfg, datasets=data, device="cpu")
    assert runner.cfg.num_classes == 3
    runner.fit()
    runner.close()
    tags = {e[1] for e in tb.read_events(runner.writer.path)}
    assert {f"transfer_to_{k}/image/0" for k in range(3)} <= tags
    assert {"g_loss", "d_loss", "cycle", "images_per_sec"} <= tags
    assert ckpt_lib.all_steps(str(tmp_path / "ck")) == [3]
    # the sidecar carries the round-robin position (log_sample's fixed
    # batch and three steps: four batches drawn); a new runner resumes there
    assert ckpt_lib.load_extra(str(tmp_path / "ck"))["data"]["labeled"]["k"] == 1
    again = ConditionalGANRunner(cfg, datasets=data, device="cpu")
    assert again.state.step == 3 and again.labeled._k == 1
    again.close()


def test_cli_cgan_train_eval_and_profile(tmp_path, capsys):
    import json

    classes = _class_dirs(tmp_path / "data", n=5)
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["cgan-train", "--device", "cpu", *TINY, "--classes", *classes,
                     "--steps-per-epoch", "2", "--epochs", "1", "--g-norm", "instance",
                     "--d-norm", "instance", "--fid-samples", "2", "--log-dir",
                     str(tmp_path / "logs"), "--checkpoint-dir", ckpt, "--checkpoint-every",
                     "2", "--native-loader", "false", "--data-workers", "1",
                     "--resilient", "1"]) == 0
    assert "epoch 0: g=" in capsys.readouterr().out
    assert ckpt_lib.all_steps(ckpt) == [2] and ckpt_lib.load_config(ckpt).num_classes == 3
    assert cli.main(["eval", "--device", "cpu", "--model", "cgan", "--checkpoint-dir",
                     ckpt]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pairs = [(s, t) for s in range(3) for t in range(3) if s != t]
    assert out["model"] == "cgan" and out["step"] == 2
    for s, t in pairs:
        assert np.isfinite(out[f"transfer_fid_{s}_to_{t}"])
        assert np.isfinite(out[f"transfer_kid_{s}_to_{t}"])
    assert cli.main(["profile", "--device", "cpu", "--model", "cgan", *TINY, "--num-classes",
                     "3", "--g-norm", "instance", "--d-norm", "instance", "--profile-steps",
                     "1", "--trace-dir", str(tmp_path / "trace")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["model"] == "cgan" and last["device_rows"] == 0
    assert set(last["final"]) == {"g_loss", "d_loss", "adversarial", "cycle", "identity"}
