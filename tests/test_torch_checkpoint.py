"""The port's checkpoints (utils/checkpoint.py) against the JAX package's
(gan_class_transfer2_tpu/utils/checkpoint.py): a bit-exact round trip of
every part of a train state and of a GAN state, the step-directory rules
(``.tmp`` ignored, ``all_steps``/``latest_step``/``prune`` equal to JAX's on
the same step sequence), the async saver's snapshot, and the converter
from JAX orbax checkpoints (tools/convert_orbax_checkpoint.py)."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from gan_class_transfer2_tpu.utils import checkpoint as jckpt  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
torch.set_num_threads(1)


def _trained(cfg, steps=2, seed=0):
    """A train state moved off its init by ``steps`` steps, and the
    generator that drew them."""
    state = trainer.init_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    step, gen = trainer.make_train_step(cfg), torch.Generator().manual_seed(3)
    x = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    for _ in range(steps):
        state, _ = step(state, x, gen)
    return state, gen


def _flat(state):
    out = {}
    ckpt._walk(state, "", out)
    return out


@pytest.mark.parametrize("overrides", [
    dict(optimizer="adam_fused", moment_dtype="bfloat16", ema_decay=0.9),
    dict(optimizer="adam_tf", dynamic_loss_scale=True, ema_decay=0.5),
    dict(optimizer="momentum", grad_accum=2),
], ids=["fused-bf16-moments-ema", "dynamic-scale", "multisteps"])
def test_train_state_round_trip_is_bit_exact(tmp_path, overrides):
    """Save, then restore into a fresh state from another seed: every tensor
    equals the saved one in value and dtype (bf16 moments stay bf16), the
    live tensors and lists are the same objects (restore copies in place),
    the ints (step, MultiSteps counters) come back, and the generator
    resumes the same stream."""
    cfg = tiny_test_config(learning_rate=1e-2, warm_up=1, **overrides)
    state, gen = _trained(cfg, steps=3)
    ckpt.save(str(tmp_path), state, cfg, generator=gen)
    fresh = trainer.init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    live_before = {k: v for k, v in _flat(fresh).items() if isinstance(v, torch.Tensor)}
    gen2 = torch.Generator().manual_seed(123)
    back = ckpt.restore(str(tmp_path), fresh, generator=gen2)
    want, got = _flat(state), _flat(back)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k] is live_before[k], k
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert back.step == 3
    if cfg.moment_dtype == "bfloat16":
        assert back.opt_state[0].mu[0].dtype == torch.bfloat16
        assert back.opt_state[0].mu is fresh.opt_state[0].mu
    assert torch.equal(torch.rand(4, generator=gen2), torch.rand(4, generator=gen))


def test_gan_state_round_trip_is_bit_exact(tmp_path):
    cfg = tiny_test_config(g_norm="instance", d_norm="instance", ema_decay=0.9,
                           learning_rate=1e-3)
    state = gan.init_gan_state(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    state, _ = gan.make_gan_train_step(cfg)(state, x, -x, torch.Generator())
    ckpt.save(str(tmp_path), state, cfg)
    back = ckpt.restore(str(tmp_path),
                        gan.init_gan_state(cfg, torch.Generator().manual_seed(5), device="cpu"))
    want, got = _flat(state), _flat(back)
    assert sorted(want) == sorted(got) and any(k.startswith("ema_g_ab.") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


def test_restore_refuses_another_structure(tmp_path):
    cfg = tiny_test_config(optimizer="adam")
    ckpt.save(str(tmp_path), trainer.init_state(cfg, device="cpu"), cfg)
    for other in (dict(optimizer="adam_tf"), dict(ema_decay=0.5)):
        with pytest.raises(ValueError, match="does not match the state's structure"):
            ckpt.restore(str(tmp_path), trainer.init_state(cfg.replace(**other), device="cpu"))
    wider = cfg.replace(pixel_size=8, max_size=16)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), trainer.init_state(wider, device="cpu"))


def test_step_dirs_config_and_tmp(tmp_path):
    """``step_<N>`` holds state.pt, written through ``.tmp`` (a leftover
    ``.tmp`` dir is ignored and swept); config.json carries the format
    version and reads back; a second save of a step is a no-op."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path))
    state = trainer.init_state(cfg, device="cpu")
    os.makedirs(tmp_path / "step_000000007.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    path = ckpt.save(str(tmp_path), state._replace(step=7), cfg, extra={"data": {"x": 1}})
    assert os.listdir(path) == [ckpt.STATE_FILE]
    assert not os.path.exists(str(tmp_path / "step_000000007.tmp"))
    assert ckpt.load_extra(str(tmp_path)) == {"data": {"x": 1}}
    meta = json.loads((tmp_path / "config.json").read_text())
    assert meta["checkpoint_format_version"] == ckpt.CHECKPOINT_FORMAT_VERSION
    assert ckpt.load_config(str(tmp_path)) == cfg
    mtime = os.path.getmtime(os.path.join(path, ckpt.STATE_FILE))
    assert ckpt.save(str(tmp_path), state._replace(step=7), cfg) == path
    assert os.path.getmtime(os.path.join(path, ckpt.STATE_FILE)) == mtime
    data = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    assert data["step"] == 7 and all(isinstance(v, torch.Tensor) for v in data["tensors"].values())


def test_step_bookkeeping_and_prune_equal_jax(tmp_path):
    """The same sequence of step dirs and sidecars (and crashed-write
    leftovers) in two dirs: all_steps, latest_step and prune(keep,
    protect) leave the same files in the port's dir as in JAX's."""
    dirs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        for s in (3, 10, 7, 1, 12):
            (d / f"step_{s:09d}").mkdir()
            (d / f"step_{s:09d}.extra.json").write_text("{}")
        (d / "step_000000002.extra.json.tmp").write_text("{")
        (d / "step_000000013.tmp").mkdir()
        dirs[name] = str(d)
    assert ckpt.all_steps(dirs["port"]) == jckpt.all_steps(dirs["jax"]) == [1, 3, 7, 10, 12]
    assert ckpt.latest_step(dirs["port"]) == jckpt.latest_step(dirs["jax"]) == 12
    for keep, protect, left in ((4, None, [3, 7, 10, 12]), (2, 3, [3, 10, 12]), (1, 12, [12])):
        assert ckpt.prune(dirs["port"], keep, protect) == jckpt.prune(dirs["jax"], keep, protect)
        assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
        assert ckpt.all_steps(dirs["port"]) == left
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_async_snapshot_is_not_changed_by_later_in_place_steps(tmp_path):
    """The port updates parameters and moments in place. A save submitted
    before two more steps writes the state as it was at submit."""
    cfg = tiny_test_config(optimizer="adam_fused", learning_rate=1e-2, warm_up=1,
                           checkpoint_dir=str(tmp_path))
    state, gen = _trained(cfg, steps=1)
    want = {k: v.clone() for k, v in _flat(state).items() if isinstance(v, torch.Tensor)}
    saver = ckpt.AsyncSaver()
    path = saver.submit(str(tmp_path), ckpt.host_complete(state, gen), cfg)
    step = trainer.make_train_step(cfg)
    x = torch.ones((2, 16, 16, 3)) * 0.5
    for _ in range(2):
        state, _ = step(state, x, gen)  # in place: params and the B2 moments
    saver.close()
    assert path.endswith("step_000000001")
    data = ckpt.load_state_file(str(tmp_path))
    changed = 0
    for k, v in want.items():
        assert torch.equal(data["tensors"][k], v), k
        changed += not torch.equal(_flat(state)[k], v)
    assert changed > 0  # the live tensors did move


def test_async_saver_surfaces_a_failed_save(tmp_path):
    cfg = tiny_test_config()
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    saver = ckpt.AsyncSaver()
    saver.submit(str(blocker), ckpt.host_complete(trainer.init_state(cfg, device="cpu")), cfg)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()


def test_save_best_and_read_best(tmp_path):
    cfg = tiny_test_config()
    state = trainer.init_state(cfg, device="cpu")._replace(step=5)
    path = ckpt.save_best(str(tmp_path), ckpt.host_complete(state), cfg, metric="fid",
                          value=2.5, epoch=1)
    assert path.endswith(os.path.join("best", "step_000000005"))
    assert ckpt.read_best(str(tmp_path)) == {"metric": "fid", "value": 2.5, "step": 5,
                                             "epoch": 1, "fid_extractor": cfg.fid_extractor}
    assert ckpt.all_steps(str(tmp_path / "best")) == [5]


@pytest.mark.parametrize("model", ["diffusion", "gan"])
def test_converted_jax_checkpoint_restores_in_the_port(tmp_path, model):
    """A tiny JAX run saves an orbax checkpoint; the converter writes the
    port's; the port restores it with the JAX params, optimizer state and
    EMA, and samples (diffusion) or transfers (GAN) as JAX does from them
    (1e-4 absolute, the sampler tests' bound)."""
    import convert_orbax_checkpoint
    from gan_class_transfer2_tpu.data.pipeline import ArrayDataset
    from gan_class_transfer2_tpu.sample import sampler as jsampler
    from gan_class_transfer2_tpu.train import gan as jgan
    from gan_class_transfer2_tpu_torch.sample import sampler
    from gan_class_transfer2_tpu_torch.utils import weights

    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = jax_tiny(steps=4, steps_per_epoch=2, epochs=1, ema_decay=0.9, learning_rate=1e-3,
                    log_dir=str(tmp_path / "logs"), checkpoint_dir=src, checkpoint_every=2,
                    mesh_data=1, **(dict(classes=("a", "b")) if model == "gan" else {}))
    r = np.random.default_rng(0)
    data = r.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    if model == "diffusion":
        from gan_class_transfer2_tpu.train.loop import Runner as JRunner

        jr = JRunner(jcfg, dataset=ArrayDataset(data, 2))
    else:
        from gan_class_transfer2_tpu.train.gan_loop import GANRunner as JGANRunner

        jr = JGANRunner(jcfg, dataset_a=ArrayDataset(data, 2), dataset_b=ArrayDataset(data, 2, 1))
    jr.fit(epochs=1, steps_per_epoch=2, log_samples=False)
    jstate = jax.device_get(jr.state)
    jr.close()

    path = convert_orbax_checkpoint.convert(src, dst, model)
    assert path.endswith("step_000000002")
    assert ckpt.load_extra(dst) == jckpt.load_extra(src)
    cfg = ckpt.load_config(dst)
    x = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    if model == "diffusion":
        state = ckpt.restore(dst, trainer.init_state(cfg, device="cpu"))
        assert state.step == 2
        ref = weights.to_jax_train_state(weights.from_jax_train_state(cfg, jstate, device="cpu"))
        back = weights.to_jax_train_state(state)
        for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
        got = sampler.sample(cfg, trainer.eval_model(state), torch.from_numpy(x),
                             snapshots=False).images.numpy()
        want = np.asarray(jsampler.sample(jcfg, jstate.ema_params, jnp.asarray(x),
                                          snapshots=False).images)
    else:
        state = ckpt.restore(dst, gan.init_gan_state(cfg, device="cpu"))
        back = weights.to_jax_gan_state(state)
        for name in ("g_ab", "d_b", "ema_g_ba"):
            for a, b in zip(jax.tree_util.tree_leaves(back[name]),
                            jax.tree_util.tree_leaves(getattr(jstate, name))):
                np.testing.assert_array_equal(a, np.asarray(b))
        got = gan.transfer(cfg, state, torch.from_numpy(x)).detach().numpy()
        want = np.asarray(jgan.transfer(jcfg, jstate, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
