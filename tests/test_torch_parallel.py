"""Port parity of the data-parallel layer (gan_class_transfer2_tpu_torch.parallel.mesh)
on the CPU: two ranks of a gloo group (tests/torch_dp_worker.py, spawned
once for the module) against the same scenarios in one process on the
whole global batch, and against the JAX package's injected step; the
ZeRO-1 rule, its exact field match and its checkpoints across world sizes;
the sampler's split. The twins of tests/test_parallel.py's DP and ZeRO-1
tests.

Tolerances, each with its reason: a two-rank step and the one-process
step differ only in the order of float32 sums (a mean over 2 rows then over
2 ranks against a mean over 4 rows; gradients summed in another order):
losses and metrics rtol 1e-5, parameters atol 1e-6 after updates of ~1e-2
(Adam's normalised step turns a relative gradient difference of 1e-7 into
as much of the learning rate); with bfloat16 moments a moment whose float32
value lies on a rounding boundary may round to the neighbouring bfloat16
(2^-8 of it) on one side, which moves that element's update by up to
2^-8 of the learning rate a step: atol 1e-4 there. Against JAX the bounds of the
one-process injected step (test_torch_trainer.py: loss rtol 2e-5, weights
atol 2e-5)."""

import os
import socket
import subprocess
import sys
from typing import Any, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import adam_kernel  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

import torch_dp_worker as worker  # noqa: E402

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
RANKS = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_injected(path):
    """A JAX TrainState moved off its init by one JAX injected step, carried
    into the port, with a global batch, t and ε; and JAX's injected step on
    them (the reference)."""
    jcfg = jconfig.tiny_test_config(batch_size=worker.GLOBAL, learning_rate=1e-3, warm_up=1,
                                    optimizer="adam_fused")
    r = np.random.default_rng(21)
    st = jtrainer.init_state(jcfg, jax.random.PRNGKey(1))
    step = jtrainer.make_injected_train_step(jcfg)
    x0 = r.uniform(-1, 1, (worker.GLOBAL, 16, 16, 3)).astype(np.float32)
    st, _ = step(st, jnp.asarray(x0), np.array([1, 4, 7, 9], np.int32),
                 jnp.asarray(r.normal(size=x0.shape).astype(np.float32)))
    jst = jax.tree_util.tree_map(np.asarray, st)
    x = r.uniform(-1, 1, x0.shape).astype(np.float32)
    t = np.array([2, 9, 5, 3], np.int32)
    eps = r.normal(size=x.shape).astype(np.float32)
    jnew, jloss = step(jax.tree_util.tree_map(jnp.asarray, jst), jnp.asarray(x), t,
                       jnp.asarray(eps))
    cfg = Config.from_json(jcfg.to_json())
    torch.save({"config": cfg.to_json(),
                "state": weights.from_jax_train_state(cfg, jst, device="cpu"),
                "x": torch.from_numpy(x), "t": torch.from_numpy(t), "eps": torch.from_numpy(eps)},
               path)
    return float(jloss), jax.tree_util.tree_map(np.asarray, jnew.params)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks once; meanwhile compute the one-process
    references and JAX's injected step. Returns {"ranks": [rank 0's, rank
    1's results], "ref": the one-process results, ...}."""
    out_dir = str(tmp_path_factory.mktemp("dp"))
    jax_ref = _write_injected(os.path.join(out_dir, "injected.pt"))
    one_opt = worker.write_one_process_checkpoint(out_dir)
    worker.write_distill_teacher(out_dir)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_dp_worker.py"), str(k), str(RANKS),
         str(port), out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(RANKS)]
    mesh1 = mesh_lib.make_mesh(device="cpu")
    ref = {"diffusion": {k: worker.run_diffusion(k, mesh1) for k in worker.DIFFUSION_CASES},
           "gan": {k: worker.run_gan(k, mesh1) for k in worker.GAN_CASES},
           "cgan": {k: worker.run_cgan(k, mesh1) for k in worker.CGAN_CASES},
           "sampling": worker.run_sampling(mesh1),
           "distill": {k: worker.run_distill(k, mesh1) for k in worker.DISTILL_CASES}}
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    ranks = [torch.load(os.path.join(out_dir, f"rank{k}.pt"), weights_only=False)
             for k in range(RANKS)]
    return {"ranks": ranks, "ref": ref, "jax": jax_ref, "one_opt": one_opt, "dir": out_dir}


def _close(got, want, atol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=atol, rtol=0,
                                   err_msg=f"leaf {i}")
    assert len(got) == len(want)


def _same_on_every_rank(ranks, *keys):
    vals = []
    for r in ranks:
        v = r
        for k in keys:
            v = v[k]
        vals.append(v)
    for a, b in zip(vals[0], vals[1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the rule


def test_make_mesh_follows_the_world_size():
    m = mesh_lib.make_mesh(device="cpu")
    assert (m.size, m.rank, m.shape, m.device.type) == (1, 0, {"data": 1, "model": 1}, "cpu")
    assert mesh_lib.make_mesh(tiny_test_config(mesh_data=1), device="cpu").size == 1
    with pytest.raises(ValueError, match="mesh_data must be 0 or 1"):
        mesh_lib.make_mesh(tiny_test_config(mesh_data=2), device="cpu")
    with pytest.raises(NotImplementedError, match="model and slice axes"):
        mesh_lib.make_mesh(device="cpu", model=2)
    assert mesh_lib.batch_sharding(m).spec == ("data",) and mesh_lib.replicated_sharding(m).spec == ()
    assert mesh_lib.data_axis_size(mesh_lib.Mesh(4, 1, "cpu")) == 4


def test_zero1_spec_splits_the_last_axis():
    m = mesh_lib.Mesh(2, 0, "cpu")
    z = torch.zeros
    assert mesh_lib._zero1_spec(z(3, 3, 3, 8), m) == (None, None, None, "data")
    assert mesh_lib._zero1_spec(z(8), m) == ("data",)
    assert mesh_lib._zero1_spec(z(4, 3), m) == ()  # 3 does not divide
    assert mesh_lib._zero1_spec(z(5, 2), m) == ()  # 2 < 2·data
    assert mesh_lib._zero1_spec(z(()), m) == ()
    assert mesh_lib._zero1_spec(z(3, 3, 3, 8), mesh_lib.Mesh(1, 0, "cpu")) == ()


def test_zero1_opt_state_detection_is_exact_field_match():
    """Only leaves under a registered optimizer-state field are sliced: a
    field whose name merely contains "opt" stays whole (test_parallel.py:239)."""

    class FakeState(NamedTuple):
        step: Any
        params: Any
        opt_state: Any          # registered: ZeRO-1 slices this
        adopted_params: Any     # contains 'opt': must NOT be sliced
        g_opt: Any              # registered (GAN states)

    leaf = torch.zeros((3, 3, 3, 8))
    state = FakeState(0, {"k": leaf}, {"mu": leaf}, {"k": leaf}, {"nu": leaf})
    sh = mesh_lib.state_shardings(state, mesh_lib.Mesh(4, 0, "cpu"), zero1=True)
    assert sh == {"params.k": (), "opt_state.mu": (None, None, None, "data"),
                  "adopted_params.k": (), "g_opt.nu": (None, None, None, "data")}
    assert all(v == () for v in mesh_lib.state_shardings(
        state, mesh_lib.Mesh(4, 0, "cpu"), zero1=False).values())
    assert mesh_lib._is_opt_state_path(("d_opt", 0)) and not mesh_lib._is_opt_state_path(())


def test_sharded_states_hold_half_of_each_split_leaf():
    """init_sharded_*_state on rank 1 of 2 (no collective is needed to
    slice): every split optimizer leaf is the rank's half of the full one,
    parameters and EMA whole, for the train, GAN and cGAN states, fp32 and
    bf16 moments (test_parallel.py:104,143,353,393)."""
    m = mesh_lib.Mesh(2, 1, "cpu")
    for init, kw in ((mesh_lib.init_sharded_state, dict(ema_decay=0.9)),
                     (mesh_lib.init_sharded_state, dict(moment_dtype="bfloat16")),
                     (mesh_lib.init_sharded_gan_state, dict()),
                     (mesh_lib.init_sharded_conditional_gan_state, dict(num_classes=3))):
        cfg = tiny_test_config(optimizer="adam_tf", zero1=True, **kw)
        full, _ = init(cfg.replace(zero1=False), m)
        state, sh = init(cfg, m)
        split = [n for n, s in sh.items() if s]
        assert split and all(n.split(".")[0] in mesh_lib.OPT_STATE_FIELDS for n in split)
        full_leaves = dict((mesh_lib._name(p), t) for p, t in mesh_lib._leaves(full))
        for p, t in mesh_lib._leaves(state):
            name, f = mesh_lib._name(p), full_leaves[mesh_lib._name(p)]
            if name in split:
                k = f.shape[-1] // 2
                assert t.shape == f.shape[:-1] + (k,) and t.dtype == f.dtype, name
            else:
                assert t.shape == f.shape, name
        assert mesh_lib.opt_state_bytes(state) < 0.6 * mesh_lib.opt_state_bytes(full)


def test_sharded_pools_yield_each_ranks_rows_of_the_one_process_batch(tmp_path):
    """HBMDataset and AugmentedCachedDataset under a batch sharding: each
    rank yields its rows of the global batch, augmented with the global
    batch's draws, so the ranks' rows side by side are the one-process
    batch (no collective is needed: each rank reads its own rows)."""
    from gan_class_transfer2_tpu_torch.data import cache, native_loader
    from gan_class_transfer2_tpu_torch.data.device_augment import HBMDataset

    pool = np.random.default_rng(2).integers(0, 256, (10, 20, 20, 3), dtype=np.uint8)
    one = iter(HBMDataset(pool, 16, 4, seed=3, device="cpu"))
    ranks = [iter(HBMDataset(pool, 16, 4, seed=3, sharding=mesh_lib.batch_sharding(
        mesh_lib.Mesh(2, r, "cpu")))) for r in range(2)]
    for _ in range(3):  # across an epoch boundary (10 images, batch 4)
        assert torch.equal(torch.cat([next(it) for it in ranks]), next(one))
    from gan_class_transfer2_tpu_torch.utils import png

    for i, img in enumerate(pool):
        png.write_png(tmp_path / f"{i}.png", img)
    path = str(tmp_path / "c.bin")
    if not native_loader.available():
        pytest.skip(f"the native loader did not build: {native_loader.build_error()}")
    native_loader.build_cache(str(tmp_path / "*.png"), 20, path)
    one = iter(cache.AugmentedCachedDataset(path, 16, 4, seed=1, device="cpu"))
    ranks = [iter(cache.AugmentedCachedDataset(path, 16, 4, seed=1, sharding=mesh_lib.batch_sharding(
        mesh_lib.Mesh(2, r, "cpu")))) for r in range(2)]
    for _ in range(3):
        assert torch.equal(torch.cat([next(it) for it in ranks]), next(one))


def test_warn_misaligned_batch(capsys):
    m = mesh_lib.Mesh(4, 0, "cpu")
    cfg = tiny_test_config(batch_size=48)  # 12 a chip -> the TPU pads it to 16
    mesh_lib.warn_misaligned_batch(cfg, m, backend="tpu")
    err = capsys.readouterr().err
    assert "pads it to 16" in err and "global batch of 64" in err
    mesh_lib.warn_misaligned_batch(tiny_test_config(batch_size=32), m, backend="tpu")
    mesh_lib.warn_misaligned_batch(cfg, m)  # the mesh's own device: the CPU
    mesh_lib.warn_misaligned_batch(cfg, m, backend="cuda")
    mesh_lib.warn_misaligned_batch(tiny_test_config(batch_size=50), m, backend="tpu")
    assert capsys.readouterr().err == ""


def test_fused_adam_ok_takes_the_world_size():
    cfg = tiny_test_config(optimizer="adam_fused")
    assert adam_kernel.fused_adam_ok(cfg) and adam_kernel.fused_adam_ok(cfg, 1)
    assert not adam_kernel.fused_adam_ok(cfg, 2)
    assert not adam_kernel.fused_adam_ok(cfg.replace(zero1=True), 1)


# ------------------------------------------------------- two ranks


@pytest.mark.parametrize("case", list(worker.DIFFUSION_CASES))
def test_dp_step_matches_one_process(run, case):
    """Two steps on two ranks equal two steps in one process on the global
    batch from the same generator state (test_parallel.py:33): losses,
    weights and EMA; both ranks hold the same weights bit for bit."""
    ranks, ref = run["ranks"], run["ref"]["diffusion"][case]
    got = [r["diffusion"][case] for r in ranks]
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5)
    assert len(set(ref["losses"])) == 2 and np.isfinite(ref["losses"]).all()
    _same_on_every_rank(ranks, "diffusion", case, "params")
    _close(got[0]["params"], ref["params"], atol=1e-4 if "bf16" in case else 1e-6)
    init = mesh_lib.init_sharded_state(tiny_test_config(), mesh_lib.make_mesh(device="cpu"))[0]
    moved = max((a - b).abs().max().item()
                for a, b in zip(got[0]["params"], init.model.parameters()))
    assert moved > 1e-3  # the steps did update the weights
    if "ema" in ref:
        _close(got[1]["ema"], ref["ema"], atol=1e-6)


@pytest.mark.parametrize("case", [c for c in worker.DIFFUSION_CASES if c.startswith("zero1")])
def test_zero1_shards_opt_state_and_matches_unsharded(run, case):
    """Under ZeRO-1 each rank holds half of every split moment leaf (and
    about half the bytes), and the run equals the unsharded one-process run
    (test_parallel.py:104,143)."""
    got = [r["diffusion"][case] for r in run["ranks"]]
    ref = run["ref"]["diffusion"][case]
    split = [n for n, s in got[0]["shardings"].items() if s]
    assert split
    for name in split:
        full = ref["opt_shapes"][name]
        assert got[0]["opt_shapes"][name] == full[:-1] + (full[-1] // 2,), name
    assert got[0]["opt_bytes"] < 0.6 * ref["opt_bytes"]
    assert got[0]["opt_bytes"] == got[1]["opt_bytes"]


@pytest.mark.parametrize("case", list(worker.GAN_CASES))
def test_parallel_gan_step_matches_one_process(run, case):
    """One cycle-GAN step (DiffAugment drawn for the global batch, R1's
    double backward on each rank, instance norms, EMA) on two ranks equals
    the one-process step (test_parallel.py:92,353); the transfer split over
    the ranks equals the one-process transfer."""
    got = [r["gan"][case] for r in run["ranks"]]
    ref = run["ref"]["gan"][case]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert set(got[0]["metrics"]) == set(ref["metrics"]) and "r1" in ref["metrics"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    _same_on_every_rank(run["ranks"], "gan", case, "params")
    _close(got[0]["params"], ref["params"], atol=1e-6)
    assert got[0]["transfer"].shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got[1]["transfer"].numpy(), ref["transfer"].numpy(), atol=1e-5)


@pytest.mark.parametrize("case", list(worker.CGAN_CASES))
def test_parallel_conditional_gan_step_matches_one_process(run, case):
    """One conditional-GAN step (targets drawn for the global batch) on two
    ranks equals the one-process step (test_parallel.py:393); so does the
    split transfer to per-image classes."""
    got = [r["cgan"][case] for r in run["ranks"]]
    ref = run["ref"]["cgan"][case]
    assert got[0]["metrics"] == got[1]["metrics"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    _same_on_every_rank(run["ranks"], "cgan", case, "params")
    _close(got[0]["params"], ref["params"], atol=1e-4 if "bf16" in case else 1e-6)
    np.testing.assert_allclose(got[0]["transfer"].numpy(), ref["transfer"].numpy(), atol=1e-5)


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
def test_two_rank_injected_step_matches_jax(run, zero1):
    """From a JAX state carried into the port, one injected step on two
    ranks (each on its rows of the batch, t and ε; B2 gated off by the
    world size, so the optax-form update) equals JAX's step on the global
    batch at the one-process injected step's bounds."""
    jloss, jparams = run["jax"]
    for r in run["ranks"]:
        got = r["injected"][zero1]
        np.testing.assert_allclose(got["loss"], jloss, rtol=2e-5, atol=1e-7)
        model = weights.from_jax_params(tiny_test_config(), jparams, device="cpu")
        _close(got["params"], [p.detach() for p in model.parameters()], atol=2e-5)


def test_zero1_checkpoint_moves_between_world_sizes(run):
    """A two-rank ZeRO-1 checkpoint holds the full moments (gathered on
    save): restored on the two ranks it gives each rank its slice back,
    restored in one process the full leaves, which are the ranks' slices
    side by side; a one-process checkpoint restores onto the two ranks as
    each rank's slice."""
    ranks = run["ranks"]
    got = [r["diffusion"]["zero1"] for r in ranks]
    for g in got:
        for name, t in g["live_opt"].items():
            assert torch.equal(g["restored_ranks"][name], t), name
    mesh1 = mesh_lib.make_mesh(device="cpu")
    cfg = tiny_test_config(batch_size=worker.GLOBAL, optimizer="adam_tf", zero1=True)
    one, _ = mesh_lib.init_sharded_state(cfg, mesh1)
    one = ckpt_lib.restore(os.path.join(run["dir"], "ranks"), one)
    full = {mesh_lib._name(p): t for p, t in mesh_lib._leaves(one)
            if mesh_lib._is_opt_state_path(p)}
    split = {n for n, s in got[0]["shardings"].items() if s}
    for name, t in full.items():
        if name in split:
            assert torch.equal(t, torch.cat([g["live_opt"][name] for g in got], -1)), name
        else:
            assert torch.equal(t, got[0]["live_opt"][name]), name
    for k, g in enumerate(got):
        for name, t in run["one_opt"].items():
            want = t.chunk(RANKS, -1)[k] if name in split else t
            assert torch.equal(g["restored_one"][name], want), name


def test_shard_sample_batch_pads_to_data_extent(run):
    """5 rows over 2 ranks: padded to 6, 3 rows a rank, the last one zeros;
    on one rank a no-op (test_parallel.py:320)."""
    x5 = torch.arange(10.0).reshape(5, 2)
    r0, r1 = (r["sampling"] for r in run["ranks"])
    assert r0["n"] == r1["n"] == 5
    assert torch.equal(r0["local"], x5[:3])
    assert torch.equal(r1["local"], torch.cat([x5[3:], torch.zeros(1, 2)]))
    same, n = mesh_lib.shard_sample_batch(x5, mesh_lib.make_mesh(device="cpu"))
    assert n == 5 and same is x5


def test_make_data_parallel_apply_parity(run):
    """A 3-row batch over 2 ranks, a per-row extra padded with it, a scalar
    extra left alone: the gathered result equals the plain function on
    every rank (test_parallel.py:299)."""
    want = torch.arange(12.0).reshape(3, 4) * 2.0 + torch.tensor([1.0, 2.0, 3.0])[:, None] * 0.5
    for r in run["ranks"]:
        assert torch.equal(r["sampling"]["applied"], want)
    assert torch.equal(run["ref"]["sampling"]["applied"], want)


def test_eval_fn_shards_sampler_over_data_and_matches_single_device(run):
    """The eval program's (2 + 4·B)-image sampler batch split over the ranks
    and gathered equals the one-process program (test_parallel.py:273); the
    gathered batch and the sampler benchmark over the ranks."""
    ref = run["ref"]["sampling"]
    for r in run["ranks"]:
        got = r["sampling"]
        assert set(got["eval"]) == set(ref["eval"]) and got["eval"]["fake"].shape[0] == 6
        for k, v in ref["eval"].items():
            np.testing.assert_allclose(got["eval"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
        assert torch.equal(got["fetched"], torch.from_numpy(worker._np(9, (worker.GLOBAL, 3))))
        assert got["bench_mesh"] == 2
    assert ref["bench_mesh"] == 1


@pytest.mark.parametrize("case", list(worker.DISTILL_CASES))
def test_two_rank_distill_round_matches_one_process(run, case):
    """The twin of tests/test_distill.py's mesh test: a distillation round
    over two ranks (the global batch's draws, both teacher forwards on each
    rank's rows, gradients and loss averaged) equals one process on the
    same batches and generator state, loss and weights at JAX's 1e-5; a
    uint8 stream, and labeled batches of a conditional model under ZeRO-1."""
    ref = run["ref"]["distill"][case]
    for r in run["ranks"]:
        got = r["distill"][case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5, atol=1e-5)
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5, abs=1e-5)
        for a, b in zip(got["params"], ref["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    _same_on_every_rank(run["ranks"], "distill", case, "params")


def test_cli_distill_over_two_ranks_writes_once(run):
    """``cli distill --num-processes 2``: both ranks log the same losses,
    rank 0 alone writes the student (sample_stride doubled) and the
    TensorBoard events."""
    import glob
    import json

    d = run["dir"]
    r0, r1 = (r["cli_distill"] for r in run["ranks"])
    assert r0["rc"] == r1["rc"] == 0
    assert len(r0["loss_lines"]) == 2 and r0["loss_lines"] == r1["loss_lines"]
    assert "wrote distilled student (sample_stride=2" in r0["printed"]
    assert "wrote distilled student" not in r1["printed"]
    with open(os.path.join(d, "student-r0", "config.json")) as fh:
        assert json.load(fh)["sample_stride"] == 2
    assert ckpt_lib.latest_step(os.path.join(d, "student-r0")) == 3
    assert not os.path.exists(os.path.join(d, "student-r1"))
    assert glob.glob(os.path.join(d, "dlogs-r0", "*", "*", "events.out.tfevents.*"))
    assert not os.path.exists(os.path.join(d, "dlogs-r1"))


def test_cli_refuses_flags_that_name_another_group(run):
    """A CLI call inside a running process group whose --num-processes or
    --process-id differ from the group's is refused before it runs, on
    every rank, and writes nothing."""
    d = run["dir"]
    for rank, r in enumerate(run["ranks"]):
        msgs = r["cli_distill"]["refused"]
        assert len(msgs) == 2 and all(m is not None for m in msgs), msgs
        for m in msgs:
            assert f"already runs as rank {rank} of a group of 2" in m
        assert not os.path.exists(os.path.join(d, f"refused-r{rank}"))
