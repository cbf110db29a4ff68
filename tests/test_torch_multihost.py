"""Port parity of the multi-process layer (gan_class_transfer2_tpu_torch.parallel.multihost)
and of B1s's fold on the CPU: the twins of tests/test_multihost.py (one
process) and of tests/test_multihost_real.py:101 (two ``cli train``
processes agree and the coordinator alone writes, sync and async); the
backend and device rule; JAX's int32 fold; B1s's plain version on the two
blocks of a batch; per-rank data sidecars; and a two-rank run of 2 steps,
a restore and 2 more steps against 4 unbroken steps, bit for bit.

The two-rank runs go through the user's entry point, ``python -m
gan_class_transfer2_tpu_torch.cli train --coordinator ... --num-processes 2
--process-id k``, on the CPU over gloo."""

import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.data import synthetic  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import multihost  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------- one process


def test_initialize_single_host():
    assert multihost.initialize() == 0
    assert multihost.is_coordinator()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    multihost.barrier()  # a no-op in one process


def test_host_local_batch_size():
    assert multihost.host_local_batch_size(8) == 8
    assert multihost.shard_files_for_host(["a", "b"]) == ["a", "b"]


def test_global_batch_assembly():
    """A rank keeps its local batch (and labeled dict batches) on its own
    device; in one process that is the whole batch."""
    m = mesh_lib.make_mesh(device="cpu")
    local = np.zeros((8, 4, 4, 3), np.float32)
    arr = multihost.global_batch_from_host_local(local, mesh_lib.batch_sharding(m))
    assert arr.shape == (8, 4, 4, 3) and arr.device.type == "cpu"
    d = multihost.global_batch_from_host_local(
        {"image": local, "label": np.zeros(8, np.int32)}, mesh_lib.batch_sharding(m))
    assert d["image"].shape == (8, 4, 4, 3) and d["label"].dtype == torch.int32
    fetched = multihost.host_fetch({"x": torch.ones(2, 3)}, ("data",))
    assert torch.equal(fetched["x"], torch.ones(2, 3))


def test_backend_and_device_rule(monkeypatch):
    """gloo on the CPU; nccl and a card a rank when every local rank has
    one; gloo and a shared card when ranks outnumber cards. ``initialize``
    takes the rule before it joins the group."""
    rule = multihost.backend_and_device
    assert rule("cpu", 1, 2, 0) == ("gloo", "cpu")
    assert rule("cuda", 1, 2, 2) == ("nccl", "cuda:1")
    assert rule("cuda", 1, 1, 8) == ("nccl", "cuda:1")
    assert rule("cuda", 1, 2, 1) == ("gloo", "cuda:0")
    assert rule("cuda", 3, 4, 2) == ("gloo", "cuda:1")
    with pytest.raises(RuntimeError, match="--device cpu"):
        rule("cuda", 0, 2, 0)
    with pytest.raises(ValueError, match="no process-group rule"):
        rule("mps", 0, 2, 0)

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 1)
    assert multihost.initialize("127.0.0.1:1", 2, 1, device="cuda") == 1
    assert calls == [("set_device", "cuda:0"),
                     ("gloo", dict(init_method="tcp://127.0.0.1:1", world_size=2, rank=1))]
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("127.0.0.1:1", 2, None)
    with pytest.raises(ValueError, match=r"not in \[0, 2\)"):
        multihost.initialize("127.0.0.1:1", 2, 2, device="cpu")


def test_fold_matches_jax_int32_expression():
    """B1s's fold word is JAX's ``seed ^ ((lin + 1) * jnp.int32(-1640531527))``
    (kernels.py:258-259) in wrapping int32 arithmetic, over positions 0–7;
    only the seed's low word changes."""
    lin = np.arange(8, dtype=np.int32)
    for seed32 in (0, 1, 0x1234_5678, 2**31 - 2):
        want = np.int32(seed32) ^ ((lin + np.int32(1)) * np.int32(-1640531527))
        jwant = np.asarray(jnp.int32(seed32) ^ ((jnp.asarray(lin) + jnp.int32(1))
                                                 * jnp.int32(-1640531527)))
        np.testing.assert_array_equal(want, jwant)
        got = np.array([seed32 ^ fd.fold_word(int(p)) for p in lin], np.int64)
        np.testing.assert_array_equal(got.astype(np.uint32), want.view(np.uint32))
    seed = torch.tensor([(0x2BCD_1234 << 32) | 0x0F0F_0F0F], dtype=torch.int64)
    for p in range(8):
        folded = fd.fold_seed(seed, p)
        assert int(folded) >> 32 == 0x2BCD_1234
        assert int(folded) & 0xFFFFFFFF == 0x0F0F_0F0F ^ fd.fold_word(p)
    assert len({fd.fold_word(p) for p in range(8)}) == 8


def test_b1s_plain_version_on_two_blocks():
    """A batch of 4 split into two blocks of 2: B1s at position 0 and 1 (its
    plain version on the CPU) is B1's plain version on each block with the
    folded seed; the two positions draw different ε for the same block;
    ``forward_diffuse_fused_sharded`` is the same through the (B, H, W, C)
    entry; ``fused_sharded_ok`` is JAX's gate on the local shape."""
    cfg = tiny_test_config(steps=10)
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([1, 4, 7, 10], dtype=torch.int32)
    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64)
    table = fd.scale_table(cfg.steps, cfg.schedule, "cpu")
    for pos in (0, 1):
        xb, tb = x[2 * pos:2 * pos + 2], t[2 * pos:2 * pos + 2]
        want = fd.diffuse_plain(xb.reshape(2, -1), tb, table, fd.fold_seed(seed, pos))
        got = fd.diffuse_fused_sharded(xb.reshape(2, -1).contiguous(), tb, table, seed, pos)
        assert torch.equal(got, want)
        got4 = fd.forward_diffuse_fused_sharded(cfg, xb, tb, seed, pos)
        assert torch.equal(got4.reshape(2, -1), want)
        assert torch.equal(want, fd.diffuse_sharded_plain(xb.reshape(2, -1), tb, table, seed, pos))
    noise = torch.tensor([[0.0, 1.0]])  # ss = 0, sn = 1: the output is ε
    zeros, t0 = torch.zeros((2, 768)), torch.zeros(2, dtype=torch.int32)
    eps = [fd.diffuse_fused_sharded(zeros, t0, noise, seed, p) for p in (0, 1)]
    assert not torch.equal(eps[0], eps[1])
    assert not torch.equal(eps[0], fd.diffuse_fused(zeros, t0, noise, seed))
    assert fd.diffuse_fused_sharded.launches == 0  # the plain version launches nothing
    assert fd.fused_sharded_ok(cfg, (16, 256, 256, 3), 2, ("data",))
    assert not fd.fused_sharded_ok(cfg, (16, 256, 256, 3), 3, ("data",))
    assert fd.fused_sharded_ok(cfg, (2, 16, 16, 3), {"spatial": 2}, (None, "spatial"))
    assert not fd.fused_sharded_ok(cfg, (2, 6, 4, 3), {"spatial": 2}, (None, "spatial"))
    assert fd.fused_sharded_ok(cfg, (4, 16, 16, 3), {"data": 2, "spatial": 2},
                               ("data", "spatial"))


def test_load_extra_prefers_the_rank_sidecar(tmp_path):
    """Every rank writes step_<N>.extra.host<k>.json; load_extra(host=k)
    prefers it and falls back to the coordinator's; prune sweeps a rank
    sidecar left without its step (a crashed save) once a newer step is
    committed."""
    d = str(tmp_path)
    cfg = tiny_test_config(checkpoint_keep=1)
    snap = ckpt_lib.Snapshot(3, {"w": torch.zeros(2)}, {})
    ckpt_lib.save_host_extra(d, 3, {"k": 1}, host=1)
    ckpt_lib.save(d, snap, cfg, extra={"k": 0})
    assert ckpt_lib.load_extra(d, host=1) == {"k": 1}
    assert ckpt_lib.load_extra(d, host=0) == {"k": 0} == ckpt_lib.load_extra(d)
    ckpt_lib.save_host_extra(d, 4, {"k": 9}, host=1)  # a save that never committed
    ckpt_lib.save(d, snap._replace(step=5), cfg)
    left = sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "step_*")))
    assert left == ["step_000000005"], left


# ------------------------------------------------------- two processes


def _class_files(root, n=8):
    synthetic.save_as_pngs(synthetic.circles(n, 20, seed=0), os.path.join(root, "a"))
    return os.path.join(root, "a", "*.png")


def _train_ranks(pattern, *, logs, ckpts, extra=(), world=2):
    """``cli train`` as ``world`` ranks of one job on the CPU; ``logs`` and
    ``ckpts`` give each rank's --log-dir and --checkpoint-dir. Returns each
    rank's output."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gan_class_transfer2_tpu_torch.cli", "train", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
         "--process-id", str(k), "--dataset-pattern", pattern, "--size", "16",
         "--pixel-size", "4", "--max-size", "8", "--octaves", "2", "--steps", "4",
         "--batch-size", "4", "--warm-up", "2", "--test-step", "2", "--data-workers", "1",
         "--log-images-every", "0", "--log-dir", logs[k], "--checkpoint-dir", ckpts[k],
         *extra], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    return outs


def _epoch_losses(out):
    return re.findall(r"epoch \d+: loss=([0-9.]+)", out)


@pytest.mark.parametrize("ckpt_mode", ["sync", "async"])
def test_two_process_cli_train_writes_once(tmp_path, ckpt_mode):
    """Two ``cli train`` ranks (each its own --log-dir and --checkpoint-dir,
    as test_multihost_real.py:101 gives them) print the same epoch losses;
    rank 0 alone writes the checkpoint, config.json and the event file;
    each rank writes its own data sidecar and no other, and the step is
    complete when the command returns, sync and async."""
    pattern = _class_files(str(tmp_path))
    logs = [str(tmp_path / f"logs{k}") for k in range(2)]
    ckpts = [str(tmp_path / f"ckpt{k}") for k in range(2)]
    outs = _train_ranks(pattern, logs=logs, ckpts=ckpts, extra=(
        "--steps-per-epoch", "3", "--epochs", "1", "--checkpoint-every", "3",
        "--checkpoint-async", "true" if ckpt_mode == "async" else "false"))
    assert _epoch_losses(outs[0]) == _epoch_losses(outs[1]) and len(_epoch_losses(outs[0])) == 1
    assert sorted(os.listdir(ckpts[0])) == ["config.json", "step_000000003",
                                            "step_000000003.extra.host0.json",
                                            "step_000000003.extra.json"]
    assert os.path.exists(os.path.join(ckpts[0], "step_000000003", ckpt_lib.STATE_FILE))
    assert sorted(os.listdir(ckpts[1])) == ["step_000000003.extra.host1.json"]
    assert len(glob.glob(os.path.join(logs[0], "*", "*", "events.out.tfevents.*"))) == 1
    assert not os.path.exists(logs[1])


def test_two_rank_resume_is_bit_exact(tmp_path):
    """Two ranks under ZeRO-1 on the fused diffusion path (B1s's plain
    version on the CPU), each from its HBM pool of its share of the files
    (``--data-hbm``: the index stream and the augment replay exactly, as in
    chip_smoke.py's [train-resume]): 2 steps, then a new job that restores
    them and runs 2 more, against 4 unbroken steps: the step-4 checkpoints
    are equal bit for bit (weights, full moments, the generator), and so
    are the epoch-1 losses."""
    pattern = _class_files(str(tmp_path))
    common = ("--steps-per-epoch", "2", "--checkpoint-every", "2", "--zero1", "true",
              "--fused-diffusion", "true", "--data-hbm", "20")
    logs = [str(tmp_path / f"logs{k}") for k in range(2)]
    a = _train_ranks(pattern, logs=logs, ckpts=[str(tmp_path / "A")] * 2,
                     extra=(*common, "--epochs", "2"))
    _train_ranks(pattern, logs=logs, ckpts=[str(tmp_path / "B")] * 2,
                 extra=(*common, "--epochs", "1"))
    b = _train_ranks(pattern, logs=logs, ckpts=[str(tmp_path / "B")] * 2,
                     extra=(*common, "--epochs", "2"))
    assert _epoch_losses(a[0])[1] == _epoch_losses(b[0])[0] == _epoch_losses(b[1])[0]
    sa = ckpt_lib.load_state_file(str(tmp_path / "A"), 4)
    sb = ckpt_lib.load_state_file(str(tmp_path / "B"), 4)
    assert sa["ints"] == sb["ints"] and sorted(sa["tensors"]) == sorted(sb["tensors"])
    for name, t in sa["tensors"].items():
        assert torch.equal(t, sb["tensors"][name]), name
    assert any(name.startswith("opt_state") for name in sa["tensors"])
    for k in range(2):
        assert os.path.exists(str(tmp_path / "B" / f"step_000000002.extra.host{k}.json"))
