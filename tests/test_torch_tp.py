"""Port parity of tensor and multi-slice parallelism (the model and slice
axes of gan_class_transfer2_tpu_torch.parallel.mesh, parallel/tensor.py)
on the CPU: two ranks as ``mesh_model=2`` and four as data 2 × model 2
(tests/torch_grid_worker.py, spawned once for the module) against the same
scenarios in one process on the whole global batch, and against the JAX
package: its tensor-parallel rule by leaf name and its injected step on a
``data=1, model=2`` mesh. The twins of tests/test_parallel.py's TP tests.

Tolerances, each with its reason: a tensor-parallel step and the
one-process step differ in the order of float32 sums (an input gradient
summed over two ranks' halves of the output channels, a clip norm summed
over kernel slices): losses and metrics rtol 1e-5, parameters atol 1e-6
after updates of ~1e-2 (test_torch_parallel.py's bounds); the data 2 ×
model 2 run under Adam with the clip atol 1e-5 (Adam's normalised step
turns a relative gradient difference of 1e-7 into as much of the learning
rate, and there are four partial sums). Against JAX the bounds of the
one-process injected step (test_torch_trainer.py: loss rtol 2e-5, weights
atol 2e-5)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.parallel import mesh as jmesh  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import tensor  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

import grid_jax_refs  # noqa: E402
import torch_grid_worker as worker  # noqa: E402

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, world, out_dir):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_grid_worker.py"), mode, str(k), str(world),
         str(port), out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(world)]


def _collect(mode, procs, out_dir):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{mode} rank failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"{mode}-rank{k}.pt"), weights_only=False)
            for k in range(len(procs))]


def _one_process_checkpoint(path):
    """tp_checkpoint's state after its step in one process, saved."""
    cfg = tiny_test_config(batch_size=worker.GLOBAL, optimizer="adam_tf", ema_decay=0.9)
    mesh1 = mesh_lib.make_mesh(device="cpu")
    state, _ = mesh_lib.init_sharded_state(cfg, mesh1)
    state, _ = mesh_lib.make_parallel_train_step(cfg, mesh1)(
        state, torch.from_numpy(worker._np(3, (worker.GLOBAL, 16, 16, 3))),
        torch.Generator().manual_seed(1))
    ckpt_lib.save(path, ckpt_lib.host_complete(state), cfg)
    return {mesh_lib._name(p): t.clone() for p, t in mesh_lib._leaves(state)}, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two- and four-rank jobs; meanwhile compute the
    one-process references and JAX's."""
    out_dir = str(tmp_path_factory.mktemp("tp"))
    ref_dir = str(tmp_path_factory.mktemp("tp-ref"))
    jax_refs = grid_jax_refs.write_injected(os.path.join(out_dir, "injected.pt"))
    one_leaves, one_state = _one_process_checkpoint(os.path.join(out_dir, "one"))
    procs2 = _spawn("tp2", 2, out_dir)
    procs4 = _spawn("tp4", 4, out_dir)
    mesh1 = mesh_lib.make_mesh(device="cpu")
    ref = {"tp": {k: worker.run_tp(k, mesh1) for k in worker.TP_CASES},
           "gan": worker.run_tp_gan(mesh1), "cgan": worker.run_tp_cgan(mesh1),
           "injected": worker.run_injected(os.path.join(out_dir, "injected.pt"), mesh1),
           "runner": worker.runner_save(1, ref_dir),
           "gan_runner": worker.run_tp_gan_runner(1, ref_dir),
           "distill": worker.run_tp_distill(mesh1), "bench": worker.run_tp_bench(mesh1),
           "tp4": worker.run_tp4(mesh1, ref_dir), "tp4_batch": worker.run_tp4_batch(mesh1)}
    ranks = _collect("tp2", procs2, out_dir)
    got4 = _collect("tp4", procs4, out_dir)
    ranks4 = [r["tp4"] for r in got4]
    return {"ranks": ranks, "ranks4": ranks4, "batch4": [r["tp4_batch"] for r in got4],
            "ref": ref, "jax": jax_refs,
            "one": one_leaves, "one_state": one_state, "dir": out_dir}


def _close(got, want, atol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=atol, rtol=0,
                                   err_msg=f"leaf {i}")


def _same(a, b):
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- the rule


def _axes(spec) -> set:
    out = set()
    for e in spec or ():
        if e is not None:
            out.update(e if isinstance(e, tuple) else (e,))
    return out


@pytest.mark.parametrize("zero1", [False, True], ids=["tp", "tp-zero1"])
def test_leaf_and_zero1_specs_match_jax_by_leaf_name(zero1):
    """On a data 4 × model 2 mesh, the port's state_shardings split the
    same leaves over the same axes as JAX's (mesh.py:64,77), leaf by leaf
    name (the carried names of utils/weights.py): every 4-D kernel on
    ``model``; under ZeRO-1 the kernels whose last axis divides by 8 on
    both axes (model-major in the port, data-major in JAX) and the other
    moments on ``data``; a kernel that splits on ``model`` but not by 8
    stays on ``model`` in the port (module docstring: a rank updates only
    what it holds), where JAX moves it to ``data``."""
    jcfg = jconfig.tiny_test_config(optimizer="adam_tf", zero1=zero1, block_depth=1)
    jst = jax.eval_shape(lambda r: jtrainer.init_state(jcfg, r), jax.random.PRNGKey(0))
    m = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    jsh = jmesh.state_shardings(jst, m, zero1=zero1)
    jparams = {jax.tree_util.keystr(p): s.spec for p, s in
               jax.tree_util.tree_leaves_with_path(jsh.params)}
    jmu = {jax.tree_util.keystr(p): (s.spec, leaf.shape) for (p, s), leaf in zip(
        jax.tree_util.tree_leaves_with_path(jsh.opt_state[0].mu),
        jax.tree_util.tree_leaves(jst.opt_state[0].mu))}
    cfg = tiny_test_config(optimizer="adam_tf", zero1=zero1, block_depth=1)
    state = trainer.init_state(cfg, device="cpu")
    sh = mesh_lib.state_shardings(state, mesh_lib.Mesh(4, 0, "cpu", model=2), zero1)
    names = [k for k, _ in state.model.named_parameters()]
    assert len(names) == len(jparams)

    def jkey(name):  # octaves.0.down.kernel -> ['octaves'][0]['down']['kernel']
        return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))

    split = 0
    for i, name in enumerate(names):
        got = sh[f"model.{name}"]
        assert _axes(got) == _axes(jparams[jkey(name)]), name
        jspec, shape = jmu[jkey(name)]
        mu = _axes(sh[f"opt_state.0.mu.{i}"])
        if not zero1 or mu == _axes(jspec):
            assert mu == _axes(jspec), name
        else:  # the documented departure: a TP kernel not divisible by data·model
            assert mu == {"model"} and _axes(jspec) == {"data"} and shape[-1] % 8, name
        split += bool(got)
    assert split >= 8


def test_tp_functions_are_conjugate_in_one_process():
    """On a model axis of one rank the four Functions are the identity
    (the slice the whole), forward and backward."""
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    for fn in (tensor.copy_in, tensor.reduce_sum, tensor.gather_out, tensor.slice_out):
        y = fn(x)
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert torch.equal(g, torch.ones_like(x))


def test_make_mesh_lays_ranks_out_model_fastest():
    """rank r: model r % M, data (r // M) % D, slice r // (M·D)
    (mesh.py:47-51); the data coordinate slice·D + data keys the rows."""
    seen = []
    for r in range(8):
        m = mesh_lib.Mesh(2, r, "cpu", model=2, slices=2)
        seen.append((m.coords["slice"], m.coords["data"], m.coords["model"], m.data_index))
    assert seen == [(0, 0, 0, 0), (0, 0, 1, 0), (0, 1, 0, 1), (0, 1, 1, 1),
                    (1, 0, 0, 2), (1, 0, 1, 2), (1, 1, 0, 3), (1, 1, 1, 3)]
    m = mesh_lib.Mesh(2, 5, "cpu", model=2, slices=2)
    assert m.shape == {"slice": 2, "data": 2, "model": 2} and m.size == 8
    assert mesh_lib.data_axis_size(m) == 4 and mesh_lib.batch_sharding(m).spec == (
        ("slice", "data"),)
    assert torch.equal(mesh_lib.local_rows(torch.arange(8), m), torch.tensor([4, 5]))


# ------------------------------------------------------------ two ranks


@pytest.mark.parametrize("case", list(worker.TP_CASES))
def test_tp_step_matches_one_process(run, case):
    """Two steps as model 2 equal two steps in one process on the same
    batch and generator state (test_parallel.py:56): losses, weights
    gathered whole, EMA; both ranks equal bit for bit; each rank holds half
    of every kernel the rule splits."""
    got = [r["tp"][case] for r in run["ranks"]]
    ref = run["ref"]["tp"][case]
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5)
    _same(got[0]["params"], got[1]["params"])
    _close(got[0]["params"], ref["params"], atol=1e-6)
    if "ema" in ref:
        _close(got[1]["ema"], ref["ema"], atol=1e-6)
    for name, spec in got[0]["shardings"].items():
        if name in ref["bytes"]:
            want = ref["bytes"][name] // (2 if spec else 1)
            assert got[0]["bytes"][name] == got[1]["bytes"][name] == want, name
    assert sum(bool(s) for n, s in got[0]["shardings"].items() if n.startswith("model.")) >= 3


def test_tp_gan_step_with_r1_matches_one_process(run):
    """One cycle-GAN step as model 2 (R1's double backward through the
    gathers and their adjoints, instance norms on whole activations,
    DiffAugment) equals the one-process step; so does the transfer with
    the split generator (test_parallel.py:92)."""
    got = [r["gan"] for r in run["ranks"]]
    ref = run["ref"]["gan"]
    assert got[0]["metrics"] == got[1]["metrics"] and "r1" in ref["metrics"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    _same(got[0]["params"], got[1]["params"])
    _close(got[0]["params"], ref["params"], atol=1e-6)
    np.testing.assert_allclose(got[1]["transfer"].numpy(), ref["transfer"].numpy(), atol=1e-5)


def test_tp_conditional_gan_step_matches_one_process(run):
    """One conditional-GAN step as model 2 (the projection discriminator's
    split convs, R1) equals the one-process step (test_parallel.py:393)."""
    got = [r["cgan"] for r in run["ranks"]]
    ref = run["ref"]["cgan"]
    assert got[0]["metrics"] == got[1]["metrics"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    _close(got[0]["params"], ref["params"], atol=1e-6)
    np.testing.assert_allclose(got[0]["transfer"].numpy(), ref["transfer"].numpy(), atol=1e-5)


@pytest.mark.parametrize("against", ["one", "tp"])
def test_tp_injected_step_matches_jax(run, against):
    """From a JAX state carried into the port, one injected step as model 2
    equals JAX's injected step in one process and on a ``data=1, model=2``
    mesh under JAX's own TP shardings, and the port's one-process step."""
    jloss, jparams = run["jax"][against]
    want = grid_jax_refs.port_params(jparams)
    for r in run["ranks"]:
        got = r["injected"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=2e-5, atol=1e-7)
        _close(got["params"], want, atol=2e-5)
        np.testing.assert_allclose(got["loss"], run["ref"]["injected"]["loss"], rtol=1e-5)
        _close(got["params"], run["ref"]["injected"]["params"], atol=1e-6)


def test_tp_checkpoint_is_a_one_process_checkpoint(run):
    """A checkpoint of a split state holds whole leaves (gathered on
    save): restored in one process it is the ranks' state gathered, bit for
    bit; a one-process checkpoint restored onto the ranks gives each rank
    its half of every split kernel (and its moments)."""
    d = run["dir"]
    got = [r["checkpoint"] for r in run["ranks"]]
    cfg = tiny_test_config(batch_size=worker.GLOBAL, optimizer="adam_tf", ema_decay=0.9)
    one = trainer.init_state(cfg, device="cpu")
    one = ckpt_lib.restore(os.path.join(d, "tp"), one)
    _same([p.detach() for p in one.model.parameters()], got[0]["live"])
    sh = got[0]["shardings"]
    moments = {mesh_lib._name(p): t for p, t in mesh_lib._leaves(one)}
    for k, g in enumerate(got):
        for name, t in g["live_moments"].items():
            want = moments[name].chunk(2, -1)[k] if sh[name] else moments[name]
            assert torch.equal(t, want), name
        for name, t in g["restored_one"].items():
            full = run["one"][name]
            want = full.chunk(2, -1)[k] if sh.get(name) else full
            assert torch.equal(t, want), name


def test_runner_saves_and_samples_from_whole_weights(run):
    """A Runner as model 2 holds half of each split kernel; its checkpoint
    restores in one process to the EMA weights log_sample gathers, bit for
    bit, and those equal the one-process Runner's."""
    got = [r["runner"] for r in run["ranks"]]
    ref = run["ref"]["runner"]
    _same(got[0]["whole"], got[1]["whole"])
    _close(got[0]["whole"], ref["whole"], atol=1e-6)
    assert any(a != b for a, b in zip(got[0]["local_shapes"], ref["local_shapes"]))
    cfg = tiny_test_config(batch_size=worker.GLOBAL, ema_decay=0.9)
    one = ckpt_lib.restore(os.path.join(run["dir"], "runner"),
                           trainer.init_state(cfg, device="cpu"))
    _same([e for e in one.ema_params], got[0]["whole"])


def test_gan_runner_logs_the_split_generators_transfers(run):
    """A GANRunner as model 2: log_sample's transfers (the split
    generators, a collective a conv) and 2 steps equal the one-process
    runner's, on both ranks alike."""
    got = [r["gan_runner"] for r in run["ranks"]]
    ref = run["ref"]["gan_runner"]
    assert [t for t, _ in got[0]["images"]] == [t for t, _ in ref["images"]] != []
    for (_, a), (_, b), (_, c) in zip(got[0]["images"], got[1]["images"], ref["images"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, atol=1e-5)
    _same(got[0]["g_ab"], got[1]["g_ab"])
    _close(got[0]["g_ab"], ref["g_ab"], atol=1e-6)


def test_tp_distill_round_and_bench(run):
    """distill_round as model 2 (the student split, the teacher whole)
    equals one process's and returns a whole student; run_benchmark over
    the grid trains on the sharded state (distill.py:243, benchmark.py:158)."""
    ref = run["ref"]
    for r in run["ranks"]:
        d = r["distill"]
        assert d["whole"]
        np.testing.assert_allclose(d["losses"], ref["distill"]["losses"], rtol=1e-5, atol=1e-6)
        _close(d["params"], ref["distill"]["params"], atol=1e-6)
        assert r["bench"]["n_chips"] == 2 and np.isfinite(r["bench"]["final_loss"])
        np.testing.assert_allclose(r["bench"]["final_loss"], ref["bench"]["final_loss"],
                                   rtol=1e-5)


def test_cli_train_mesh_model_2(run):
    """``cli train --mesh-model 2 --num-processes 2``: both ranks print the
    same loss line, and the checkpoint restores in one process."""
    got = [r["cli_train"] for r in run["ranks"]]
    assert got[0]["rc"] == got[1]["rc"] == 0
    assert len(got[0]["loss_lines"]) == 1 and got[0]["loss_lines"] == got[1]["loss_lines"]
    ckpt = os.path.join(run["dir"], "cli-ckpt")
    assert ckpt_lib.latest_step(ckpt) == 2
    cfg = ckpt_lib.load_config(ckpt)
    assert cfg.mesh_model == 2
    one = ckpt_lib.restore(ckpt, trainer.init_state(cfg.replace(mesh_model=1), device="cpu"))
    assert all(torch.isfinite(p).all() for p in one.model.parameters())


def test_slice_mesh_equals_flat_data_parallelism(run):
    """mesh_slice=2 on two ranks (batch over ('slice', 'data'), ZeRO-1 over
    data only, whose extent is 1 here) equals flat DP on the same two
    ranks (test_parallel.py:209)."""
    for r in run["ranks"]:
        s, f = r["slice"], r["flat"]
        assert s["spec"] == (("slice", "data"),) and f["spec"] == ("data",)
        np.testing.assert_allclose(s["losses"], f["losses"], rtol=1e-6)
        _close(s["params"], f["params"], atol=1e-7)
        assert not any(s["shardings"].values())  # no leaf splits over slice
    _same(run["ranks"][0]["slice"]["params"], run["ranks"][1]["slice"]["params"])


# ----------------------------------------------------------- four ranks


def test_dp_tp_batch_norm_on_four_ranks_matches_one_process(run):
    """data 2 × model 2 with batch norms in the denoiser: each norm's
    statistics span both data groups' rows (the gathered activations are
    whole on each model rank), so two steps equal the one-process steps
    on the global batch; the ranks hold the same whole weights."""
    ranks, ref = run["batch4"], run["ref"]["tp4_batch"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        _close(r["params"], ref["params"], atol=1e-6)
    for r in ranks[1:]:
        _same(r["params"], ranks[0]["params"])


def test_dp_tp_zero1_on_four_ranks_matches_one_process(run):
    """data 2 × model 2 under ZeRO-1 with the clip: the stacked
    ('model', 'data') split holds a quarter of every dividing kernel's
    moments a rank, the run equals the one-process run, and its checkpoint
    restores in one process to the gathered weights."""
    ranks, ref = run["ranks4"], run["ref"]["tp4"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        _close(r["params"], ref["params"], atol=1e-5)
    sh = ranks[0]["shardings"]
    stacked = [n for n, s in sh.items() if s and s[-1] == ("model", "data")]
    assert stacked
    for name in stacked:
        full = ref["moment_shapes"][name]
        assert ranks[3]["moment_shapes"][name] == full[:-1] + (full[-1] // 4,), name
    assert [r["coords"]["model"] for r in ranks] == [0, 1, 0, 1]
    cfg = tiny_test_config(batch_size=worker.GLOBAL, optimizer="adam", grad_clip_norm=0.05,
                           ema_decay=0.9)
    one = ckpt_lib.restore(os.path.join(run["dir"], "tp4"), trainer.init_state(cfg, device="cpu"))
    _same([p.detach() for p in one.model.parameters()], ranks[0]["params"])
