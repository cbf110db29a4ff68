"""Port parity of spatial sharding (gan_class_transfer2_tpu_torch.parallel
.spatial, spatial_unet, spatial_train) on the CPU: a 2-way spatial mesh,
and a 4-way one with a 2 × 2 data × spatial mesh (tests/torch_grid_worker.py,
spawned once each for the module), against the unsharded ops in one
process and against the JAX package on its 8 host devices. The twins of
tests/test_spatial.py, test_spatial_unet.py and test_spatial_train.py.

Tolerances, each with its reason: the halo and the sharded down conv move
and convolve the same numbers as the unsharded conv, summed in the same
order within a row: 1e-6. The U-Net forward against ``unet_apply`` 1e-5
(cuDNN-free CPU convs on shorter images may pick other summation orders);
against JAX's ``unet_apply`` on the same carried weights 1e-4, JAX's own
spatial test's bound (test_spatial_unet.py:33). Gradients summed over the
shards against the one-process gradients 1e-6 absolute on O(1e-2) values.
The train steps: losses rtol 1e-5, weights atol 1e-6 against the port's
one-process step (a global mean summed from shards in another order);
against JAX the one-process injected step's bounds (loss rtol 2e-5,
weights atol 2e-5, test_torch_trainer.py). B3 over height blocks against
JAX's instance norm on the gathered image: B3's bounds, 1e-5 of max|y|
in float32 and 1e-2 in bfloat16, forward and VJP (gradients of the
bfloat16 input 4e-2, [gan-kernel]'s)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.models import unet as junet  # noqa: E402
from gan_class_transfer2_tpu.parallel import spatial as jspatial  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.models import unet  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import conv as conv_ops  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_diffusion  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import spatial, spatial_train, spatial_unet  # noqa: E402
from gan_class_transfer2_tpu_torch.train import trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402

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


def _one_process_options(path):
    """The port's one-process injected step for each spatial option (the
    uint8 case on the batch the crop makes)."""
    out = {}
    for tag, d in torch.load(path, weights_only=False).items():
        cfg = Config.from_json(d["config"])
        init = [p.detach().clone() for p in d["state"].model.parameters()]
        state, loss = trainer.make_injected_train_step(cfg)(d["state"], d["x"], d["t"], d["eps"])
        out[tag] = {"loss": float(loss), "init": init,
                    "params": [p.detach().clone() for p in state.model.parameters()],
                    "cfg": cfg}
    return out


def _one_process_steps(injected_path):
    """The port's one-process references of run_spatial_steps."""
    saved = torch.load(injected_path, weights_only=False)
    cfg = Config.from_json(saved["config"]).replace(optimizer="adam_tf")
    state, loss = trainer.make_injected_train_step(cfg)(saved["state"], saved["x"], saved["t"],
                                                         saved["eps"])
    out = {"injected": {"loss": float(loss),
                        "params": [p.detach().clone() for p in state.model.parameters()]}}
    cfg = tiny_test_config(**worker.SPATIAL_CFG, batch_size=worker.GLOBAL, optimizer="adam_tf",
                           learning_rate=1e-2, warm_up=1, ema_decay=0.9)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    step = trainer.make_train_step(cfg)
    batch = torch.from_numpy(worker._np(9, (worker.GLOBAL, 32, 32, 3)))
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    out["drawn"] = {"losses": losses,
                    "params": [p.detach().clone() for p in state.model.parameters()],
                    "ema": [e.clone() for e in state.ema_params]}
    return out


def _unsharded(tag):
    cfg = tiny_test_config(**worker.SPATIAL_CFG, **{
        "base": {}, "depth1": dict(block_depth=1), "concat": dict(concat_elision=False)}[tag])
    model = worker.spatial_model(cfg, 1 if tag == "depth1" else 0)
    x = torch.from_numpy(worker._np(0, (2, 32, 32, 3)))
    y = unet.unet_apply(cfg, model, x)
    grads = torch.autograd.grad((y ** 2).mean(), list(model.parameters()))
    return cfg, model, x, y.detach(), grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("spatial"))
    jax_refs = grid_jax_refs.write_injected(os.path.join(out_dir, "injected.pt"))
    jax_refs["options"] = grid_jax_refs.write_options(
        os.path.join(out_dir, "options.pt"), worker.SPATIAL_OPTIONS,
        (worker.GLOBAL, 32, 32, 3), worker.RAW_SIDE)
    procs2 = _spawn("spatial2", 2, out_dir)
    procs4 = _spawn("spatial4", 4, out_dir)
    ref = {tag: _unsharded(tag) for tag in ("base", "depth1", "concat")}
    ref["steps"] = _one_process_steps(os.path.join(out_dir, "injected.pt"))
    ref["options"] = _one_process_options(os.path.join(out_dir, "options.pt"))
    return {"two": _collect("spatial2", procs2, out_dir),
            "four": _collect("spatial4", procs4, out_dir), "ref": ref, "jax": jax_refs}


def _meshes(run):
    """(label, the ranks' results of one spatial mesh, its shard count, the
    rank's (data, spatial) coordinates)."""
    yield "2-way", [r["spatial"] for r in run["two"]], 2, [(0, k) for k in range(2)]
    yield "4-way", [r["spatial"] for r in run["four"]], 4, [(0, k) for k in range(4)]
    yield "2x2", [r["dp"] for r in run["four"]], 2, [(k // 2, k % 2) for k in range(4)]


def _assemble(ranks, coords, key):
    """The ranks' blocks of ``key`` put back together: image rows over
    ``spatial`` (dim 1), then batch rows over ``data`` (dim 0)."""
    rows = {}
    for r, (d, s) in zip(ranks, coords):
        rows.setdefault(d, {})[s] = key(r)
    return torch.cat([torch.cat([rows[d][s] for s in sorted(rows[d])], 1)
                      for d in sorted(rows)], 0)


def test_halo_exchange_contents_and_zero_rows(run):
    """Each shard receives the last rows of the one before and the first
    rows of the one after, zeros at the global edge (test_spatial.py:36);
    a zero-row halo is the block itself, no collective (:61)."""
    for label, ranks, n, coords in _meshes(run):
        x = torch.arange(2 * 4 * n * 3 * 2, dtype=torch.float32).reshape(2, 4 * n, 3, 2)
        for r, (d, s) in zip(ranks, coords):
            assert r["halo_zero_is_identity"], label
            xd = x[d:d + 1] if label == "2x2" else x
            for (lo, hi), got in r["halo"].items():
                b = xd.shape[0]
                pad = torch.cat([torch.zeros(b, lo, 3, 2), xd, torch.zeros(b, hi, 3, 2)], 1)
                want = pad[:, s * 4:s * 4 + 4 + lo + hi]
                assert torch.equal(got, want), (label, s, lo, hi)


def test_sharded_down_conv_matches_unsharded(run):
    """The height-sharded k4/s2 conv + ReLU equals the unsharded TF-SAME
    conv and JAX's sharded conv on the same inputs (test_spatial.py:19)."""
    r = np.random.default_rng(1)
    xc = r.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)
    kernel = (r.normal(size=(4, 4, 4, 8)) * 0.1).astype(np.float32)
    bias = (r.normal(size=(8,)) * 0.1).astype(np.float32)
    want = conv_ops.conv2d(torch.from_numpy(xc), torch.from_numpy(kernel),
                           torch.from_numpy(bias), stride=2, relu=True)
    jm = JMesh(np.asarray(jax.devices()[:2]), ("spatial",))
    jgot = np.asarray(jspatial.make_spatial_down_conv(jm)(jnp.asarray(xc), jnp.asarray(kernel),
                                                          jnp.asarray(bias)))
    np.testing.assert_allclose(jgot, want.numpy(), atol=1e-5)
    for label, ranks, n, coords in _meshes(run):
        got = _assemble(ranks, coords, lambda r: r["down"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, err_msg=label)


@pytest.mark.parametrize("tag", ["base", "depth1", "concat"])
def test_spatial_unet_forward_and_gradients(run, tag):
    """make_spatial_unet_apply on 2 and 4 height shards (and each data row
    of a 2 × 2 mesh): the shards side by side equal unet_apply, and JAX's
    unet_apply on the carried weights; the gradients summed over the shards
    equal the one-process ones (test_spatial_unet.py:26,36,47,92)."""
    cfg, model, x, want, grads = run["ref"][tag]
    jcfg = jconfig.tiny_test_config(**worker.SPATIAL_CFG, **{
        "base": {}, "depth1": dict(block_depth=1), "concat": dict(concat_elision=False)}[tag])
    jp = weights.to_jax_params(model)
    jy = np.asarray(junet.unet_apply(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                                     jnp.asarray(x.numpy())))
    np.testing.assert_allclose(jy, want.numpy(), atol=1e-4)
    for label, ranks, n, coords in _meshes(run):
        got = _assemble(ranks, coords, lambda r: r[tag]["y"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, err_msg=label)
        for r in ranks:
            for a, b in zip(r[tag]["grads"], grads):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=label)


OPTION_CASES = [(m, o) for o in worker.SPATIAL_OPTIONS for m in ("two", "four")]


@pytest.mark.parametrize(
    "mesh, option", [("two", None), ("four", None)] + OPTION_CASES,
    ids=["spatial", "dp-spatial"] + [f"{'spatial' if m == 'two' else 'dp-spatial'}-{o}"
                                     for m, o in OPTION_CASES])
def test_spatial_train_step_matches_one_process_and_jax(run, mesh, option):
    """One injected step on 2 height shards (and on a 2 × 2 data × spatial
    mesh) from a carried JAX state equals the port's one-process injected
    step and JAX's injected step with the height split over a spatial mesh
    (GSPMD's halos, as make_spatial_train_step runs); two generator-driven
    steps equal the one-process train_step on the same generator state,
    EMA included (test_spatial_train.py:12,37). Each ``option`` (instance
    and batch norms, the per-step head, the dct and multiscale losses,
    dynamic loss scaling, a uint8 batch, remat alone and under instance
    norms) is one injected step from a JAX state of its config against the
    one-process step and JAX's GSPMD step on the same mesh shape. A remat
    option also shows its recompute: its halo exchanges (and B3's block
    gathers) outnumber those of the same step without remat, alike on
    every rank."""
    if option is not None:
        _option_matches(run, mesh, option)
        return
    ref = run["ref"]["steps"]
    jloss, jparams = run["jax"]["spatial"]
    want = grid_jax_refs.port_params(jparams)
    for r in run[mesh]:
        got = r["steps"]
        np.testing.assert_allclose(got["injected"]["loss"], ref["injected"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["injected"]["loss"], jloss, rtol=2e-5)
        for a, b, c in zip(got["injected"]["params"], ref["injected"]["params"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)
        np.testing.assert_allclose(got["drawn"]["losses"], ref["drawn"]["losses"], rtol=1e-5)
        for a, b in zip(got["drawn"]["params"] + got["drawn"]["ema"],
                        ref["drawn"]["params"] + ref["drawn"]["ema"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        assert np.isfinite(got["fused_loss"])


def _option_matches(run, mesh, option):
    ref = run["ref"]["options"][option]
    jloss, jparams = run["jax"]["options"][option]["spatial" if mesh == "two" else "dp"]
    want = grid_jax_refs.port_params(jparams, ref["cfg"])
    init = ref["init"]
    moved = max((a - b).abs().max().item() for a, b in zip(ref["params"], init))
    assert moved > 100 * 1e-6
    for r in run[mesh]:
        got = r["options"][option]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["loss"], jloss, rtol=2e-5)
        assert len(got["params"]) == len(want) == len(ref["params"])
        for a, b, c in zip(got["params"], ref["params"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)
        if option == "dynamic":  # a finite step: the scale kept, one good step counted
            assert got["scale"] == (2.0**15, 1)
        else:
            assert got["scale"] is None
    if ref["cfg"].remat:
        # the recompute is seen: more halo exchanges (and, under instance
        # norms, more of B3's block gathers) than the same step without
        # remat, the same count on every rank
        counts = [r["options"][option]["comm"] for r in run[mesh]]
        without = [r["options"][option]["comm_without_remat"] for r in run[mesh]]
        assert all(c == counts[0] for c in counts) and all(w == without[0] for w in without)
        kinds = ["halo"] + (["norm"] if ref["cfg"].g_norm == "instance" else [])
        for kind in kinds:
            assert counts[0][kind] > without[0].get(kind, 0) > 0, (kind, counts[0], without[0])


def test_b3_over_height_blocks_matches_jax_instance_norm(run):
    """B3 over height blocks (its plain version), on 2 and 4 height shards
    and a 2 × 2 data × spatial mesh: the blocks side by side equal JAX's
    instance_norm on the whole image, and the blocks' dx and the ranks'
    summed dγ and dβ equal JAX's VJP, float32 and bfloat16."""
    from gan_class_transfer2_tpu.ops import norm as jnorm

    r = np.random.default_rng(12)
    x = (r.normal(size=(2, 16, 8, 40)) * 2 + 0.5).astype(np.float32)
    dy = r.normal(size=x.shape).astype(np.float32)
    gamma = r.normal(1.0, 0.3, 40).astype(np.float32)
    beta = r.normal(0.0, 0.3, 40).astype(np.float32)
    for name, jdt, y_tol, g_tol in (("float32", jnp.float32, 1e-5, 1e-5),
                                    ("bfloat16", jnp.bfloat16, 1e-2, 4e-2)):
        xj = jnp.asarray(x).astype(jdt)
        y, vjp = jax.vjp(lambda a, g, b: jnorm.instance_norm(a, g, b), xj, jnp.asarray(gamma),
                         jnp.asarray(beta))
        dx, dg, db = vjp(jnp.asarray(dy).astype(jdt))
        want = {"y": y, "dx": dx, "dgamma": dg, "dbeta": db}
        want = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in want.items()}
        for label, ranks, n, coords in _meshes(run):
            for key, tol in (("y", y_tol), ("dx", g_tol)):
                got = _assemble(ranks, coords, lambda q: q["b3"][name][key])
                scale = np.abs(want[key]).max()
                assert np.abs(got.numpy() - want[key]).max() <= tol * scale, (label, name, key)
            for q in ranks:
                for key in ("dgamma", "dbeta"):
                    scale = np.abs(want[key]).max()
                    err = np.abs(q["b3"][name][key].numpy() - want[key]).max()
                    assert err <= g_tol * scale, (label, name, key)


def test_uint8_pool_gives_every_spatial_rank_its_data_group_s_rows(run):
    """A raw uint8 HBMDataset under a spatial mesh: every spatial rank of a
    data group draws the same rows (whole images, which the step crops),
    and the data groups' rows together are the one-process draw."""
    from gan_class_transfer2_tpu_torch.data import device_augment

    pool = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (6, worker.RAW_SIDE, worker.RAW_SIDE, 3), dtype=np.uint8))
    one = next(iter(device_augment.HBMDataset(pool, 32, worker.GLOBAL, seed=1, raw=True,
                                              device="cpu")))
    # the two-rank job's options ran on its 2-way mesh, the four-rank job's
    # on its 2 x 2 one
    for label, ranks, coords in (("2-way", run["two"], [(0, k) for k in range(2)]),
                                 ("2x2", run["four"], [(k // 2, k % 2) for k in range(4)])):
        groups = {}
        for q, (d, _) in zip(ranks, coords):
            groups.setdefault(d, []).append(q["options"]["pool"])
        for rows in groups.values():
            assert all(torch.equal(rows[0], other) for other in rows[1:]), label
        assert torch.equal(torch.cat([groups[d][0] for d in sorted(groups)]), one), label


def test_b1s_positions_of_a_height_split():
    """B1s on height blocks: the position is the spatial index under
    P(None, 'spatial') and data·S + spatial under P('data', 'spatial')
    (kernels.py:247-259); each block is B1's plain version with the folded
    seed, and distinct positions draw distinct ε; fused_sharded_ok is taken
    on the local block."""
    cfg = tiny_test_config(fused_diffusion=True, parameterization="x")
    x = torch.from_numpy(worker._np(1, (2, 8, 16, 3)))
    t = torch.tensor([3, 7], dtype=torch.int32)
    seed = torch.tensor([1234567], dtype=torch.int64)
    table = fused_diffusion.scale_table(cfg.steps, cfg.schedule, "cpu")
    outs = []
    for pos in range(4):
        got = fused_diffusion.forward_diffuse_fused_sharded(cfg, x, t, seed, pos)
        want = fused_diffusion.diffuse_plain(x.reshape(2, -1), t, table,
                                             fused_diffusion.fold_seed(seed, pos))
        assert torch.equal(got.reshape(2, -1), want)
        outs.append(got)
    assert all(not torch.equal(outs[i], outs[j]) for i in range(4) for j in range(i))
    ok = fused_diffusion.fused_sharded_ok
    assert ok(cfg, (4, 32, 32, 3), {"data": 2, "spatial": 2}, ("data", "spatial"))
    assert not ok(cfg, (4, 30, 32, 3), {"data": 2, "spatial": 4}, (None, "spatial"))


def test_refusals_by_jax_message():
    """JAX's refusals, by message: a bottleneck the shards do not divide,
    per_step_output, g_norm (spatial_unet.py:186-205), a conditional model
    (spatial_train.py:64), an odd shard height (spatial.py:74), and the
    mesh that needs more ranks than the group (:25, :44). The train step,
    JAX's GSPMD step, takes what make_spatial_unet_apply refuses and the
    rest of the trainer's options: the dct and multiscale losses, norms,
    the per-step head, dynamic loss scaling."""

    class Mesh:
        def __init__(self, n):
            self.n = n
            self.coords = {"data": 0, "spatial": 0}

        def axis(self, name):
            from gan_class_transfer2_tpu_torch.parallel.multihost import Axis

            return Axis(None, self.n, 0)

    cfg = tiny_test_config(size=16, octaves=2)
    with pytest.raises(ValueError, match="bottleneck height 4 not shardable 8-way"):
        spatial_unet.make_spatial_unet_apply(cfg, Mesh(8))
    with pytest.raises(NotImplementedError, match="per_step_output is not supported"):
        spatial_unet.make_spatial_unet_apply(cfg.replace(per_step_output=True), Mesh(2))
    with pytest.raises(NotImplementedError, match="g_norm is not supported"):
        spatial_unet.make_spatial_unet_apply(cfg.replace(g_norm="instance"), Mesh(2))
    with pytest.raises(ValueError, match="unconditional Denoiser only"):
        spatial_train.make_spatial_train_step(cfg.replace(num_classes=2), Mesh(2))
    for taken in (dict(loss="dct"), dict(loss="mse_multiscale"), dict(g_norm="instance"),
                  dict(g_norm="batch"), dict(per_step_output=True),
                  dict(dynamic_loss_scale=True)):
        assert callable(spatial_train.make_spatial_train_step(cfg.replace(**taken), Mesh(2)))
    with pytest.raises(ValueError, match="even per-shard height, got 3"):
        spatial.sharded_down_conv(torch.zeros(1, 3, 4, 2), torch.zeros(4, 4, 2, 2),
                                  torch.zeros(2), Mesh(1).axis("spatial"))
    with pytest.raises(ValueError, match="spatial mesh needs 2 devices, have 1"):
        spatial_train.make_spatial_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices"):
        spatial_train.make_dp_spatial_mesh(2, 2, device="cpu")
    halo = spatial.halo_exchange(torch.ones(1, 2, 2, 1), Mesh(1).axis("spatial"), 1, 2)
    assert torch.equal(halo[0, :, 0, 0], torch.tensor([0.0, 1, 1, 0, 0]))
