"""Serving over in-process replicas (gan_class_transfer2_tpu_torch.serve.server.ModelService
with ``mesh=``, parallel/mesh.LocalMesh) on the CPU: the twins of
tests/test_serve.py's mesh tests (the service over a local mesh of 2 or 4
replicas, all on the CPU, against the service without one), the local
mesh's split and gather, ``build_service`` on a host of several devices
(the count stubbed), /reload swapping every replica, and a bundle served
without a mesh.

Tolerances, JAX's: sampled uint8 images within ±1 level (a float32 value on
a uint8 bucket edge rounds apart when a replica's block runs at another
batch size); one-forward endpoints (transfer, transfer_to, denoise) 2e-4."""

import io
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.serve import server as srv_mod  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.server import ModelService, Server  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)


def _mesh(n):
    return mesh_lib.make_mesh(devices=["cpu"] * n)


def _image(cfg, n=1, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, cfg.size, cfg.size, 3)).astype(
        np.float32)


def _levels(a, b):
    np.testing.assert_allclose(a.astype(np.int16), b.astype(np.int16), atol=1, rtol=0)


def test_local_mesh_splits_pads_and_gathers():
    """Rows split over the replicas, zero-padded to the extent, each block
    on its replica's device; the gather cuts back to the real rows;
    replicas are copies with equal weights, the first the module itself."""
    mesh = _mesh(2)
    assert mesh.size == 2 and mesh_lib.data_axis_size(mesh) == 2 and mesh.device.type == "cpu"
    blocks, n = mesh_lib.shard_sample_batch(torch.arange(10.0).reshape(5, 2), mesh)
    assert n == 5 and [tuple(b.shape) for b in blocks] == [(3, 2), (3, 2)]
    assert blocks[1][-1].tolist() == [0.0, 0.0]  # the pad row
    torch.testing.assert_close(mesh_lib.gather_rows(blocks, mesh, n),
                               torch.arange(10.0).reshape(5, 2))
    par = mesh_lib.make_data_parallel_apply(mesh, lambda p, x, t, s: (x * p + t[:, None] * s,
                                                                      x.sum(1)))
    got, sums = par([2.0, 2.0], torch.arange(12.0).reshape(3, 4), torch.tensor([1.0, 2, 3]), 0.5)
    torch.testing.assert_close(got, torch.arange(12.0).reshape(3, 4) * 2
                               + torch.tensor([0.5, 1.0, 1.5])[:, None])
    torch.testing.assert_close(sums, torch.arange(12.0).reshape(3, 4).sum(1))
    model = trainer.init_state(tiny_test_config(), torch.Generator().manual_seed(0),
                               device="cpu").model
    reps = mesh_lib.replicate(model, mesh)
    assert reps[0] is model and reps[1] is not model
    torch.testing.assert_close(reps[1].state_dict(), model.state_dict())
    assert mesh_lib.replicate(model, None) is model
    with pytest.raises(ValueError, match="data must be 0 or 2"):
        mesh_lib.make_mesh(devices=["cpu", "cpu"], data=3)


def test_replicas_run_in_turn_and_small_batches_on_one():
    """Each replica applies ``fn`` to its block in turn, from the caller's
    thread and under its grad mode; a batch of fewer rows than replicas
    runs whole and unpadded on the first replica."""
    import threading

    mesh = _mesh(4)
    seen = []

    def fn(p, x):
        seen.append((p, threading.current_thread(), tuple(x.shape),
                     torch.is_inference_mode_enabled()))
        return x * 2

    par = mesh_lib.make_data_parallel_apply(mesh, fn)
    with torch.inference_mode():
        out = par(["r0", "r1", "r2", "r3"], torch.arange(6.0).reshape(6, 1))
    torch.testing.assert_close(out, torch.arange(6.0).reshape(6, 1) * 2)
    me = threading.current_thread()
    assert seen == [(f"r{i}", me, (2, 1), True) for i in range(4)]  # 6 rows padded to 8

    seen.clear()
    torch.testing.assert_close(par(["r0", "r1", "r2", "r3"], torch.ones(3, 1)),
                               torch.full((3, 1), 2.0))
    assert seen == [("r0", me, (3, 1), False)]


@pytest.mark.parametrize("replicas", [2, 4])
def test_service_samples_over_mesh_match_single_device(replicas):
    """num 3 and 5 (buckets 4 and 8, multiples of the extent): the same
    noise as the service without a mesh, so the same samples within a
    level; num 1 (a bucket below the extent, not padded to it) runs on the
    first replica, the plain service's own module, so its bytes are the
    plain service's; a stream over the mesh ends on the sampled batch."""
    cfg = tiny_test_config()
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    plain = ModelService(cfg, state=state, device="cpu")
    meshed = ModelService(cfg, state=state, mesh=_mesh(replicas), device="cpu")
    try:
        assert meshed.mesh.size == replicas and len(meshed._replicas) == replicas
        assert [meshed._pad_bucket(n) for n in (1, 2, 3, 5)] == [1, 2, 4, 8]
        np.testing.assert_array_equal(meshed.sample(1), plain.sample(1))
        for num in (3, 5):
            a, b = plain.sample(num), meshed.sample(num)
            assert a.shape == b.shape == (num, cfg.size, cfg.size, 3)
            assert a.dtype == b.dtype == np.uint8
            _levels(a, b)
        chunks = list(meshed.sample_stream(2, segments=2))
        assert len(chunks) == 2 and chunks[-1].shape == (2, cfg.size, cfg.size, 3)
        if replicas == 2:  # bucket 2 either way: the same noise
            want = list(plain.sample_stream(2, segments=2))
            for got, ref in zip(chunks, want):
                np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    finally:
        plain.close()
        meshed.close()


def test_conditional_stream_over_mesh_splits_the_class_vector():
    cfg = tiny_test_config(num_classes=3)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    plain = ModelService(cfg, state=state, device="cpu")
    meshed = ModelService(cfg, state=state, mesh=_mesh(2), device="cpu")
    try:
        want = list(plain.sample_stream(2, segments=2, class_idx=2))
        got = list(meshed.sample_stream(2, segments=2, class_idx=2))
        np.testing.assert_allclose(got[-1], want[-1], rtol=0, atol=2e-4)
        _levels(plain.sample(3, class_idx=1), meshed.sample(3, class_idx=1))
    finally:
        plain.close()
        meshed.close()


def test_service_transfer_and_denoise_over_mesh_match_single_device():
    """The one-forward endpoints (GAN and cGAN transfer, the denoise
    preview) over a 4-replica mesh against the service without one: one
    image (on the first replica) and five (bucket 8, two rows a
    replica)."""
    cfg = tiny_test_config()
    ccfg = cfg.replace(num_classes=3)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    gs = gan.init_gan_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    cs = cgan.init_conditional_gan_state(ccfg, torch.Generator().manual_seed(2), device="cpu")
    mesh = _mesh(4)
    plain = ModelService(cfg, state=state, gan_state=gs, device="cpu")
    meshed = ModelService(cfg, state=state, gan_state=gs, mesh=mesh, device="cpu")
    cplain = ModelService(ccfg, cgan_state=cs, device="cpu")
    cmeshed = ModelService(ccfg, cgan_state=cs, mesh=mesh, device="cpu")
    try:
        for n in (1, 5):
            img = _image(cfg, n)
            for d in ("ab", "ba"):
                np.testing.assert_allclose(meshed._run_transfer(img, d),
                                           plain._run_transfer(img, d), rtol=2e-4, atol=2e-4)
            tgt = np.arange(n, dtype=np.int32) % 3
            np.testing.assert_allclose(cmeshed._run_cgan_transfer(img, tgt),
                                       cplain._run_cgan_transfer(img, tgt), rtol=2e-4, atol=2e-4)
            den = meshed._run_denoise(img)
            assert den.shape == img.shape and np.isfinite(den).all()
            np.testing.assert_allclose(den, plain._run_denoise(img), rtol=2e-4, atol=2e-4)
        img = _image(cfg)
        for d in ("ab", "ba"):  # through the batchers
            np.testing.assert_allclose(meshed.transfer(img, d), plain.transfer(img, d),
                                       rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(cmeshed.transfer_to(img, 2), cplain.transfer_to(img, 2),
                                   rtol=2e-4, atol=2e-4)
    finally:
        for s in (plain, meshed, cplain, cmeshed):
            s.close()


def test_build_service_uses_a_mesh_on_a_multi_device_host(tmp_path, monkeypatch):
    """With more than one local device (the count stubbed to 2 CPUs), the
    serve command's service restores the checkpoint, replicates it and
    answers /sample over HTTP; an oversized train-time mesh_data is
    ignored."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path), mesh_data=16)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt_lib.save(str(tmp_path), state._replace(step=7), cfg)
    monkeypatch.setattr(mesh_lib, "local_devices", lambda device: [torch.device("cpu")] * 2)
    svc = srv_mod.build_service(cfg, device="cpu")
    srv = Server(svc).start()
    try:
        assert svc.step == 7 and svc.mesh is not None and svc.mesh.size == 2
        for rep in svc._replicas:
            torch.testing.assert_close(rep.state_dict(), state.model.state_dict())
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/sample",
                                     data=json.dumps({"num": 3, "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.load(io.BytesIO(r.read()))
        assert out.shape == (3, cfg.size, cfg.size, 3) and out.dtype == np.uint8
    finally:
        srv.stop()
    monkeypatch.undo()
    one = srv_mod.build_service(cfg, device="cpu")  # one CPU: no mesh, mesh_data ignored
    try:
        assert one.mesh is None and one.sample(2).shape == (2, cfg.size, cfg.size, 3)
    finally:
        one.close()


def test_reload_swaps_every_replica(tmp_path):
    """/reload restores the newest checkpoint into fresh modules, replicates
    them before taking the device lock and swaps them all; the replicas a
    stream pinned are left as they were."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path))
    old = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    new = trainer.init_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    ckpt_lib.save(str(tmp_path), old._replace(step=1), cfg)
    svc = ModelService(cfg, state=old._replace(step=1), mesh=_mesh(2), device="cpu")
    plain = ModelService(cfg, state=new._replace(step=2), device="cpu")
    try:
        pinned = list(svc._replicas)
        for rep in pinned:
            torch.testing.assert_close(rep.state_dict(), old.model.state_dict())
        ckpt_lib.save(str(tmp_path), new._replace(step=2), cfg)
        assert svc.reload() == 2
        assert len(svc._replicas) == 2 and all(r is not p for r, p in zip(svc._replicas, pinned))
        for rep in svc._replicas:
            torch.testing.assert_close(rep.state_dict(), new.model.state_dict())
        for rep in pinned:
            torch.testing.assert_close(rep.state_dict(), old.model.state_dict())
        _levels(svc.sample(3), plain.sample(3))
    finally:
        svc.close()
        plain.close()


def test_a_bundle_is_served_without_a_mesh(tmp_path):
    from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib

    cfg = tiny_test_config(steps=4)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    out = str(tmp_path / "bundle")
    bundle_lib.export_bundle(cfg, state, out, programs=["sample"])
    svc = ModelService(cfg, bundle=bundle_lib.load_bundle(out, "cpu"), mesh=_mesh(2),
                       device="cpu")
    try:
        assert svc.mesh is None
        assert svc.sample(2).shape == (2, cfg.size, cfg.size, 3)
    finally:
        svc.close()


def test_what_the_service_refuses():
    cfg = tiny_test_config()
    with pytest.raises(ValueError, match="not of the service's device cpu"):
        ModelService(cfg, mesh=["cpu", "meta"], device="cpu")
    svc = ModelService(cfg, mesh=_mesh(1), device="cpu")  # one replica: the plain path
    try:
        assert svc.mesh is None
    finally:
        svc.close()
