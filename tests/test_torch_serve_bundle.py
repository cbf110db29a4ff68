"""Serving a compiled bundle in the port (serve/server.py bundle mode,
``build_bundle_service``, ``cli serve --bundle``): the artifact's programs
behind the same batchers, shed and metrics as a checkpoint-backed service,
on the CPU. The surfaces a bundle does not serve answer with the JAX
server's statuses and messages (tests/test_serve_bundle.py).

Tolerance: none — on the CPU the bundle's programs equal the in-process
ones bit for bit (tests/test_torch_bundle.py), and both services draw their
noise from a generator seeded ``cfg.seed + 99``, so the answers are equal
bytes.
"""

import io
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.serve import server as srv_mod  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.server import ModelService, Server  # noqa: E402
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A diffusion bundle behind the threaded and the asyncio frontends, and
    the train state it was exported from."""
    cfg = tiny_test_config(steps=4)
    state = trainer.init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    out = str(tmp_path_factory.mktemp("bundles") / "diffusion")
    bundle_lib.export_bundle(cfg, state, out)
    service = ModelService(cfg, bundle=bundle_lib.load_bundle(out, "cpu"), device="cpu")
    servers = [Server(service).start(), AsyncServer(service).start()]
    yield servers, service, cfg, state, out
    for s in servers:
        s.stop()
    service.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read()


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _image(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (cfg.size, cfg.size, 3), dtype=np.uint8)


def test_bundle_healthz_and_metrics(served):
    servers, service, _, _, _ = served
    for s in servers:
        status, body = _get(s.port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        assert json.loads(body)["step"] == 0
        status, body = _get(s.port, "/metrics")
        assert status == 200
        text = body.decode()
        assert "gct2_checkpoint_step 0" in text
        assert 'gct2_queue_depth{batcher="sample"}' in text
        assert 'gct2_queue_depth{batcher="denoise"}' in text


def test_bundle_sample_equals_the_checkpoint_server(served):
    """The bundle service's /sample bytes equal a checkpoint-backed
    service's: the same noise stream, the same program content."""
    servers, service, cfg, state, _ = served
    ref = ModelService(cfg, state=state, device="cpu")
    try:
        for s in servers:
            service._gen.manual_seed(cfg.seed + 99)
            ref._gen.manual_seed(cfg.seed + 99)
            status, body = _post(s.port, "/sample", json.dumps({"num": 3, "format": "npy"})
                                 .encode())
            assert status == 200
            np.testing.assert_array_equal(np.load(io.BytesIO(body)), ref.sample(3))
    finally:
        ref.close()


def test_bundle_denoise(served):
    servers, service, cfg, state, _ = served
    ref = ModelService(cfg, state=state, device="cpu")
    try:
        img = _image(cfg)
        service._gen.manual_seed(5)
        ref._gen.manual_seed(5)
        status, body = _post(servers[0].port, "/denoise?format=npy", _npy(img))
        assert status == 200
        x = srv_mod._decode_image(_npy(img), cfg.size)
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      srv_mod._to_uint8(ref.denoise(x)))
    finally:
        ref.close()


def test_bundle_unsupported_surfaces(served):
    """JAX's statuses: /reload 400 (immutable), a stream and /edit 400
    (checkpoint-backed only), /transfer 400 (no transfer program)."""
    servers, _, cfg, _, _ = served
    img = _npy(_image(cfg))
    for s in servers:
        status, body = _post(s.port, "/reload", b"")
        assert status == 400 and b"immutable" in body
        status, body = _post(s.port, "/sample", json.dumps({"num": 1, "stream": True}).encode())
        assert status == 400 and b"not available from a bundle" in body
        status, body = _post(s.port, "/edit", img)
        assert status == 400 and b"not available from a bundle" in body
        status, body = _post(s.port, "/transfer?direction=ab", img)
        assert status == 400 and b"not served" in body


def test_partial_bundle_metrics_and_denoise(tmp_path):
    """A sample-only bundle serves /metrics without a denoise batcher; a
    preview-only one serves /denoise and refuses /sample."""
    cfg = tiny_test_config(steps=4)
    state = trainer.init_state(cfg, device="cpu")
    out_s, out_p = str(tmp_path / "sample_only"), str(tmp_path / "preview_only")
    bundle_lib.export_bundle(cfg, state, out_s, programs=["sample"])
    bundle_lib.export_bundle(cfg, state, out_p, programs=["preview"])
    svc = ModelService(cfg, bundle=bundle_lib.load_bundle(out_s, "cpu"), device="cpu")
    try:
        text = svc.metrics_text()
        assert 'gct2_queue_depth{batcher="sample"}' in text
        assert 'gct2_queue_depth{batcher="denoise"}' not in text
        with pytest.raises(ValueError, match="denoise not served"):
            svc.denoise(np.zeros((1, cfg.size, cfg.size, 3), np.float32))
    finally:
        svc.close()
    svc = ModelService(cfg, bundle=bundle_lib.load_bundle(out_p, "cpu"), device="cpu")
    try:
        img = np.zeros((1, cfg.size, cfg.size, 3), np.float32)
        assert svc.denoise(img).shape == (1, cfg.size, cfg.size, 3)
        with pytest.raises(ValueError, match="sampling not served"):
            svc.sample(1)
    finally:
        svc.close()


def test_bundle_service_overrides(tmp_path):
    """build_bundle_service applies explicit Config fields (the shedding
    knobs) over the manifest's config, and refuses a bundle on a device it
    does not list."""
    cfg = tiny_test_config(steps=4)
    out = str(tmp_path / "b")
    bundle_lib.export_bundle(cfg, trainer.init_state(cfg, device="cpu"), out,
                             programs=["sample"])
    svc = srv_mod.build_bundle_service(out, overrides={"serve_max_queue": 8}, device="cpu")
    try:
        assert svc._max_queue == 8 and svc.cfg.serve_max_queue == 8
        assert svc.cfg.size == cfg.size and svc.step == 0
    finally:
        svc.close()
    cuda_only = str(tmp_path / "c")
    bundle_lib.export_bundle(cfg, trainer.init_state(cfg, device="cpu"), cuda_only,
                             programs=["sample"], platforms=("cuda",))
    with pytest.raises(ValueError, match="not on 'cpu'"):
        srv_mod.build_bundle_service(cuda_only, device="cpu")


def test_gan_and_cgan_bundle_services(tmp_path):
    """/transfer?direction= from a cycle-GAN bundle and /transfer?to= from a
    cGAN bundle equal the checkpoint-backed services' answers (both run on
    their batchers' threads, whose intra-op thread count is the default's);
    sampling is not in them."""
    cfg = tiny_test_config(g_norm="instance", d_norm="instance")
    gstate = gan.init_gan_state(cfg, device="cpu")
    bundle_lib.export_bundle(cfg, gstate, str(tmp_path / "g"), model="gan")
    svc = ModelService(cfg, bundle=bundle_lib.load_bundle(str(tmp_path / "g"), "cpu"),
                       device="cpu")
    ref = ModelService(cfg, gan_state=gstate, device="cpu")
    img = np.random.default_rng(1).uniform(-1, 1, (1, cfg.size, cfg.size, 3)).astype(np.float32)
    try:
        for d in ("ab", "ba"):
            np.testing.assert_array_equal(svc.transfer(img, d), ref.transfer(img, d))
        with pytest.raises(ValueError, match="sampling not served"):
            svc.sample(1)
    finally:
        svc.close()
        ref.close()
    ccfg = tiny_test_config(num_classes=3, g_norm="instance", d_norm="instance")
    cstate = cgan.init_conditional_gan_state(ccfg, device="cpu")
    bundle_lib.export_bundle(ccfg, cstate, str(tmp_path / "c"), model="cgan")
    svc = ModelService(ccfg, bundle=bundle_lib.load_bundle(str(tmp_path / "c"), "cpu"),
                       device="cpu")
    ref = ModelService(ccfg, cgan_state=cstate, device="cpu")
    try:
        np.testing.assert_array_equal(svc.transfer_to(img, 2), ref.transfer_to(img, 2))
        with pytest.raises(ValueError, match="not served"):
            svc.sample(1)
        with pytest.raises(ValueError, match="not served"):
            svc.transfer(img, "ab")
    finally:
        svc.close()
        ref.close()


def test_cli_serve_bundle_serves_only_the_bundle(served, monkeypatch):
    """``serve --bundle`` starts the bundle server with the explicit flags as
    overrides and returns; it never also starts a checkpoint server."""
    _, _, _, _, out = served
    calls = []
    monkeypatch.setattr(srv_mod, "serve_from_bundle",
                        lambda path, **kw: calls.append(("bundle", path, kw)))
    monkeypatch.setattr(srv_mod, "serve_from_checkpoint",
                        lambda *a, **kw: calls.append(("checkpoint",)))
    assert cli.main(["serve", "--device", "cpu", "--bundle", out, "--serve-max-queue", "8",
                     "--port", "0", "--frontend", "aio"]) == 0
    assert len(calls) == 1 and calls[0][:2] == ("bundle", out)
    kw = calls[0][2]
    assert kw["overrides"] == {"serve_max_queue": 8} and kw["frontend"] == "aio"
    assert kw["device"] == "cpu" and kw["port"] == 0
