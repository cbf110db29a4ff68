"""The port's asyncio frontend (serve/aio.py) over a real socket — twins of
tests/test_serve_aio.py: the endpoints, the multipart stream, coalescing
through the shared batchers (held deterministic by a gate on the device
lock), the in-flight 503, the header and body limits, the stop on client
disconnect and the bind error from start(); and the serve command with
``--frontend aio``."""

import base64
import io
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.server import ModelService, ServerBusy  # noqa: E402

from test_torch_serve_http import (  # noqa: E402
    _gated,
    _get,
    _npy,
    _png,
    _post,
    _states,
    _threads,
    drive_cli,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def aserver():
    cfg = tiny_test_config()
    state, gan_state = _states(cfg)
    srv = AsyncServer(ModelService(cfg, state=state, gan_state=gan_state, device="cpu")).start()
    yield srv, cfg
    srv.stop()


def test_healthz_reports_aio(aserver):
    srv, _ = aserver
    status, body = _get(srv, "/healthz")
    assert status == 200
    assert json.loads(body) == {"status": "ok", "step": 0, "frontend": "aio"}


def test_sample_png(aserver):
    srv, cfg = aserver
    status, body, headers = _post(srv, "/sample", json.dumps({"num": 2}).encode(), full=True)
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert Image.open(io.BytesIO(body)).size == (cfg.size, cfg.size)


def test_sample_base64_batch(aserver):
    srv, _ = aserver
    status, body = _post(srv, "/sample", json.dumps({"num": 3, "format": "base64"}).encode())
    assert status == 200 and len(json.loads(body)["images"]) == 3


def test_bad_num_rejected(aserver):
    srv, _ = aserver
    assert _post(srv, "/sample", json.dumps({"num": 0}).encode())[0] == 400


def test_unknown_path_404(aserver):
    srv, _ = aserver
    assert _post(srv, "/nope", b"")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/nope")
    assert e.value.code == 404


def test_denoise_roundtrip(aserver):
    srv, cfg = aserver
    arr = np.random.default_rng(0).integers(0, 256, (cfg.size, cfg.size, 3), dtype=np.uint8)
    status, body = _post(srv, "/denoise", _png(arr))
    assert status == 200 and Image.open(io.BytesIO(body)).size == (cfg.size, cfg.size)


def test_transfer_direction(aserver):
    srv, cfg = aserver
    body = _png(np.zeros((cfg.size, cfg.size, 3), np.uint8))
    assert _post(srv, "/transfer?direction=ba", body)[0] == 200
    assert _post(srv, "/transfer?direction=zz", body)[0] == 400
    status, resp = _post(srv, "/transfer?to=1", body)
    assert status == 400 and "conditional transfer not served" in json.loads(resp)["error"]


def test_edit_endpoint(aserver):
    srv, cfg = aserver
    status, body = _post(srv, "/edit?edits=shift", _png(np.zeros((cfg.size, cfg.size, 3),
                                                                  np.uint8)))
    assert status == 200
    out = json.loads(body)
    assert list(out) == ["reconstruction", "shift"]
    assert Image.open(io.BytesIO(base64.b64decode(out["shift"]))).size == (cfg.size, cfg.size)


def test_stream_multipart(aserver):
    srv, _ = aserver
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/sample", data=json.dumps(
        {"num": 1, "stream": True, "segments": 3}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "multipart/x-mixed-replace; boundary=gct2frame"
        payload = r.read()
    assert payload.count(b"--gct2frame") == 4  # 3 frames + terminator
    assert payload.count(b"Content-Type: image/png") == 3
    assert payload.endswith(b"--gct2frame--\r\n")


def test_stream_on_gan_only_service_is_clean_400():
    cfg = tiny_test_config()
    srv = AsyncServer(ModelService(cfg, gan_state=_states(cfg)[1], device="cpu")).start()
    try:
        status, body = _post(srv, "/sample", json.dumps({"num": 1, "stream": True}).encode())
        assert status == 400 and "diffusion" in json.loads(body)["error"]
    finally:
        srv.stop()


def test_oversize_body_rejected_without_buffering(aserver):
    import http.client

    srv, _ = aserver
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        conn.putrequest("POST", "/denoise")
        conn.putheader("Content-Length", str(10 * 1024**3))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and b"body too large" in resp.read()
    finally:
        conn.close()
    assert _get(srv, "/healthz")[0] == 200  # alive after the abusive client


def test_concurrent_requests_coalesce(aserver):
    """8 concurrent num=2 /sample requests share at most 2 device batches
    through the SampleBatcher on the async frontend too (gated)."""
    srv, _ = aserver
    svc = srv.service
    results = [None] * 8

    def hit(i):
        status, body = _post(srv, "/sample", json.dumps({"num": 2, "format": "npy"}).encode())
        results[i] = (status, np.load(io.BytesIO(body)).shape[0])

    calls = _gated(svc, svc._batcher, lambda: _threads(8, hit), 16)
    assert all(r == (200, 2) for r in results), results
    assert len(calls) <= 2 and sum(calls) == 16, calls


def test_malformed_request_gets_400(aserver):
    srv, _ = aserver
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
        s.sendall(b"garbage\r\n\r\n")
        data = s.recv(4096)
    assert data.startswith(b"HTTP/1.1 400") and b"malformed request line" in data


def test_busy_maps_to_503_aio(aserver):
    srv, _ = aserver
    orig = srv.service.sample

    def busy(num, class_idx=None):
        raise ServerBusy("request queue full (test)")

    srv.service.sample = busy
    try:
        status, body, headers = _post(srv, "/sample", json.dumps({"num": 1}).encode(),
                                      full=True)
    finally:
        srv.service.sample = orig
    assert status == 503 and headers["Retry-After"] == "1"
    assert "queue full" in json.loads(body)["error"]


def test_stream_shed_is_a_503(aserver):
    _, cfg = aserver
    cfg = cfg.replace(serve_max_streams=1)
    srv = AsyncServer(ModelService(cfg, state=_states(cfg, 3)[0], device="cpu")).start()
    try:
        held = srv.service.sample_stream(1)
        status, body, headers = _post(srv, "/sample", json.dumps(
            {"num": 1, "stream": True}).encode(), full=True)
        assert status == 503 and headers["Retry-After"] == "1"
        held.close()
        assert _post(srv, "/sample", json.dumps({"num": 1, "stream": True}).encode())[0] == 200
    finally:
        srv.stop()


def test_stream_stops_after_client_disconnect(aserver):
    """A client that reads a little and disconnects does not cost every
    remaining segment: the producer stops at the abandon flag. The gate
    holds the producer after its first segment until the client is gone,
    and the stream has one segment per timestep (10), so the stop does not
    race the segments' speed."""
    srv, _ = aserver
    svc = srv.service
    real = svc.sample_stream
    served, gone = [], threading.Event()

    def gated(num, segments=4, class_idx=None):
        inner = real(num, segments=segments, class_idx=class_idx)

        def gen():
            try:
                for i, snap in enumerate(inner):
                    served.append(i)
                    yield snap
                    gone.wait(20)
            finally:
                inner.close()

        return gen()

    svc.sample_stream = gated
    try:
        body = json.dumps({"num": 1, "stream": True, "segments": 10}).encode()
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"POST /sample HTTP/1.1\r\nHost: x\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        s.recv(64)
        s.close()
        time.sleep(0.5)  # the server sees the reset while writing frame 1
        gone.set()
        deadline = time.time() + 20
        while time.time() < deadline and "gct2_streams_active 0" not in svc.metrics_text():
            time.sleep(0.05)
        assert "gct2_streams_active 0" in svc.metrics_text()
        assert len(served) < 10, served
    finally:
        svc.sample_stream = real


def test_header_count_limit_is_inclusive(aserver):
    srv, _ = aserver
    # urllib adds 6 of its own: 94 + 6 = exactly MAX_HEADERS
    extra = {f"X-H-{i}": "v" for i in range(94)}
    assert _post(srv, "/healthz-nope", b"", headers=extra)[0] == 404
    extra["X-Extra"] = "v"
    status, body = _post(srv, "/healthz-nope", b"", headers=extra)
    assert status == 400 and b"headers" in body


def test_malformed_json_shapes_are_400_not_500(aserver):
    srv, _ = aserver
    for body in (b"[1]", b'"x"', b'{"num": null}', b'{"num": "many"}'):
        status, resp = _post(srv, "/sample", body)
        assert status == 400, (body, status, resp)


def test_inflight_cap_sheds_503(aserver):
    srv, _ = aserver
    old = srv._max_inflight
    srv._max_inflight = 0
    try:
        status, body, headers = _post(srv, "/sample", json.dumps({"num": 1}).encode(),
                                      full=True)
        assert status == 503 and headers["Retry-After"] == "1"
        assert "overloaded" in json.loads(body)["error"]
    finally:
        srv._max_inflight = old


def test_start_surfaces_bind_error():
    cfg = tiny_test_config()
    state, _ = _states(cfg)
    srv = AsyncServer(ModelService(cfg, state=state, device="cpu")).start()
    try:
        clash = AsyncServer(ModelService(cfg, state=state, device="cpu"), port=srv.port)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed to start") as e:
            clash.start()
        # the real OSError, at once (not start()'s 30 s timeout)
        assert isinstance(e.value.__cause__, OSError) and time.monotonic() - t0 < 10
        clash.service.close()
    finally:
        srv.stop()


def test_sample_npy_batch(aserver):
    srv, cfg = aserver
    status, body = _post(srv, "/sample", json.dumps({"num": 3, "format": "npy"}).encode())
    assert status == 200
    arr = np.load(io.BytesIO(body))
    assert arr.shape == (3, cfg.size, cfg.size, 3) and arr.dtype == np.uint8


def test_image_endpoints_npy_roundtrip_aio(aserver):
    srv, cfg = aserver
    arr = np.random.default_rng(7).integers(0, 256, (cfg.size, cfg.size, 3), dtype=np.uint8)
    status, body = _post(srv, "/denoise?format=npy", _npy(arr))
    out = np.load(io.BytesIO(body))
    assert status == 200 and out.shape == (1, cfg.size, cfg.size, 3) and out.dtype == np.uint8
    status, body = _post(srv, "/transfer?direction=ba&format=npy", _npy(arr))
    out = np.load(io.BytesIO(body))
    assert status == 200 and out.shape == (1, cfg.size, cfg.size, 3) and out.dtype == np.uint8
    status, png_body = _post(srv, "/transfer?direction=ba", _png(arr))
    np.testing.assert_array_equal(out[0], np.asarray(Image.open(io.BytesIO(png_body))))
    status, body = _post(srv, "/edit?edits=shift&format=npy", _npy(arr))
    assert status == 200
    with np.load(io.BytesIO(body)) as z:
        assert sorted(z.files) == ["reconstruction", "shift"]
    status, body = _post(srv, "/denoise", _npy(np.zeros((cfg.size, cfg.size, 3), np.float32)))
    assert status == 400 and b"uint8" in body
    status, body = _post(srv, "/transfer?direction=ab&format=jpeg", _npy(arr))
    assert status == 400 and b"png | npy" in body


def test_reload_over_aio(tmp_path):
    from gan_class_transfer2_tpu_torch.serve.server import build_service
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = tiny_test_config(checkpoint_dir=str(tmp_path))
    state, _ = _states(cfg, 4)
    ckpt_lib.save(str(tmp_path), state._replace(step=2), cfg)
    srv = AsyncServer(build_service(cfg, device="cpu")).start()
    try:
        ckpt_lib.save(str(tmp_path), state._replace(step=5), cfg)
        status, body = _post(srv, "/reload", b"")
        assert status == 200 and json.loads(body) == {"step": 5}
        assert json.loads(_get(srv, "/healthz")[1])["step"] == 5
    finally:
        srv.stop()
    srv = AsyncServer(ModelService(cfg.replace(checkpoint_dir=None), state=state,
                                   device="cpu")).start()
    try:
        status, body = _post(srv, "/reload", b"")
        assert status == 400 and "checkpoint" in json.loads(body)["error"]
    finally:
        srv.stop()


def test_cli_serve_aio_inherits_the_checkpoint_config(tmp_path):
    drive_cli(tmp_path, "aio")
