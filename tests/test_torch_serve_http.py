"""The port's threaded HTTP frontend (serve/server.py) over a real socket —
twins of tests/test_serve.py and tests/test_serve_ops.py: the same statuses,
content types, shapes, ``gct2_*`` metric lines, 503 mapping, body limits
and stream guards; reload (a stream begun before /reload ends on the old
weights, bit for bit on the CPU; the prune-race retry); the serve command
on the CPU. Coalescing is held deterministic by a gate: the test holds the
device lock until every request is queued."""

import base64
import copy
import http.client
import io
import json
import os
import select
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.serve import server as srv_mod  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.server import (  # noqa: E402
    ModelService,
    SampleBatcher,
    Server,
    ServerBusy,
    build_service,
)
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--size", "16", "--pixel-size", "4", "--max-size", "8", "--octaves", "2",
        "--steps", "4"]


def _states(cfg, seed=0):
    return (trainer.init_state(cfg, torch.Generator().manual_seed(seed), device="cpu"),
            gan.init_gan_state(cfg, torch.Generator().manual_seed(seed + 1), device="cpu"))


@pytest.fixture(scope="module")
def server():
    cfg = tiny_test_config()
    state, gan_state = _states(cfg)
    srv = Server(ModelService(cfg, state=state, gan_state=gan_state, device="cpu")).start()
    yield srv, cfg
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=60) as r:
        return r.status, r.read()


def _post(srv, path, data, headers=None, full=False):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            out = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        out = e.code, e.read(), e.headers
    return out if full else out[:2]


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _rand_u8(cfg, seed):
    return np.random.default_rng(seed).integers(0, 256, (cfg.size, cfg.size, 3), dtype=np.uint8)


def _gated(svc, batcher, fire, total, timeout=60):
    """Run ``fire()`` (which starts request threads and returns them) while
    the device lock is held: the first batch the collector takes blocks on
    the lock, the rest queue behind it; the lock is released once every
    requested image is either in that batch or queued. Returns the image
    count of each device batch."""
    calls = []
    orig = batcher._execute

    def counting(batch):
        calls.append(sum(r.num for r in batch))
        return orig(batch)

    batcher._execute = counting
    try:
        with svc._lock:
            threads = fire()
            deadline = time.monotonic() + timeout
            while not (calls and calls[0] + batcher.depth() == total):
                assert time.monotonic() < deadline, (calls, batcher.depth())
                time.sleep(0.005)
        for t in threads:
            t.join(timeout)
            assert not t.is_alive()
    finally:
        batcher._execute = orig
    return calls


def _threads(n, target):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    return threads


# ---------------------------------------------------------- test_serve twins


def test_healthz(server):
    srv, _ = server
    status, body = _get(srv, "/healthz")
    assert status == 200
    assert json.loads(body) == {"status": "ok", "step": 0}


def test_sample_png(server):
    srv, cfg = server
    status, body, headers = _post(srv, "/sample", json.dumps({"num": 2}).encode(), full=True)
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert Image.open(io.BytesIO(body)).size == (cfg.size, cfg.size)


def test_sample_base64_batch(server):
    srv, _ = server
    status, body = _post(srv, "/sample", json.dumps({"num": 3, "format": "base64"}).encode())
    assert status == 200
    assert len(json.loads(body)["images"]) == 3  # num 3 pads to 4 inside, returns 3


def test_denoise_roundtrip(server):
    srv, cfg = server
    status, body = _post(srv, "/denoise", _png(_rand_u8(cfg, 0)))
    assert status == 200
    assert Image.open(io.BytesIO(body)).size == (cfg.size, cfg.size)


def test_edit_endpoint(server):
    srv, cfg = server
    png_body = _png(_rand_u8(cfg, 2))
    status, body = _post(srv, "/edit?edits=pixelate,shift", png_body)
    assert status == 200
    out = json.loads(body)
    assert list(out) == ["pixelate", "reconstruction", "shift"]
    img = Image.open(io.BytesIO(base64.b64decode(out["pixelate"])))
    assert img.size == (cfg.size, cfg.size)
    status, body = _post(srv, "/edit?edits=sharpen", png_body)
    assert status == 400 and "sharpen" in json.loads(body)["error"]


def test_transfer_directions(server):
    srv, cfg = server
    body = _png(_rand_u8(cfg, 1))
    s1, b1 = _post(srv, "/transfer?direction=ab", body)
    s2, b2 = _post(srv, "/transfer?direction=ba", body)
    assert s1 == s2 == 200
    assert b1 != b2  # different generators


def test_error_paths(server):
    srv, _ = server
    assert _post(srv, "/sample", json.dumps({"num": 10_000}).encode())[0] == 400
    assert _post(srv, "/nope", b"")[0] == 404
    assert _get(srv, "/healthz")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/nope")
    assert e.value.code == 404
    assert _post(srv, "/transfer?direction=zz", b"")[0] == 400
    assert _post(srv, "/transfer?direction=abba", b"")[0] == 400


def test_conditional_transfer_and_classes_are_refused(server):
    """No cGAN is served: /transfer?to=K answers JAX's 400; a class on an
    unconditional checkpoint is a 400 too."""
    srv, cfg = server
    status, body = _post(srv, "/transfer?to=1", _npy(_rand_u8(cfg, 3)))
    assert status == 400 and "conditional transfer not served" in json.loads(body)["error"]
    status, body = _post(srv, "/sample", json.dumps({"num": 1, "class": 0}).encode())
    assert status == 400 and "unconditional" in json.loads(body)["error"]


def test_gan_only_service_rejects_sample():
    cfg = tiny_test_config()
    _, gan_state = _states(cfg, 2)
    srv = Server(ModelService(cfg, gan_state=gan_state, device="cpu")).start()
    try:
        status, body = _post(srv, "/sample", json.dumps({"num": 1}).encode())
        assert status == 400 and "diffusion" in json.loads(body)["error"]
        status, body = _post(srv, "/sample", json.dumps({"num": 1, "stream": True}).encode())
        assert status == 400 and "diffusion" in json.loads(body)["error"]
        zeros = np.zeros((cfg.size, cfg.size, 3), np.uint8)
        assert _post(srv, "/transfer?direction=ab", _png(zeros))[0] == 200
        assert _post(srv, "/denoise", _png(zeros))[0] == 400
        assert _post(srv, "/edit", _png(zeros))[0] == 400
    finally:
        srv.stop()


def test_concurrent_samples_coalesce(server):
    """8 concurrent num=2 /sample requests take at most 2 device batches and
    cover all 16 images (the gate holds the first batch until all are
    queued, so no window timing is involved)."""
    srv, _ = server
    svc = srv.service
    results = [None] * 8

    def hit(i):
        status, body = _post(srv, "/sample", json.dumps({"num": 2, "format": "npy"}).encode())
        results[i] = (status, np.load(io.BytesIO(body)).shape[0])

    before = svc.counters["device_batches"]
    calls = _gated(svc, svc._batcher, lambda: _threads(8, hit), 16)
    assert all(r == (200, 2) for r in results), results
    assert len(calls) <= 2 and sum(calls) == 16, calls
    assert svc.counters["device_batches"] - before == len(calls)


def test_concurrent_denoise_coalesce(server):
    srv, cfg = server
    svc = srv.service
    body = _png(_rand_u8(cfg, 4))
    results = [None] * 5

    def hit(i):
        results[i] = _post(srv, "/denoise", body)[0]

    calls = _gated(svc, svc._denoise_batcher, lambda: _threads(5, hit), 5)
    assert results == [200] * 5
    assert len(calls) <= 2 and sum(calls) == 5, calls


def test_sample_stream_yields_progression(server):
    srv, cfg = server
    status, body, headers = _post(
        srv, "/sample", json.dumps({"num": 1, "stream": True, "segments": 3}).encode(),
        full=True)
    assert status == 200
    assert headers["Content-Type"] == "multipart/x-mixed-replace; boundary=gct2frame"
    assert body.endswith(b"--gct2frame--\r\n")
    parts = body.split(b"--gct2frame")
    pngs = [p.split(b"\r\n\r\n", 1)[1] for p in parts if b"image/png" in p]
    assert len(pngs) == 3
    for p in pngs:
        assert Image.open(io.BytesIO(p[:-2])).size == (cfg.size, cfg.size)
    assert pngs[0] != pngs[-1]


def test_sample_stream_matches_full_sampler(server):
    """The stream's last state is the full sample of the same noise."""
    _, cfg = server
    svc = ModelService(cfg, state=_states(cfg, 3)[0], device="cpu")
    try:
        g = torch.Generator().manual_seed(0)
        g.set_state(svc._gen.get_state())
        init = torch.randn((1, cfg.size, cfg.size, 3), generator=g)
        *_, last = svc.sample_stream(1, segments=3)
        full = sampler.sample(cfg, svc._model, init, snapshots=False).images.numpy()
        np.testing.assert_array_equal(last, full)
    finally:
        svc.close()


def test_service_refuses_what_is_not_ported(tmp_path):
    cfg = tiny_test_config()
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        ModelService(cfg, mesh=["cuda:0", "cuda:1"], device="cpu")
    # bundles are ported (tests/test_torch_serve_bundle.py): a directory that
    # holds none is refused by name, as JAX's load_bundle refuses it
    with pytest.raises(FileNotFoundError, match="is not a model bundle"):
        srv_mod.build_bundle_service(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="is not a model bundle"):
        srv_mod.serve_from_bundle(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="num_classes >= 2"):  # cgan is served with classes
        build_service(cfg, "cgan", device="cpu")
    state, _ = _states(cfg)
    with pytest.raises(ValueError, match="lives on cpu"):
        ModelService(cfg, state=state, device="meta")
    svc = ModelService(cfg, state=state, mesh=["cpu"], device="cpu")  # one device: served
    svc.close()


@pytest.mark.parametrize("model", ["diffusion", "gan"])
def test_build_service_restores_the_latest_checkpoint(tmp_path, model, capsys):
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path), mesh_data=0)
    state, gan_state = _states(cfg, 4)
    st = (state if model == "diffusion" else gan_state)._replace(step=7)
    ckpt_lib.save(str(tmp_path), st, cfg)
    svc = build_service(cfg, model, device="cpu")
    try:
        assert svc.step == 7
        img = np.zeros((1, cfg.size, cfg.size, 3), np.float32)
        if model == "diffusion":
            assert svc.sample(3).shape == (3, cfg.size, cfg.size, 3)
            torch.testing.assert_close(svc._model.state_dict(), state.model.state_dict())
        else:
            assert svc.transfer(img, "ba").shape == img.shape
            torch.testing.assert_close(svc._generators["ba"].state_dict(),
                                       gan_state.g_ba.state_dict())
    finally:
        svc.close()
    empty = tiny_test_config(checkpoint_dir=str(tmp_path / "none"))
    build_service(empty, model, device="cpu").close()
    assert "serving randomly initialised weights" in capsys.readouterr().err


def test_batcher_load_shed():
    """serve_max_queue: submits past the queued-image cap raise ServerBusy
    while a device batch is in flight; queued work still completes."""
    release, started = threading.Event(), threading.Event()

    def run(total):
        started.set()
        release.wait(10)
        return np.zeros((total, 4, 4, 3), np.float32)

    b = SampleBatcher(run, max_batch=8, max_wait_s=0.0, max_queue=4)
    try:
        results = []
        t1 = threading.Thread(target=lambda: results.append(b.submit(2)))
        t1.start()
        assert started.wait(5)  # the collector is now inside run()
        t2 = threading.Thread(target=lambda: results.append(b.submit(4)))
        t2.start()
        deadline = time.time() + 5
        while b.depth() < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert b.depth() == 4
        with pytest.raises(ServerBusy):
            b.submit(1)  # 4 queued + 1 > max_queue
        release.set()
        t1.join(5)
        t2.join(5)
        assert not t1.is_alive() and not t2.is_alive()
        assert sorted(r.shape[0] for r in results) == [2, 4]
    finally:
        release.set()
        b.close()


def test_queue_shed_maps_to_503_with_retry_after():
    """Past serve_max_queue the service answers 503 + Retry-After over HTTP,
    and counts the rejection."""
    cfg = tiny_test_config(serve_max_queue=3)
    srv = Server(ModelService(cfg, state=_states(cfg, 5)[0], device="cpu")).start()
    svc = srv.service
    try:
        out = {}

        def first(i):
            out[i] = _post(srv, "/sample", json.dumps({"num": 1, "format": "npy"}).encode())[0]

        with svc._lock:
            t = _threads(1, first)[0]
            while svc.counters["device_batches"] < 1:  # its batch waits on the lock
                time.sleep(0.005)
            t2 = _threads(1, lambda i: out.update(q=_post(
                srv, "/sample", json.dumps({"num": 3}).encode())[0]))[0]
            while svc._batcher.depth() < 3:
                time.sleep(0.005)
            status, body, headers = _post(srv, "/sample", json.dumps({"num": 1}).encode(),
                                          full=True)
        for th in (t, t2):
            th.join(60)
        assert status == 503 and headers["Retry-After"] == "1"
        assert "queue full" in json.loads(body)["error"]
        assert out == {0: 200, "q": 200}
        assert svc.counters["rejected_busy"] == 1
    finally:
        srv.stop()


def test_busy_maps_to_503(server):
    srv, _ = server
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


def test_device_fault_is_a_500_and_the_batcher_lives_on(server):
    """A device error (as a CUDA fault surfaces at the next sync) reaches
    the batch's callers as a 500; the next request is served."""
    srv, _ = server
    b = srv.service._batcher
    orig = b._run

    def fault(num):
        b._run = orig
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    b._run = fault
    try:
        status, body = _post(srv, "/sample", json.dumps({"num": 1}).encode())
        assert status == 500 and "illegal memory access" in json.loads(body)["error"]
        assert _post(srv, "/sample", json.dumps({"num": 1}).encode())[0] == 200
    finally:
        b._run = orig


def test_metrics_include_queue_depth_and_shed_counter(server):
    srv, _ = server
    status, body = _get(srv, "/metrics")
    assert status == 200
    for line in (b'gct2_queue_depth{batcher="sample"}', b'gct2_queue_depth{batcher="denoise"}',
                 b'gct2_queue_depth{batcher="transfer_ab"}',
                 b'gct2_queue_depth{batcher="transfer_ba"}', b"# TYPE gct2_rejected_busy counter",
                 b"gct2_streams_active 0", b"gct2_checkpoint_step 0"):
        assert line in body


def test_stream_request_guards(server):
    srv, _ = server
    code, body = _post(srv, "/sample", json.dumps(
        {"num": 1, "stream": True, "segments": 10**9}).encode())
    assert code == 400 and b"segments" in body
    code, body = _post(srv, "/sample", json.dumps(
        {"num": 2, "stream": True, "segments": 2}).encode())
    assert code == 400 and b"num=1" in body


def test_batcher_submit_after_close_raises():
    b = SampleBatcher(lambda n: np.zeros((n, 2, 2, 3), np.float32))
    b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(1)


def test_stream_load_shed():
    """Streams (and /edit) have their own shed: beyond serve_max_streams,
    sample_stream raises ServerBusy eagerly; slots free on close and on
    exhaustion."""
    cfg = tiny_test_config(serve_max_streams=2)
    svc = ModelService(cfg, state=_states(cfg, 6)[0], device="cpu")
    try:
        s1 = svc.sample_stream(1, segments=2)
        s2 = svc.sample_stream(1, segments=2)
        with pytest.raises(ServerBusy, match="trajectories active"):
            svc.sample_stream(1, segments=2)
        assert "gct2_streams_active 2" in svc.metrics_text()
        s1.close()  # released on close, not only on exhaustion
        s3 = svc.sample_stream(1, segments=2)
        list(s3)
        assert "gct2_streams_active 1" in svc.metrics_text()
        s2.close()
        assert "gct2_streams_active 0" in svc.metrics_text()
        s4, s5 = svc.sample_stream(1, segments=2), svc.sample_stream(1, segments=2)
        img = np.zeros((1, cfg.size, cfg.size, 3), np.float32)
        with pytest.raises(ServerBusy, match="trajectories active"):
            svc.edit(img, edits=("shift",))
        s4.close()
        s5.close()
        out = svc.edit(img, edits=("shift",))
        assert list(out) == ["reconstruction", "shift"]
        assert svc.counters["rejected_busy"] == 2
    finally:
        svc.close()


def test_stream_shed_over_http_is_a_503_before_the_header():
    cfg = tiny_test_config(serve_max_streams=1)
    srv = Server(ModelService(cfg, state=_states(cfg, 7)[0], device="cpu")).start()
    try:
        held = srv.service.sample_stream(1, segments=2)
        status, body, headers = _post(srv, "/sample", json.dumps(
            {"num": 1, "stream": True}).encode(), full=True)
        assert status == 503 and headers["Retry-After"] == "1"
        assert "trajectories active" in json.loads(body)["error"]
        held.close()
        assert _post(srv, "/sample", json.dumps({"num": 1, "stream": True}).encode())[0] == 200
    finally:
        srv.stop()


def test_malformed_json_shapes_are_400_not_500(server):
    srv, _ = server
    for body in (b"[1]", b'"x"', b'{"num": null}', b'{"num": "many"}', b"{bad json"):
        status, resp = _post(srv, "/sample", body)
        assert status == 400, (body, status, resp)


@pytest.mark.parametrize("length", [100 * 1024**3, -1])
def test_body_length_guards(server, length):
    srv, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        conn.putrequest("POST", "/sample")
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and b"outside" in resp.read()
    finally:
        conn.close()


def test_edit_bumps_device_batches(server):
    srv, cfg = server
    before = srv.service.counters["device_batches"]
    assert _post(srv, "/edit?edits=shift", _png(_rand_u8(cfg, 0)))[0] == 200
    assert srv.service.counters["device_batches"] == before + 1


def test_sample_npy_batch(server):
    srv, cfg = server
    status, body, headers = _post(srv, "/sample", json.dumps(
        {"num": 3, "format": "npy"}).encode(), full=True)
    assert status == 200 and headers["Content-Type"] == "application/octet-stream"
    arr = np.load(io.BytesIO(body))
    assert arr.shape == (3, cfg.size, cfg.size, 3) and arr.dtype == np.uint8


def test_sample_unknown_format_rejected(server):
    srv, _ = server
    status, body = _post(srv, "/sample", json.dumps({"num": 1, "format": "jpeg"}).encode())
    assert status == 400 and b"png | base64 | npy" in body


def test_image_endpoints_npy_roundtrip(server):
    """A .npy uint8 body in, format=npy out; the raw path and the PNG path
    see the same pixels (compared through the deterministic /transfer)."""
    srv, cfg = server
    arr = _rand_u8(cfg, 7)
    status, body = _post(srv, "/denoise?format=npy", _npy(arr))
    assert status == 200
    out = np.load(io.BytesIO(body))
    assert out.shape == (1, cfg.size, cfg.size, 3) and out.dtype == np.uint8
    status, body = _post(srv, "/transfer?direction=ab&format=npy", _npy(arr[None]))
    assert status == 200
    out = np.load(io.BytesIO(body))
    assert out.shape == (1, cfg.size, cfg.size, 3) and out.dtype == np.uint8
    status, png_body = _post(srv, "/transfer?direction=ab", _png(arr))
    assert status == 200
    np.testing.assert_array_equal(out[0], np.asarray(Image.open(io.BytesIO(png_body))))


def test_off_size_upload_is_resampled(server):
    srv, cfg = server
    big = np.random.default_rng(9).integers(0, 256, (40, 24, 3), dtype=np.uint8)
    status, body = _post(srv, "/transfer?direction=ab&format=npy", _png(big))
    assert status == 200 and np.load(io.BytesIO(body)).shape == (1, cfg.size, cfg.size, 3)


def test_edit_npy_returns_keyed_npz(server):
    srv, cfg = server
    status, body = _post(srv, "/edit?edits=pixelate,shift&format=npy", _npy(_rand_u8(cfg, 8)))
    assert status == 200
    with np.load(io.BytesIO(body)) as z:
        assert sorted(z.files) == ["pixelate", "reconstruction", "shift"]
        assert z["shift"].shape == (1, cfg.size, cfg.size, 3) and z["shift"].dtype == np.uint8


def test_npy_body_validation(server):
    srv, cfg = server
    status, body = _post(srv, "/denoise", _npy(np.zeros((cfg.size, cfg.size, 3), np.float32)))
    assert status == 400 and b"uint8" in body
    status, body = _post(srv, "/denoise", _npy(np.zeros((32, 32, 3), np.uint8)))
    assert status == 400 and b"not resampled" in body
    assert _post(srv, "/denoise", _npy(np.zeros((cfg.size, cfg.size), np.uint8)))[0] == 400
    assert _post(srv, "/denoise", b"\x93NUMPY garbage")[0] == 400
    assert _post(srv, "/denoise", b"garbage")[0] == 400
    status, body = _post(srv, "/denoise?format=jpeg", _npy(_rand_u8(cfg, 0)))
    assert status == 400 and b"png | npy" in body


# ------------------------------------------------------ test_serve_ops twins


def _checkpoint(tmp_path, cfg, state, step):
    ckpt_lib.save(str(tmp_path), state._replace(step=step), cfg)


def _moved(state, by):
    """A copy of ``state`` with every weight (and EMA) moved by ``by``."""
    out = copy.deepcopy(state)
    with torch.no_grad():
        for p in out.model.parameters():
            p.add_(by)
        for e in out.ema_params or []:
            e.add_(by)
    return out


def test_reload_picks_up_new_checkpoint(tmp_path):
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path), ema_decay=0.9)
    state, _ = _states(cfg, 8)
    _checkpoint(tmp_path, cfg, state, 3)
    svc = build_service(cfg, device="cpu")
    srv = Server(svc).start()
    try:
        assert json.loads(_get(srv, "/healthz")[1])["step"] == 3
        _checkpoint(tmp_path, cfg, _moved(state, 0.05), 6)  # training goes on
        status, body = _post(srv, "/reload", b"")
        assert status == 200 and json.loads(body)["step"] == 6
        assert json.loads(_get(srv, "/healthz")[1])["step"] == 6
        assert "gct2_reloads 1" in _get(srv, "/metrics")[1].decode()
        want = trainer.eval_model(_moved(state, 0.05))
        torch.testing.assert_close(svc._model.state_dict(), want.state_dict())
    finally:
        srv.stop()


def test_reload_without_checkpoint_dir_rejected():
    cfg = tiny_test_config(checkpoint_dir=None)
    srv = Server(ModelService(cfg, state=_states(cfg)[0], device="cpu")).start()
    try:
        status, body = _post(srv, "/reload", b"")
        assert status == 400 and "checkpoint" in json.loads(body)["error"]
    finally:
        srv.stop()


def test_metrics_counters():
    cfg = tiny_test_config(checkpoint_dir=None)
    srv = Server(ModelService(cfg, state=_states(cfg)[0], device="cpu")).start()
    try:
        _post(srv, "/sample", json.dumps({"num": 1}).encode())
        status, body = _get(srv, "/metrics")
        assert status == 200
        metrics = {line.split()[0]: float(line.split()[1])
                   for line in body.decode().splitlines() if line and not line.startswith("#")}
        assert metrics["gct2_requests_sample"] == 1
        assert metrics["gct2_device_batches"] == 1
        assert metrics["gct2_checkpoint_step"] == 0
        assert metrics["gct2_reloads"] == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_stream_spanning_a_reload_ends_on_the_old_weights(tmp_path, ema):
    """A stream begun before /reload advances its trajectory with the
    weights it started on: every frame equals an unbroken stream on the old
    weights, bit for bit on the CPU, and /healthz reports the new step."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path), ema_decay=ema, sample_stride=3)
    state, _ = _states(cfg, 9)
    _checkpoint(tmp_path, cfg, state, 1)
    old = copy.deepcopy(trainer.eval_model(state))
    srv = Server(build_service(cfg, device="cpu")).start()
    svc = srv.service
    try:
        g = torch.Generator().manual_seed(0)
        g.set_state(svc._gen.get_state())
        init = torch.randn((1, cfg.size, cfg.size, 3), generator=g)
        stream = svc.sample_stream(1, segments=4)
        frames = [next(stream)]
        _checkpoint(tmp_path, cfg, _moved(state, 0.1), 2)
        assert json.loads(_post(srv, "/reload", b"")[1])["step"] == 2
        frames += list(stream)
        assert json.loads(_get(srv, "/healthz")[1])["step"] == 2
        want = list(sampler.sample_stream(cfg, old, init, segments=4))
        assert len(frames) == len(want) == 4
        for got, ref in zip(frames, want):
            np.testing.assert_array_equal(got, ref)
        # the new weights are served to the next request
        new = trainer.eval_model(_moved(state, 0.1))
        torch.testing.assert_close(svc._model.state_dict(), new.state_dict())
        assert not torch.equal(next(old.parameters()), next(svc._model.parameters()))
    finally:
        srv.stop()


def test_reload_retries_a_step_pruned_mid_restore(tmp_path, monkeypatch):
    """A training save with checkpoint_keep may prune the step reload
    resolved: reload re-resolves and restores the newer one. A restore
    error while the step still exists is raised at once."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path))
    state, _ = _states(cfg, 10)
    _checkpoint(tmp_path, cfg, state, 1)
    svc = build_service(cfg, device="cpu")
    _checkpoint(tmp_path, cfg, state, 2)
    real = ckpt_lib.restore
    calls = []

    def racing(ckpt_dir, like, step=None, generator=None):
        calls.append(step)
        if len(calls) == 1:  # the pruner: step 3 lands, step 2 goes
            _checkpoint(tmp_path, cfg, _moved(state, 0.1), 3)
            shutil.rmtree(os.path.join(str(tmp_path), "step_000000002"))
            raise FileNotFoundError("step_000000002 vanished")
        return real(ckpt_dir, like, step=step, generator=generator)

    monkeypatch.setattr(ckpt_lib, "restore", racing)
    try:
        assert svc.reload() == 3 and calls == [2, 3]

        def broken(ckpt_dir, like, step=None, generator=None):
            calls.append(step)
            raise ValueError("checkpoint does not match the state's structure")

        monkeypatch.setattr(ckpt_lib, "restore", broken)
        calls.clear()
        with pytest.raises(ValueError, match="structure"):
            svc.reload()
        assert calls == [3] and svc.step == 3
    finally:
        svc.close()


# ------------------------------------------------------------- the command


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(ValueError, match="num_classes >= 2"):  # cgan is served with classes
        cli.main(["serve", "--device", "cpu", *TINY, "--model", "cgan"])
    with pytest.raises(FileNotFoundError, match="is not a model bundle"):
        cli.main(["serve", "--device", "cpu", *TINY, "--bundle", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["serve", *TINY, "--checkpoint-dir", str(tmp_path)])


def _serve_cli(args, cwd):
    """Start ``cli serve`` in a subprocess on port 0; returns (process, port)
    once it announces the bound port."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "gan_class_transfer2_tpu_torch.cli", "serve",
                             "--device", "cpu", "--port", "0", *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("serving on"):
                return proc, int(line.split()[2].split(":")[1])
            if not line and proc.poll() is not None:
                break
    proc.kill()
    raise AssertionError(f"serve did not start: {proc.communicate()[1][-2000:]}")


class _Port:
    def __init__(self, port):
        self.port = port


def drive_cli(tmp_path, frontend):
    """``cli serve`` with a diffusion checkpoint (its config.json inherited:
    no width flags) and then a cycle-GAN one, each answering every endpoint
    it serves. Used by this file and its aio twin."""
    cfg = tiny_test_config(checkpoint_dir=str(tmp_path / "d"), sample_stride=5)
    state, gan_state = _states(cfg, 11)
    _checkpoint(tmp_path / "d", cfg, state, 5)
    proc, port = _serve_cli(["--checkpoint-dir", str(tmp_path / "d"), "--frontend", frontend],
                            tmp_path)
    srv = _Port(port)
    try:
        health = json.loads(_get(srv, "/healthz")[1])
        assert health["step"] == 5 and health.get("frontend", "threaded") == frontend
        status, body = _post(srv, "/sample", json.dumps({"num": 2}).encode())
        assert status == 200 and Image.open(io.BytesIO(body)).size == (16, 16)
        status, body = _post(srv, "/sample", json.dumps({"num": 2, "format": "base64"}).encode())
        assert status == 200 and len(json.loads(body)["images"]) == 2
        status, body = _post(srv, "/sample", json.dumps({"num": 3, "format": "npy"}).encode())
        assert status == 200 and np.load(io.BytesIO(body)).shape == (3, 16, 16, 3)
        status, body = _post(srv, "/sample", json.dumps({"stream": True, "segments": 2}).encode())
        assert status == 200 and body.count(b"Content-Type: image/png") == 2
        img = _npy(np.zeros((16, 16, 3), np.uint8))
        assert _post(srv, "/denoise?format=npy", img)[0] == 200
        status, body = _post(srv, "/edit?edits=shift", img)
        assert status == 200 and list(json.loads(body)) == ["reconstruction", "shift"]
        assert json.loads(_post(srv, "/reload", b"")[1]) == {"step": 5}
        metrics = _get(srv, "/metrics")[1].decode()
        assert "gct2_reloads 1" in metrics and "gct2_requests_sample 3" in metrics
    finally:
        proc.kill()
        proc.communicate()
    gcfg = cfg.replace(checkpoint_dir=str(tmp_path / "g"), g_norm="instance")
    gan_state = gan.init_gan_state(gcfg, torch.Generator().manual_seed(12), device="cpu")
    ckpt_lib.save(str(tmp_path / "g"), gan_state._replace(step=4), gcfg)
    proc, port = _serve_cli(["--checkpoint-dir", str(tmp_path / "g"), "--frontend", frontend,
                             "--model", "gan"], tmp_path)
    srv = _Port(port)
    try:
        assert json.loads(_get(srv, "/healthz")[1])["step"] == 4
        for d in ("ab", "ba"):
            status, body = _post(srv, f"/transfer?direction={d}&format=npy", img)
            assert status == 200 and np.load(io.BytesIO(body)).shape == (1, 16, 16, 3)
        assert _post(srv, "/sample", b"{}")[0] == 400
        assert json.loads(_post(srv, "/reload", b"")[1]) == {"step": 4}
    finally:
        proc.kill()
        proc.communicate()


def test_cli_serve_threaded_inherits_the_checkpoint_config(tmp_path):
    drive_cli(tmp_path, "threaded")
