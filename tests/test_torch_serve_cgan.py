"""Class-conditional serving in the port (serve/server.py, serve/aio.py):
``/sample {"class": k}`` on a conditional diffusion checkpoint (a per-sample
class vector through the coalescing batcher, streams and /edit with a
class) and ``/transfer?to=K`` on a conditional-GAN checkpoint (the
targeted batcher, mixed targets in one device batch) — the cases of
tests/test_serve_conditional.py and tests/test_serve_cgan.py on both
frontends, which answer byte for byte alike; the device programs against
the JAX services on carried weights; coalescing held deterministic by a
gate on the device lock; and ``reload`` keeping only the serving modules.

Tolerances: /sample's uint8 within 1 level on ≤ 1e-3 of the values (a
float32 difference flips a value only on a level boundary); streams and
/edit 1e-4 of the array's scale (test_torch_sampler's chains); transfer
1e-5 absolute (test_torch_gan's)."""

import copy
import io
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.sample import sampler as jsampler  # noqa: E402
from gan_class_transfer2_tpu.serve import server as jserver  # noqa: E402
from gan_class_transfer2_tpu.train import conditional_gan as jcgan  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config, tiny_test_config  # noqa: E402
from gan_class_transfer2_tpu_torch.sample import sampler  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer  # noqa: E402
from gan_class_transfer2_tpu_torch.serve.server import (  # noqa: E402
    ModelService,
    SampleBatcher,
    Server,
    build_service,
)
from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan  # noqa: E402
from gan_class_transfer2_tpu_torch.train import gan, trainer  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import weights  # noqa: E402
from test_torch_serve import _close, _replay  # noqa: E402
from test_torch_serve_http import _gated, _get, _npy, _png, _post, _threads  # noqa: E402

torch.set_num_threads(1)


def _cfgs(**overrides):
    jcfg = jconfig.tiny_test_config(num_classes=3, **overrides)
    return jcfg, Config.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def services():
    """JAX and port services on the same conditional diffusion weights and
    the same conditional-GAN weights (instance norms on)."""
    jcfg, cfg = _cfgs(g_norm="instance", d_norm="instance", sample_stride=3)
    jstate = jtrainer.init_state(jcfg, jax.random.PRNGKey(0))
    jcst = jcgan.init_conditional_gan_state(jcfg, jax.random.PRNGKey(1))
    state = weights.from_jax_train_state(cfg, jax.tree_util.tree_map(np.asarray, jstate),
                                         device="cpu")
    cstate = weights.from_jax_conditional_gan_state(
        cfg, jax.tree_util.tree_map(np.asarray, jcst), device="cpu")
    jsvc = jserver.ModelService(jcfg, state=jstate, cgan_state=jcst)
    svc = ModelService(cfg, state=state, cgan_state=cstate, device="cpu")
    yield jsvc, svc, cfg
    jsvc.close()
    svc.close()


@pytest.fixture(scope="module")
def servers(services):
    """The port's service behind both frontends."""
    _, svc, cfg = services
    out = [Server(svc).start(), AsyncServer(svc).start()]
    yield out, svc, cfg
    out[0].httpd.shutdown()
    out[0].httpd.server_close()
    out[1].stop()


def _u8(cfg, seed):
    return np.random.default_rng(seed).integers(0, 256, (cfg.size, cfg.size, 3), dtype=np.uint8)


# ------------------------------------------------- the device programs


def test_mixed_class_sample_matches_jax_within_one_level(services):
    """A mixed-class device batch (num 3, padded to 4, the pad at class 0)
    against JAX's sample program on the same noise and class vector."""
    jsvc, svc, cfg = services
    init = _replay(svc, (4, cfg.size, cfg.size, 3))
    classes = np.array([2, 0, 1], np.int32)
    got = svc._run_sample(3, classes)
    c = np.zeros((4,), np.int32)
    c[:3] = classes
    want = np.asarray(jsvc._sample(jsvc._params, jnp.asarray(init.numpy()), jnp.asarray(c)))[:3]
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == (3, 16, 16, 3) and diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # a class of each row: row 1 is class 0's, as sample() without a class gives
    init1 = _replay(svc, (1, cfg.size, cfg.size, 3))
    row = svc.sample(1)
    np.testing.assert_array_equal(row, svc._sample_prog(
        svc._model, init1, torch.zeros(1, dtype=torch.int32)).numpy())


def test_stream_and_edit_with_a_class_match_jax(services):
    jsvc, svc, cfg = services
    init = _replay(svc, (1, cfg.size, cfg.size, 3))
    frames = list(svc.sample_stream(1, segments=2, class_idx=2))
    seg = jsampler.make_segment_fn(jsvc.cfg, class_idx=jnp.full((1,), 2, jnp.int32))
    x = e = jnp.asarray(init.numpy())
    for frame, ts in zip(frames, np.array_split(sampler.sample_timesteps(cfg), 2)):
        x, e = seg(jsvc._params, x, e, jnp.asarray(ts))
        _close(frame, np.asarray(x), 1e-4)
    img = np.random.default_rng(3).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    dictionary = jax.random.normal(jax.random.PRNGKey(cfg.seed),
                                   (16, 16, 2**cfg.bits_per_pixel, 3), jnp.float32)
    svc.edit_dictionary = torch.from_numpy(np.array(dictionary))
    try:
        got = svc.edit(img, ("shift", "quantise"), class_idx=1)
    finally:
        svc.edit_dictionary = None
    want = jsvc.edit(img, ("shift", "quantise"), class_idx=1)
    assert list(got) == list(want) == ["quantise", "reconstruction", "shift"]
    for k in want:
        _close(got[k], want[k], 1e-4)


def test_transfer_to_mixed_targets_matches_jax(services):
    jsvc, svc, cfg = services
    imgs = np.random.default_rng(4).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    targets = np.array([1, 2, 0], np.int32)
    got = svc._run_cgan_transfer(imgs, targets)
    want = jsvc._run_cgan_transfer(imgs, targets)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(svc.transfer_to(imgs[:1], 2), jsvc.transfer_to(imgs[:1], 2),
                               atol=1e-5)


def test_mixed_payloads_and_bad_targets_are_caller_errors(services):
    _, svc, _ = services
    seen = []
    b = SampleBatcher(lambda n, classes=None: seen.append(classes) or np.zeros((n, 1)),
                      max_wait_s=0.0)
    try:
        assert b.submit(2, payload=1).shape == (2, 1) and seen[-1].tolist() == [1, 1]
        assert b.submit(1).shape == (1, 1) and seen[-1] is None
        from gan_class_transfer2_tpu_torch.serve.server import _BatchRequest

        with pytest.raises(ValueError, match="mixed class-conditional"):
            b._execute([_BatchRequest(1, 2), _BatchRequest(1, None)])
    finally:
        b.close()
    with pytest.raises(ValueError, match="target must be in"):
        svc.transfer_to(np.zeros((1, 16, 16, 3), np.float32), 3)
    with pytest.raises(ValueError, match=r"class must be in \[0, 3\)"):
        svc.sample(1, class_idx=-1)


# --------------------------------------------- HTTP, on both frontends


def _both(servers, path, body):
    """The answers of both frontends, each on the same generator state."""
    srvs, svc, _ = servers
    state, out = svc._gen.get_state(), []
    for s in srvs:
        svc._gen.set_state(state)
        out.append(_post(s, path, body))
    assert out[0] == out[1], path  # status and bytes
    return out[0]


def test_conditional_sample_and_the_class_guards(servers):
    status, body = _both(servers, "/sample", json.dumps({"num": 1, "class": 2}).encode())
    assert status == 200 and body[:4] == b"\x89PNG"
    status, body = _both(servers, "/sample",
                         json.dumps({"num": 3, "class": 1, "format": "npy"}).encode())
    assert status == 200 and np.load(io.BytesIO(body)).shape == (3, 16, 16, 3)
    status, body = _both(servers, "/sample", json.dumps({"num": 1, "class": 7}).encode())
    assert status == 400 and "class" in json.loads(body)["error"]


def test_conditional_stream_and_edit(servers):
    status, body = _both(servers, "/sample", json.dumps(
        {"num": 1, "stream": True, "segments": 2, "class": 1}).encode())
    assert status == 200 and body.count(b"Content-Type: image/png") == 2
    status, body = _both(servers, "/sample", json.dumps(
        {"num": 1, "stream": True, "class": 9}).encode())
    assert status == 400 and "class" in json.loads(body)["error"]
    srvs, _, cfg = servers
    img = _png(np.zeros((cfg.size, cfg.size, 3), np.uint8))
    status, body = _both(servers, "/edit?edits=shift&class=2", img)
    assert status == 200 and sorted(json.loads(body)) == ["reconstruction", "shift"]
    assert _both(servers, "/edit?edits=shift&class=5", img)[0] == 400


def test_transfer_to_class_and_its_guards(servers):
    srvs, _, cfg = servers
    body = _png(_u8(cfg, 0))
    status, out2 = _both(servers, "/transfer?to=2", body)
    assert status == 200 and out2[:4] == b"\x89PNG"
    status, out1 = _both(servers, "/transfer?to=1", body)
    assert status == 200 and out1 != out2
    status, npy = _both(servers, "/transfer?to=1&format=npy", _npy(_u8(cfg, 1)))
    assert status == 200 and np.load(io.BytesIO(npy)).shape == (1, 16, 16, 3)
    status, err = _both(servers, "/transfer?to=9", body)
    assert status == 400 and "target" in json.loads(err)["error"]
    status, err = _both(servers, "/transfer?direction=ab", body)
    assert status == 400 and "GAN" in json.loads(err)["error"]
    for s in srvs:
        assert json.loads(_get(s, "/healthz")[1])["status"] == "ok"
        assert 'gct2_queue_depth{batcher="transfer_to"} 0' in _get(s, "/metrics")[1].decode()


@pytest.mark.parametrize("frontend", [0, 1], ids=["threaded", "aio"])
def test_mixed_classes_and_targets_coalesce(servers, frontend):
    """Concurrent requests for different classes (/sample) and targets
    (/transfer?to) share one device batch with the right per-sample
    vector; the gate holds the first batch until every request is
    queued."""
    srvs, svc, cfg = servers
    srv = srvs[frontend]
    classes, results = [], [None] * 4
    orig = svc._batcher._run

    def probe(num, c=None):
        classes.append(None if c is None else sorted(c.tolist()))
        return orig(num, c)

    def hit(i):
        results[i] = _post(srv, "/sample", json.dumps({"num": 2, "class": i % 3}).encode())[0]

    svc._batcher._run = probe
    try:
        calls = _gated(svc, svc._batcher, lambda: _threads(4, hit), 8)
    finally:
        svc._batcher._run = orig
    assert results == [200] * 4 and len(calls) <= 2 and sum(calls) == 8
    if len(calls) == 1:
        assert classes == [[0, 0, 0, 0, 1, 1, 2, 2]]

    targets, orig_t = [], svc._cgan_batcher._targeted_run

    def probe_t(imgs, t):
        targets.append(sorted(t.tolist()))
        return orig_t(imgs, t)

    body = _npy(_u8(cfg, 2))
    out = [None] * 3

    def hit_t(i):
        out[i] = _post(srv, f"/transfer?to={i}&format=npy", body)

    svc._cgan_batcher._targeted_run = probe_t
    try:
        calls = _gated(svc, svc._cgan_batcher, lambda: _threads(3, hit_t), 3)
    finally:
        svc._cgan_batcher._targeted_run = orig_t
    assert [o[0] for o in out] == [200] * 3 and len(calls) <= 2 and sum(calls) == 3
    if len(calls) == 1:
        assert targets == [[0, 1, 2]]
    # each answer is its own target's transfer
    for i, (_, b) in enumerate(out):
        want = svc.transfer_to(np.load(io.BytesIO(body)).astype(np.float32)[None] / 128.0 - 1, i)
        got = np.load(io.BytesIO(b)).astype(np.int16)
        assert np.abs(got - np.clip((want * 0.5 + 0.5) * 255, 0, 255).astype(np.int16)).max() <= 1


def test_class_on_an_unconditional_checkpoint_is_refused():
    cfg = tiny_test_config()
    srv = AsyncServer(ModelService(cfg, device="cpu")).start()
    try:
        status, body = _post(srv, "/sample", json.dumps({"num": 1, "class": 0}).encode())
        assert status == 400 and "unconditional" in json.loads(body)["error"]
    finally:
        srv.stop()


# ------------------------------------------------------- reload, build


def _moved(module, by):
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            p.add_(by)
    return out


@pytest.mark.parametrize("model", ["diffusion", "gan", "cgan"])
@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_reload_holds_only_the_serving_modules(tmp_path, model, ema):
    """After a reload (and from the start) the service holds the serving
    modules and the step, no optimizer state, no discriminator and no
    second copy of the weights; the reloaded values are the checkpoint's
    evaluation weights (the EMA when kept)."""
    cfg = tiny_test_config(num_classes=3 if model != "gan" else 0, checkpoint_dir=str(tmp_path),
                           ema_decay=ema, g_norm="instance", d_norm="instance")
    if model == "diffusion":
        st = trainer.init_state(cfg, device="cpu")
    elif model == "gan":
        st = gan.init_gan_state(cfg, device="cpu")
    else:
        st = cgan.init_conditional_gan_state(cfg, device="cpu")
    ckpt_lib.save(str(tmp_path), st._replace(step=1), cfg)
    svc = build_service(cfg, model, device="cpu")
    try:
        if model == "diffusion":
            moved = st._replace(step=2, model=_moved(st.model, 0.1),
                                ema_params=None if st.ema_params is None
                                else [e + 0.2 for e in st.ema_params])
            want = [moved.ema_params if ema else list(moved.model.parameters())]
        elif model == "gan":
            moved = st._replace(step=2, g_ab=_moved(st.g_ab, 0.1), g_ba=_moved(st.g_ba, 0.1),
                                ema_g_ab=st.ema_g_ab and _moved(st.ema_g_ab, 0.2),
                                ema_g_ba=st.ema_g_ba and _moved(st.ema_g_ba, 0.2))
            want = [list(gan.select_generator(moved, d).parameters()) for d in ("ab", "ba")]
        else:
            moved = st._replace(step=2, generator=_moved(st.generator, 0.1),
                                ema_generator=st.ema_generator and _moved(st.ema_generator, 0.2))
            want = [list(cgan.select_generator(moved).parameters())]
        ckpt_lib.save(str(tmp_path), moved, cfg)
        assert svc.reload() == 2
        served = {"diffusion": svc.state, "gan": svc.gan_state, "cgan": svc.cgan_state}[model]
        assert [f for f, v in served._asdict().items() if v is not None] == (
            ["step", "model"] if model == "diffusion" else
            ["step", "g_ab", "g_ba"] if model == "gan" else ["step", "generator"])
        modules = [v for v in served[1:] if v is not None]
        for m, w in zip(modules, want):
            got = list(m.parameters())
            assert len(got) == len(w) and all(torch.equal(a, b) for a, b in zip(got, w))
            assert not any(p.requires_grad for p in got)
        held = {id(p) for m in modules for p in m.parameters()}
        assert len(held) == sum(len(w) for w in want)  # one copy of each served weight
        assert svc.counters["reloads"] == 1
    finally:
        svc.close()


def test_build_and_serve_command_for_cgan(tmp_path, monkeypatch):
    """``build_service(..., "cgan")`` restores the latest checkpoint;
    ``serve --model cgan`` starts (the command's own test drives the
    process in test_torch_serve_http.py)."""
    cfg = tiny_test_config(num_classes=2, checkpoint_dir=str(tmp_path), g_norm="instance")
    st = cgan.init_conditional_gan_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    ckpt_lib.save(str(tmp_path), st._replace(step=5), cfg)
    svc = build_service(cfg, "cgan", device="cpu")
    try:
        assert svc.step == 5
        x = np.zeros((1, 16, 16, 3), np.float32)
        with torch.inference_mode():
            want = cgan.transfer(cfg, st, torch.from_numpy(x), 1).numpy()
        # the batcher's thread may sum in another order: 1e-5, as above
        np.testing.assert_allclose(svc.transfer_to(x, 1), want, atol=1e-5)
    finally:
        svc.close()
    started = threading.Event()
    real = Server.__init__

    def once(self, service, host="127.0.0.1", port=0):
        real(self, service, host, 0)  # a free port; return at once instead of serving
        self.httpd.serve_forever = lambda: started.set() or service.transfer_to(x, 0)

    monkeypatch.setattr(Server, "__init__", once)
    assert cli.main(["serve", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
                     "--model", "cgan"]) == 0
    assert started.is_set()
