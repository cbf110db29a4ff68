"""Port parity of utils/profiler.py: StepTimer against the JAX package's on
the same lap times, and the torch.profiler capture's kernel rows on the CPU
(no CUDA kernels there, so no rows and no busy time); ``annotate``'s range
in a capture and ``compiled_stats``' keys and exact FLOP counts (the twins
of tests/test_profiler.py's)."""

import json

import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu.utils import profiler as jprofiler  # noqa: E402
from gan_class_transfer2_tpu_torch.utils import profiler  # noqa: E402


def test_step_timer_summary_matches_jax():
    times = [0.012, 0.010, 0.031, 0.011, 0.013, 0.017, 0.010, 0.020, 0.014, 0.016]
    ours, theirs = profiler.StepTimer(), jprofiler.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert profiler.StepTimer().summary() == {}
    with pytest.raises(RuntimeError, match="before start"):
        profiler.StepTimer().lap(0.0)
    timer = profiler.StepTimer()
    timer.start()
    assert timer.lap(torch.tensor(1.0)) >= 0 and len(timer.times) == 1


def test_trace_writes_a_chrome_trace_and_finds_no_cuda_kernels_on_the_cpu(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    assert profiler.device_ops(prof, top=5) == [] and profiler.device_busy_ms(prof) == 0


def test_annotate_names_a_region_in_the_capture(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("gct2_probe_region"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert any(e.key == "gct2_probe_region" for e in prof.key_averages())
    with open(tmp_path / "trace.json") as fh:
        assert "gct2_probe_region" in fh.read()
    with jprofiler.annotate("gct2_probe_region"):  # the JAX hook takes the same call
        pass


def test_compiled_stats_counts_flops_without_running():
    """JAX's keys; ``(x @ x).sum()`` at 64² is 2·64³ FLOPs; bytes and
    memory are None, as the docstring says; the arguments are not run."""
    import jax.numpy as jnp

    x = torch.ones(64, 64)
    ours = profiler.compiled_stats(lambda a: (a @ a).sum(), x)
    theirs = jprofiler.compiled_stats(lambda a: (a @ a).sum(), jnp.ones((64, 64)))
    assert sorted(ours) == sorted(theirs)
    assert ours == {"flops": 2 * 64 ** 3, "bytes_accessed": None, "memory_mb": None}
    seen = []
    profiler.compiled_stats(lambda a: seen.append(type(a).__name__) or a.sum(), x)
    assert seen == ["FakeTensor"]


@pytest.mark.parametrize("pixel_size, gated", [(64, False), (128, True)],
                         ids=["refused", "gated"])
def test_compiled_stats_of_a_denoiser_forward_is_the_analytic_count(pixel_size, gated):
    """A denoiser forward counts ``model_flops_per_image``·B exactly, the
    same at a width whose down convs B4's gate refuses (cuDNN's convs) and
    at one it admits (B4's custom op, which the counter reads by its
    registered formula), and launches nothing."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.models import api, unet
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv
    from gan_class_transfer2_tpu_torch.utils.benchmark import model_flops_per_image

    cfg = tiny_test_config(pixel_size=pixel_size, max_size=pixel_size, size=32)
    assert fused_down_conv.supported((2, 32, 32, pixel_size),
                                     (4, 4, pixel_size, pixel_size)) == gated
    model = api.init_denoiser(cfg, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    launches = fused_down_conv.down_conv_fused.launches
    stats = profiler.compiled_stats(lambda x: unet.unet_apply(cfg, model, x),
                                    torch.zeros(2, 32, 32, 3))
    assert stats["flops"] == 2 * model_flops_per_image(cfg)
    assert fused_down_conv.down_conv_fused.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


# ----------------------------------------------------------------- spans


@pytest.fixture
def no_spans():
    profiler.reset()
    yield
    profiler.reset()


def _capture(how, tmp_path):
    """A running capture, started as each caller starts one: the operator's
    ``profiler.trace``, a ``with torch.profiler.profile``, and the
    benchmark's ``start()``/``stop()``."""
    from contextlib import contextmanager

    from torch.profiler import ProfilerActivity, profile

    @contextmanager
    def started():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()

    if how == "trace":
        return profiler.trace(str(tmp_path))
    if how == "with":
        return profile(activities=[ProfilerActivity.CPU])
    return started()


def test_a_span_without_a_capture_is_one_shared_context_that_does_nothing(no_spans, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while no capture runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    first = profiler.annotate("train.step", step=True)
    assert first is profiler.annotate("norm.backward")
    for _ in range(3):
        with profiler.annotate("train.step", step=True):
            with profiler.annotate("train.forward"):
                pass
    assert profiler.spans() == [] and profiler.dropped() == 0


@pytest.mark.parametrize("how", ["trace", "with", "start_stop"])
def test_nested_spans_record_name_parent_and_step(no_spans, how, tmp_path):
    with _capture(how, tmp_path):
        for _ in range(2):
            with profiler.annotate("gan.step", step=True):
                with profiler.annotate("gan.g_forward"):
                    with profiler.annotate("norm.backward"):
                        pass
                with profiler.annotate("gan.update"):
                    pass
    with profiler.annotate("train.step", step=True):  # the capture has ended
        pass
    recs = profiler.spans()
    assert [(r["name"], r["parent"], r["step"]) for r in recs] == [
        ("gan.step", None, 1), ("gan.g_forward", 0, 1), ("norm.backward", 1, 1),
        ("gan.update", 0, 1),
        ("gan.step", None, 2), ("gan.g_forward", 4, 2), ("norm.backward", 5, 2),
        ("gan.update", 4, 2)]
    for r in recs:
        assert r["device_ms"] is None and r["thread"] == recs[0]["thread"]
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            outer = recs[r["parent"]]
            assert outer["start_ns"] <= r["start_ns"] and r["end_ns"] <= outer["end_ns"]


def test_trace_starts_with_no_records(no_spans, tmp_path):
    with _capture("with", tmp_path):
        with profiler.annotate("train.step", step=True):
            pass
    with profiler.trace(str(tmp_path)):
        assert profiler.spans() == []
        with profiler.annotate("train.step", step=True):
            pass
    assert [(r["name"], r["step"]) for r in profiler.spans()] == [("train.step", 1)]


def test_a_span_starts_on_the_captures_clock(no_spans, tmp_path):
    """The host stamps are ``time.time_ns()``; the capture's range of each
    span starts within 1 ms of them, so spans and device events share a
    clock. (A process's first range also pays the profiler's one-time
    set-up, up to a millisecond here: one span takes it first.)"""
    with _capture("start_stop", tmp_path) as prof:
        with profiler.annotate("gct2_clock_first"):
            pass
        for i in range(5):
            with profiler.annotate(f"gct2_clock_{i}"):
                torch.ones(8).sum()
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gct2_clock_")}
    recs = profiler.spans()[1:]
    assert len(recs) == 5
    for r in recs:
        assert abs(starts[r["name"]] - r["start_ns"]) < 1_000_000


def test_a_norm_backward_on_another_thread_carries_the_step_of_its_gan_step(no_spans, tmp_path):
    """On a card autograd runs the backward on a device thread of its own;
    a thread that runs B3's backward while a ``gan.step`` is open stands for
    it here. Its parent is the span open on the step's thread, as it would
    be had the backward run there (as it does on the CPU)."""
    import threading

    from gan_class_transfer2_tpu_torch.ops import norm

    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    gamma, beta = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    done = []

    def backward():
        torch.autograd.grad(norm.instance_norm(x, gamma, beta).square().sum(), (x, gamma))
        done.append(threading.get_ident())

    with _capture("with", tmp_path):
        for _ in range(2):
            with profiler.annotate("gan.step", step=True):
                t = threading.Thread(target=backward)
                t.start()
                t.join(timeout=60)
                assert not t.is_alive()
    recs = profiler.spans()
    steps = [r for r in recs if r["name"] == "gan.step"]
    bwd = [r for r in recs if r["name"] == "norm.backward"]
    assert [r["step"] for r in bwd] == [r["step"] for r in steps] == [1, 2]
    assert [r["thread"] for r in bwd] == done and steps[0]["thread"] not in done
    assert [r["parent"] for r in bwd] == [recs.index(r) for r in steps]  # as on one thread


def test_spans_past_the_cap_are_counted(no_spans, monkeypatch, tmp_path):
    monkeypatch.setattr(profiler, "SPAN_CAP", 3)
    with _capture("with", tmp_path):
        for _ in range(5):
            with profiler.annotate("train.forward"):
                pass
    assert len(profiler.spans()) == 3 and profiler.dropped() == 2
    profiler.reset()
    assert profiler.spans() == [] and profiler.dropped() == 0


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        assert stream is not None  # the span's stream, passed, not looked up again
        self.t = stream.clock = stream.clock + 1.0

    def elapsed_time(self, end):
        return end.t - self.t


def test_a_span_reuses_the_events_of_records_read(no_spans, monkeypatch, tmp_path):
    """With CUDA in use, a span records a pair of events on the current
    stream; the pairs of records that ``spans`` has read, or ``reset`` has
    dropped, go to later spans on the same card instead of new ones."""
    from types import SimpleNamespace

    streams = {0: SimpleNamespace(device_index=0, clock=0.0),
               1: SimpleNamespace(device_index=1, clock=0.0)}
    card = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: streams[card[0]])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)

    def two_steps():
        with _capture("with", tmp_path):
            for _ in range(2):
                with profiler.annotate("train.step", step=True):
                    with profiler.annotate("train.forward"):
                        pass

    two_steps()
    assert _FakeEvent.made == 8
    assert [r["device_ms"] for r in profiler.spans()] == [3.0, 1.0, 3.0, 1.0]
    profiler.reset()
    two_steps()
    assert _FakeEvent.made == 8  # the four pairs read
    profiler.reset()  # unread: their pairs are free again too
    card[0] = 1
    two_steps()
    assert _FakeEvent.made == 16  # another card's stream: pairs of its own
    assert [r["device_ms"] for r in profiler.spans()] == [3.0, 1.0, 3.0, 1.0]


SPANS_A_STEP = {
    "diffusion": {"train.step": 1, "train.augment": 1, "train.forward": 1,
                  "train.backward": 1, "train.update": 1},
    "gan": {"gan.step": 1, "gan.g_forward": 1, "gan.g_backward": 1, "gan.d_forward": 1,
            "gan.d_backward": 1, "gan.update": 1},
}


@pytest.mark.parametrize("model", ["diffusion", "gan"])
def test_a_tiny_step_records_each_span_of_the_table(no_spans, model, monkeypatch, tmp_path):
    """Two steps under a capture on the CPU: each span a step once, and
    ``norm.backward`` once a B3 backward (the GAN's instance norms)."""
    from collections import Counter

    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.train import gan, trainer

    calls = []
    plain = norm._in_bwd
    monkeypatch.setattr(norm, "_in_bwd", lambda *a: calls.append(1) or plain(*a))
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(2, 16, 16, 3) * 2 - 1
    if model == "gan":
        cfg = tiny_test_config(g_norm="instance", d_norm="instance", batch_size=2)
        state, fn = gan.init_gan_state(cfg, gen, device="cpu"), gan.make_gan_train_step(cfg)

        def step(s):
            return fn(s, x, x.flip(1), gen)[0]
    else:
        cfg = tiny_test_config(batch_size=2)
        state, fn = trainer.init_state(cfg, gen, device="cpu"), trainer.make_train_step(cfg)

        def step(s):
            return fn(s, x, gen)[0]

    state = step(state)  # outside the capture: nothing recorded
    assert profiler.spans() == []
    calls.clear()
    with _capture("with", tmp_path):
        for _ in range(2):
            state = step(state)
    got = Counter(r["name"] for r in profiler.spans())
    want = {k: 2 * v for k, v in SPANS_A_STEP[model].items()}
    if model == "gan":
        assert len(calls) > 0
        want["norm.backward"] = len(calls)
    assert got == want


@pytest.mark.parametrize("device_ms", [None, 1.5])
def test_span_table_takes_child_spans_out_of_self_time(device_ms):
    ms = 1_000_000
    recs = [{"name": "s", "parent": None, "start_ns": 0, "end_ns": 10 * ms},
            {"name": "a", "parent": 0, "start_ns": 1 * ms, "end_ns": 4 * ms},
            {"name": "b", "parent": 1, "start_ns": 2 * ms, "end_ns": 3 * ms},
            {"name": "a", "parent": 0, "start_ns": 5 * ms, "end_ns": 9 * ms}]
    for r in recs:
        r["device_ms"] = device_ms
    rows = {r["span"]: r for r in profiler.span_table(recs, steps=2)}
    assert list(rows) == ["s", "a", "b"]
    assert rows["s"]["calls_per_step"] == 0.5 and rows["a"]["calls_per_step"] == 1.0
    assert rows["s"]["host_ms_per_step"] == 5.0 and rows["s"]["self_host_ms_per_step"] == 1.5
    assert rows["a"]["host_ms_per_step"] == 3.5 and rows["a"]["self_host_ms_per_step"] == 3.0
    assert rows["b"]["self_host_ms_per_step"] == 0.5
    assert rows["a"]["device_ms_per_step"] == device_ms  # two calls over two steps


class _Event:
    def __init__(self, start, end, name, cuda=True, annotation=False):
        self.s, self.e, self.n, self.cuda, self.annotation = start, end, name, cuda, annotation

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def name(self):
        return self.n

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self.cuda else dt.CPU

    def is_user_annotation(self):
        return self.annotation


def test_device_busy_ms_is_the_union_of_the_device_operations():
    """Two streams overlapping count once; a marked range projected onto
    the card is no operation; host events are not device time."""
    from types import SimpleNamespace

    ms = 1_000_000
    events = [_Event(0, 4 * ms, "gemm"), _Event(2 * ms, 6 * ms, "ncclAllReduce"),
              _Event(8 * ms, 9 * ms, "add"), _Event(0, 20 * ms, "train.step", cuda=False,
                                                   annotation=True),
              _Event(0, 20 * ms, "train.step"), _Event(0, 30 * ms, "aten::add", cuda=False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert profiler.device_busy_ms(prof) == 7.0
    assert profiler.union_ns([(5, 7), (0, 2), (1, 3), (6, 6)]) == 5


@pytest.mark.parametrize("model", ["diffusion", "gan"])
def test_cli_profile_prints_a_row_a_span(model, tmp_path, capsys):
    from gan_class_transfer2_tpu_torch import cli

    args = ["profile", "--device", "cpu", "--model", model, "--size", "16", "--pixel-size", "4",
            "--max-size", "8", "--octaves", "2", "--batch-size", "2", "--steps", "10",
            "--profile-steps", "2", "--trace-dir", str(tmp_path / "trace")]
    if model == "gan":
        args += ["--g-norm", "instance", "--d-norm", "instance"]
    assert cli.main(args) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    rows = {r["span"]: r for r in lines if "span" in r}
    assert set(lines[-1]) >= {"command", "device_busy_ms_per_step"}
    want = dict(SPANS_A_STEP[model])
    if model == "gan":
        assert rows.pop("norm.backward")["calls_per_step"] > 0
    assert {k: r["calls_per_step"] for k, r in rows.items()} == want
    for r in rows.values():
        assert r["device_ms_per_step"] is None  # no CUDA events on the CPU
        assert 0 <= r["self_host_ms_per_step"] <= r["host_ms_per_step"]
    top = "gan.step" if model == "gan" else "train.step"
    assert rows[top]["host_ms_per_step"] >= max(r["host_ms_per_step"] for r in rows.values())
    assert lines[-1]["span_dropped"] == 0


def test_cli_profile_counts_the_spans_past_the_cap(monkeypatch, tmp_path, capsys):
    """Past the record cap the span rows read low, and the summary line
    says by how many spans."""
    from gan_class_transfer2_tpu_torch import cli

    monkeypatch.setattr(profiler, "SPAN_CAP", 3)
    assert cli.main(["profile", "--device", "cpu", "--model", "diffusion", "--size", "16",
                     "--pixel-size", "4", "--max-size", "8", "--octaves", "2", "--batch-size",
                     "2", "--steps", "10", "--profile-steps", "2", "--trace-dir",
                     str(tmp_path / "trace")]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert sum(r["calls_per_step"] for r in lines if "span" in r) == 3 / 2
    assert lines[-1]["span_dropped"] == 2 * len(SPANS_A_STEP["diffusion"]) - 3
