"""The span readers' helper (``harness/spans.py``) on fabricated records and
on the program's own, and a traced tiny rehearsal of the two cells that
read spans: on the CPU the program records no device time, so the line is
correct and the span metrics are absent."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from conftest import last_json_line

from gan_class_transfer2_tpu_torch.utils import profiler
from perfbench import run as bench_run
from perfbench.harness import spans

NEW = {"fwd_ms.train", "bwd_ms.train", "norm_bwd_ms.gan", "update_ms.gan"}


@pytest.fixture(autouse=True)
def no_spans():
    profiler.reset()
    yield
    profiler.reset()


def _run(units=2):
    return SimpleNamespace(tracer=object(), units=units, device=torch.device("cpu"))


def _rec(name, device_ms, parent=None):
    return {"name": name, "parent": parent, "step": 1, "thread": 1, "start_ns": 0,
            "end_ns": 1, "device_ms": device_ms}


def _fabricated(units, fwd_ms=(3.0, 5.0)):
    recs = []
    for ms in fwd_ms[:units]:
        recs.append(_rec("train.step", 10.0))
        recs.append(_rec("train.forward", ms, parent=len(recs) - 1))
    return recs


def test_the_mean_a_unit_of_fabricated_records(monkeypatch):
    monkeypatch.setattr(profiler, "spans", lambda: _fabricated(2))
    assert spans.per_unit_ms(_run(2), "train.forward", "train.step") == 4.0


@pytest.mark.parametrize("case", ["no records", "units differ", "no traced window",
                                  "no such span", "a program without spans",
                                  "spans past the cap"])
def test_nothing_to_read_reads_none(case, monkeypatch):
    run, name = _run(2), "train.forward"
    if case == "spans past the cap":  # the records read, but one span dropped
        from torch.profiler import ProfilerActivity, profile

        monkeypatch.setattr(profiler, "SPAN_CAP", 0)
        with profile(activities=[ProfilerActivity.CPU]):
            with profiler.annotate("train.forward"):
                pass
        assert profiler.dropped() == 1
        monkeypatch.setattr(profiler, "spans", lambda: _fabricated(2))
    if case == "units differ":
        monkeypatch.setattr(profiler, "spans", lambda: _fabricated(2))
        run.units = 3
    elif case == "no traced window":
        monkeypatch.setattr(profiler, "spans", lambda: _fabricated(2))
        run.tracer = None
    elif case == "no such span":
        monkeypatch.setattr(profiler, "spans", lambda: _fabricated(2))
        name = "train.backward"
    elif case == "a program without spans":
        monkeypatch.delattr(profiler, "spans")
    assert spans.per_unit_ms(run, name, "train.step") is None


def test_the_programs_records_on_the_cpu_read_none():
    """Real records of a capture on the CPU: the steps number the units,
    but no span has device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiler.annotate("train.step", step=True):
                with profiler.annotate("train.forward"):
                    pass
    assert [r["device_ms"] for r in profiler.spans()] == [None] * 4
    assert spans.per_unit_ms(_run(2), "train.forward", "train.step") is None


@pytest.mark.parametrize("cell,step", [("gct2-gan256-train-bf16-b16", "gan.step"),
                                       ("ddpm256-train-bf16-b256", "train.step")])
def test_a_traced_tiny_run_is_correct_and_reads_no_span_metric(tiny_root, cell, step, capsys):
    rc = bench_run.main(["--workload", f"tiny-{cell}", "--seed", str(2**31 + 29), "--seconds",
                         "0.5", "--trace", "1"], root=tiny_root, device="cpu")
    assert rc == 0
    line = last_json_line(capsys.readouterr().out)
    assert line["correct"] is True
    assert not NEW & set(line["metrics"])
    recs = profiler.spans()  # the traced window's steps, and nothing of set-up or the check
    assert sum(r["name"] == step for r in recs) == line["attempted"]
