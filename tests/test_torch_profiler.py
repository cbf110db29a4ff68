"""Port parity of utils/profiler.py: StepTimer against the JAX package's on
the same lap times, and the torch.profiler capture's kernel rows on the CPU
(no CUDA kernels there, so no rows and no busy time)."""

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
