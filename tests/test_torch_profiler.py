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


@pytest.mark.parametrize("conv_impl", ["lax", "pallas"])
def test_compiled_stats_of_a_denoiser_forward_is_the_analytic_count(conv_impl):
    """A denoiser forward counts ``model_flops_per_image``·B exactly, the
    same through cuDNN's convs and through B4 (whose custom op the counter
    reads by its registered formula), and launches nothing."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.models import api, unet
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv
    from gan_class_transfer2_tpu_torch.utils.benchmark import model_flops_per_image

    cfg = tiny_test_config(conv_impl=conv_impl, pixel_size=128, max_size=128, size=32)
    model = api.init_denoiser(cfg, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    launches = fused_down_conv.down_conv_fused.launches
    stats = profiler.compiled_stats(lambda x: unet.unet_apply(cfg, model, x),
                                    torch.zeros(2, 32, 32, 3))
    assert stats["flops"] == 2 * model_flops_per_image(cfg)
    assert fused_down_conv.down_conv_fused.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
