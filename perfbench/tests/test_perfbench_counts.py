"""The yardstick against hand counts: the FLOP counter on the reference, the
analytic count, and each kernel's operations and bytes, summed over the
calls a unit makes, against the bounds PERF.md's kernel table states."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT

from perfbench.harness import counts
from perfbench.reference import model as M


def _cfg(name, **kw):
    return SimpleNamespace(**{**json.loads((ROOT / f"perfbench/configs/{name}.json").read_text()),
                              **kw})


DDPM = _cfg("ddpm-unet256")
GAN = _cfg("gct2-gan256")
H100_BYTES, H100_BF16 = 3.35e12, 989e12


def _forward_calls(cfg, batch, norm=False):
    rec = M.Recorder()
    sh = M.denoiser_shapes(cfg, normed=norm)

    def fwd(x, *leaves):
        with torch.no_grad():
            M.denoiser(cfg, dict(zip(sh, leaves)), x, rec=rec, norm=norm)

    flops = counts.count_flops(fwd, torch.zeros(batch, 3, cfg.size, cfg.size),
                               *[torch.zeros(s) for s in sh.values()])
    return flops, rec


def test_analytic_forward_count_at_config():
    assert counts.model_flops_per_image(DDPM) == 42_908_909_568


def test_counter_on_the_reference_matches_the_analytic_count():
    flops, _ = _forward_calls(DDPM, 1)
    assert flops == 42_908_909_568


def test_hand_count_of_a_tiny_denoiser():
    cfg = SimpleNamespace(**{**vars(DDPM), "size": 8, "pixel_size": 2, "max_size": 4,
                             "octaves": 2})
    # multiply-adds: down 8→4 16·16·3·2, down 4→2 4·16·2·4; up 2→4 4·16·4·2,
    # up 4→8 16·16·(2+2)·1; head 64·(1+3)·3; then ×2
    macs = 16 * 16 * 3 * 2 + 4 * 16 * 2 * 4 + 4 * 16 * 4 * 2 + 16 * 16 * 4 * 1 + 64 * 4 * 3
    assert counts.model_flops_per_image(cfg) == 2 * macs
    assert _forward_calls(cfg, 1)[0] == 2 * macs


def test_train_step_count_is_three_forwards_less_the_first_input_gradient():
    sh = M.denoiser_shapes(DDPM)

    def step(x, *leaves):
        p = M.denoiser(DDPM, dict(zip(sh, leaves)), x)
        torch.autograd.grad(((p - x) ** 2).mean(), leaves)

    got = counts.count_flops(step, torch.zeros(1, 3, 256, 256),
                             *[torch.zeros(s, requires_grad=True) for s in sh.values()])
    first = 2 * 128 * 128 * 16 * 3 * 128  # the first down conv's input gradient, not taken
    assert got == 3 * 42_908_909_568 - first


def test_b4_least_time_at_the_sampler_batch():
    from importlib import util

    spec = util.spec_from_file_location("b4", ROOT / "perfbench/metrics/b4_roofline.sample.py")
    b4 = util.module_from_spec(spec)
    spec.loader.exec_module(b4)
    _, rec = _forward_calls(DDPM, 16)
    served = [c for c in rec if c[0] == "down_conv" and b4.served(c[1], c[2])]
    assert len(served) == 4
    least = sum(counts.least_seconds(*counts.down_conv(c[1], c[2], "bfloat16"), H100_BF16,
                                     H100_BYTES) for c in served)
    assert least * 1e3 == pytest.approx(0.1824, abs=5e-5)  # PERF.md: 0.1824 ms (operations)


def test_b3_least_time_over_a_gan_step():
    """102 norms a G/D step: 6 generator passes × 12 and 6 discriminator
    passes × 5; bytes-bound at 1.5608 ms in bf16 (PERF.md)."""
    g = [c for c in _forward_calls(GAN, 16, norm=True)[1] if c[0] == "instance_norm"]
    sh = M.discriminator_shapes(GAN)
    rec = M.Recorder()

    def disc(x, *leaves):
        with torch.no_grad():
            M.discriminator(GAN, dict(zip(sh, leaves)), x, rec=rec)

    counts.count_flops(disc, torch.zeros(16, 3, 256, 256), *[torch.zeros(s) for s in sh.values()])
    d = [c for c in rec if c[0] == "instance_norm"]
    assert len(g) == 12 and len(d) == 5
    calls = g * 6 + d * 6
    least = sum(counts.least_seconds(*counts.instance_norm(c[1], "bfloat16"), 67e12, H100_BYTES)
                for c in calls)
    assert least * 1e3 == pytest.approx(1.5608, abs=2e-3)


def test_b2_least_time_of_one_update():
    numel = sum(torch.Size(s).numel() for s in M.denoiser_shapes(DDPM).values())
    assert numel == 41_691_660
    ops, nbytes = counts.adam(numel)
    assert nbytes == 28 * numel
    assert counts.least_seconds(ops, nbytes, 67e12, H100_BYTES) * 1e3 == pytest.approx(
        0.3485, abs=5e-4)
