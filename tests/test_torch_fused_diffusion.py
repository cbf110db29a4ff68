"""B1, fused forward diffusion: the plain version of the port's kernel
(ops/fused_diffusion.py) on the CPU, and its gate against the JAX step's.

The kernel's random stream is Philox4x32-10, not the TPU's PRNG, so it is
held to Philox's published known answers and to the statistics of N(0, 1);
bit parity with the JAX package is a matter for the unfused path with
injected ε (test_torch_trainer.py). Bounds for the statistics at N = 4·10⁵
draws: the mean within 5σ = 5/√N ≈ 0.008, the standard deviation within
5·(1/√(2N)) ≈ 0.006 of 1, correlations within 5/√N.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.train import trainer as jtrainer  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd  # noqa: E402

torch.set_num_threads(1)
N = 100_000  # per sample; 4 samples


def _seed(s):
    return torch.tensor([s], dtype=torch.int64)


def _t(*v):
    return tuple(torch.tensor(x, dtype=torch.int64) for x in v)


def _scales(ss, sn):
    """(t, table) with table[t[b]] = (ss[b], sn[b]): one row per sample."""
    return torch.arange(len(ss), dtype=torch.int32), torch.stack([ss, sn], 1)


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = fd.philox4x32_10(_t(*counter), _t(*key))
    assert tuple(int(w) for w in got) == want


def test_philox_is_vectorised_over_counters():
    c = torch.tensor([0, 0x243F6A88], dtype=torch.int64)
    words = fd.philox4x32_10((c, c * 0 + torch.tensor([0, 0x85A308D3]),
                              c * 0 + torch.tensor([0, 0x13198A2E]),
                              c * 0 + torch.tensor([0, 0x03707344])),
                             (torch.tensor([0, 0xA4093822]), torch.tensor([0, 0x299F31D0])))
    assert [int(w[1]) for w in words] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    assert [int(w[0]) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_normal_from_words_is_the_jax_box_muller():
    """The float arithmetic of kernels.py:31-41 on the same 32-bit words
    (without the TPU bitcasts): u1 offset by 2^-25, r·cos(2π·u2)."""
    r = np.random.default_rng(0)
    a = r.integers(0, 2**32, 1000, dtype=np.uint64)
    b = r.integers(0, 2**32, 1000, dtype=np.uint64)
    u1 = (a >> 8).astype(np.float32) * np.float32(2**-24) + np.float32(2**-25)
    u2 = (b >> 8).astype(np.float32) * np.float32(2**-24)
    want = np.sqrt(-2 * np.log(u1)) * np.cos(np.float32(6.283185307179586) * u2)
    got = fd.normal_from_words(torch.from_numpy(a.astype(np.int64)),
                               torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_zero_noise_scale_gives_x_times_ss_exactly():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 384)).astype(np.float32))
    ss = torch.tensor([0.5, 0.25, 0.7], dtype=torch.float32)
    out = fd.diffuse_fused(x, *_scales(ss, torch.zeros(3)), _seed(7))
    assert torch.equal(out, x * ss[:, None])


def test_zero_signal_scale_gives_standard_normals():
    x = torch.full((4, N), 3.0)
    eps = fd.diffuse_fused(x, *_scales(torch.zeros(4), torch.ones(4)), _seed(12345)).double()
    assert abs(eps.mean().item()) < 5 / (4 * N) ** 0.5
    assert abs(eps.std().item() - 1) < 5 / (2 * 4 * N) ** 0.5
    kurt = ((eps - eps.mean()) ** 4).mean().item() / eps.var().item() ** 2
    assert abs(kurt - 3) < 0.05  # sd of the sample kurtosis ≈ √(24/4e5) ≈ 0.008
    frac = (eps.abs() < 1).double().mean().item()  # P(|ε| < 1) = 0.6827
    assert abs(frac - 0.6827) < 5 * (0.6827 * 0.3173 / (4 * N)) ** 0.5


def test_same_seed_same_noise_other_seeds_and_samples_decorrelated():
    x = torch.zeros((2, N))
    noise = _scales(torch.zeros(2), torch.ones(2))
    a = fd.diffuse_fused(x, *noise, _seed(1))
    assert torch.equal(a, fd.diffuse_fused(x, *noise, _seed(1)))
    b = fd.diffuse_fused(x, *noise, _seed(2))
    c = fd.diffuse_fused(x, *noise, _seed(1 << 40))  # the seed's high word keys too
    bound = 5 / N**0.5
    for u, v in ((a[0], b[0]), (a[0], c[0]), (a[0], a[1]), (a[0, :-1], a[0, 1:])):
        assert abs(torch.corrcoef(torch.stack([u, v]))[0, 1].item()) < bound


def test_layout_of_the_stream():
    """Element 4g + 2·half + j takes words (2j, 2j+1) of the Philox block
    at counter (g, sample, half, 0), keyed by the seed's two words."""
    seed = (5 << 32) | 9
    eps = fd.philox_normal(2, 8, _seed(seed), "cpu")
    w = fd.philox4x32_10(_t(1, 1, 1, 0), _t(9, 5))  # g=1, sample 1, half 1
    want = fd.normal_from_words(torch.stack([w[0], w[2]]), torch.stack([w[1], w[3]]))
    torch.testing.assert_close(eps[1, 6:8], want, rtol=0, atol=0)


def test_gradient_is_g_times_ss():
    x = torch.randn((2, 256), generator=torch.Generator().manual_seed(0), requires_grad=True)
    ss = torch.tensor([0.3, 0.9])
    t, table = _scales(ss, torch.tensor([0.5, 0.1]))
    out = fd.FusedDiffuse.apply(x, t.flip(0), table.flip(0), _seed(3))  # a gather that moves rows
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, x, g)
    torch.testing.assert_close(dx, g * ss[:, None], rtol=0, atol=0)
    # forward_diffuse_fused keeps the gradient for an x that asks for one
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(fused_diffusion=True)
    x4 = x.detach().reshape(2, 16, 16, 1).requires_grad_()
    steps = torch.tensor([3, 8], dtype=torch.int32)
    out = fd.forward_diffuse_fused(cfg, x4, steps, _seed(3))
    (dx,) = torch.autograd.grad(out, x4, torch.ones_like(out))
    want = fd.scale_table(cfg.steps, cfg.schedule, "cpu")[steps.long(), 0]
    torch.testing.assert_close(dx, want.reshape(2, 1, 1, 1).expand_as(x4), rtol=0, atol=0)


def test_cpu_wrapper_launches_nothing():
    before = fd.diffuse_fused.launches
    fd.diffuse_fused(torch.zeros((1, 128)), *_scales(torch.ones(1), torch.ones(1)), _seed(0))
    assert fd.diffuse_fused.launches == before == 0


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fd.diffuse_fused(x, torch.empty(1, dtype=torch.int32, device="meta"),
                         torch.empty((3, 2), device="meta"),
                         torch.empty(1, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("overrides, shape, injected", [
    (dict(), (2, 16, 16, 3), False),  # 768 = 6·128
    (dict(), (2, 16, 16, 3), True),  # ε injected
    (dict(fused_diffusion=False), (2, 16, 16, 3), False),
    (dict(parameterization="epsilon"), (2, 16, 16, 3), False),
    (dict(parameterization="ode"), (2, 16, 16, 3), False),
    (dict(), (2, 8, 8, 3), False),  # 192: not a multiple of 128
    (dict(size=8, octaves=1), (1, 8, 8, 3), False),
])
def test_gate_matches_the_jax_step(monkeypatch, overrides, shape, injected):
    """The port's use_fused against trainer.py:289-296 run as on a TPU
    (default_backend() == "tpu"), observed through whether the JAX step
    calls its fused kernel."""
    from gan_class_transfer2_tpu.ops import kernels

    called = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(kernels, "forward_diffuse_fused",
                        lambda cfg, x, t, rng: called.append(True) or x)
    jcfg = jconfig.tiny_test_config(**overrides)
    eps = np.zeros(shape, np.float32) if injected else None
    jtrainer.draw_and_diffuse(jcfg, jnp.zeros(shape), jax.random.PRNGKey(0), epsilon_in=eps)
    cfg = Config.from_json(jcfg.to_json())
    assert fd.use_fused(cfg, shape, eps) == bool(called)


def test_fused_step_noises_with_the_kernel_stream():
    """forward_diffuse_fused on the trainer's scales: x·√ᾱ(t) + ε·√(1−ᾱ(t))
    with ε the Philox stream of the seed."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.core.schedule import alpha_dash

    cfg = tiny_test_config(fused_diffusion=True)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    t = torch.tensor([3, 8], dtype=torch.int32).reshape(2, 1, 1, 1)
    out = fd.forward_diffuse_fused(cfg, x, t, _seed(11))
    ad = alpha_dash(t.reshape(2).to(torch.float32), cfg.steps, cfg.schedule)
    eps = fd.philox_normal(2, 768, _seed(11), "cpu").reshape(x.shape)
    want = x * ad.sqrt().reshape(2, 1, 1, 1) + eps * (1 - ad).sqrt().reshape(2, 1, 1, 1)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


SCHEDULES = ("quadratic", "exponential", "rational_exponential", "geometric", "cosine2",
             "quartic")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_scale_table_is_the_steps_own_scales_bit_for_bit(schedule):
    """Row t of the table equals what the step computed from t before the
    table existed, sqrt(alpha_dash(t)) and sqrt(1 − alpha_dash(t)) on float32
    t, bit for bit, for every t in 0 … steps; one table per (steps,
    schedule, device)."""
    from gan_class_transfer2_tpu_torch.core.schedule import alpha_dash

    steps = 200
    table = fd.scale_table(steps, schedule, "cpu")
    assert table.shape == (steps + 1, 2) and table.dtype == torch.float32
    t = torch.arange(steps + 1, dtype=torch.int32).reshape(-1, 1, 1, 1).to(torch.float32)
    ad = alpha_dash(t.reshape(-1), steps, schedule).to(torch.float32)
    assert torch.equal(table[:, 0], torch.sqrt(ad))
    assert torch.equal(table[:, 1], torch.sqrt(1.0 - ad))
    assert fd.scale_table(steps, schedule, torch.device("cpu")) is table
    assert fd.scale_table(10, schedule, "cpu").shape == (11, 2)


def test_plain_version_gathers_its_scales_by_t():
    """diffuse_plain(x, t, table) is x·table[t, 0] + ε·table[t, 1] with the
    kernel's ε, for any order of t; a t past the table raises on the CPU
    (the kernel writes NaN there)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 256)).astype(np.float32))
    table = torch.tensor([[0.9, 0.1], [0.5, 0.8], [0.2, 0.95]])
    t = torch.tensor([2, 0, 2], dtype=torch.int32)
    eps = fd.philox_normal(3, 256, _seed(4), "cpu")
    want = x * table[t.long(), :1] + eps * table[t.long(), 1:]
    assert torch.equal(fd.diffuse_plain(x, t, table, _seed(4)), want)
    with pytest.raises(IndexError):
        fd.diffuse_plain(x, torch.tensor([0, 1, 3], dtype=torch.int32), table, _seed(4))


def test_fused_prologue_is_two_draws_and_one_kernel_call(monkeypatch):
    """On the fused path the step's noising is the draw of t, the draw of
    B1's seed and one B1 call: the scales come from the cached table, so
    alpha_dash is not evaluated again once the table exists, and the x
    target needs no ᾱ(t)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.core import diffusion
    from gan_class_transfer2_tpu_torch.train import trainer

    cfg = tiny_test_config(fused_diffusion=True)
    batch = torch.zeros((2, 16, 16, 3))
    trainer.draw_and_diffuse(cfg, batch, torch.Generator().manual_seed(0))  # builds the table
    calls = {"alpha_dash": 0, "diffuse_fused": 0, "randint": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(fd, "alpha_dash", counted("alpha_dash", fd.alpha_dash))
    monkeypatch.setattr(diffusion, "_ad", counted("alpha_dash", diffusion._ad))
    monkeypatch.setattr(fd, "diffuse_fused", counted("diffuse_fused", fd.diffuse_fused))
    monkeypatch.setattr(torch, "randint", counted("randint", torch.randint))
    noised, target, scale, t_int = trainer.draw_and_diffuse(cfg, batch,
                                                            torch.Generator().manual_seed(0))
    assert calls == {"alpha_dash": 0, "diffuse_fused": 1, "randint": 2}
    assert target is batch and scale == 1.0 and t_int.dtype == torch.int32
