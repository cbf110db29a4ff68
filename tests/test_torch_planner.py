"""Port parity of the parallelism planner (gan_class_transfer2_tpu_torch
.parallel.planner, ``cli plan``): the analytic functions equal JAX's
(integers, exactly) on several configs; parameter and GAN-state bytes from
modules built on ``meta`` equal JAX's ``eval_shape`` totals; the TP and
ZeRO-1 bytes follow the port's runtime rules (``parallel/mesh``), the gap
to JAX's named; the throughput model reproduces every H100 grid point;
``cli plan --json`` has JAX's keys and the table prints. The measured
constants themselves (H100, tools/bench_grid_torch.py) differ from JAX's
TPU ones by design, so quantities that depend on them are compared in
form, not value."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gan_class_transfer2_tpu import config as jconfig  # noqa: E402
from gan_class_transfer2_tpu.parallel import pipeline as jpp  # noqa: E402
from gan_class_transfer2_tpu.parallel import planner as jplanner  # noqa: E402
from gan_class_transfer2_tpu_torch import cli  # noqa: E402
from gan_class_transfer2_tpu_torch.config import Config  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import pipeline as pp  # noqa: E402
from gan_class_transfer2_tpu_torch.parallel import planner  # noqa: E402

CONFIGS = [dict(), dict(size=64, octaves=4, ema_decay=0.9),
           dict(size=32, octaves=3, block_depth=1, skip_mode="residual"),
           dict(size=128, octaves=5, pixel_size=64, max_size=256, block_depth=2,
                compute_dtype="bfloat16")]


def _pair(**kw):
    return Config(**kw).validate(), jconfig.Config(**kw).validate()


@pytest.mark.parametrize("kw", CONFIGS)
def test_analytic_functions_equal_jax(kw):
    cfg, jcfg = _pair(**kw)
    assert planner.conv_macs(cfg) == jplanner.conv_macs(jcfg)
    assert planner.act_elems_per_image(cfg) == jplanner.act_elems_per_image(jcfg)
    for s in range(2, cfg.octaves + 1):
        plan = pp.plan_stages(cfg, s)
        assert plan == jpp.plan_stages(jcfg, s)
        work = planner.stage_work(cfg, plan)
        assert work == jplanner.stage_work(jcfg, plan)
        for mb in (1, 3, 8):
            assert planner.boundary_bytes(cfg, plan, mb) == jplanner.boundary_bytes(jcfg, plan, mb)
        for m in (1, 2, 4, 16):
            assert planner.pp_times(work, m) == jplanner.pp_times(work, m)
        for st in range(s):
            assert planner.pp_stage_act_elems(cfg, plan, st) == \
                jplanner.pp_stage_act_elems(jcfg, plan, st)
    for model in ("gan", "cgan"):
        assert planner._gan_generator_passes(cfg, model) == \
            jplanner._gan_generator_passes(jcfg, model)
    for args in ((1000, 250), (4096, 1024.0)):
        for kw2 in (dict(), dict(zero1_data=4, moment_dtype="bfloat16"), dict(ema=True),
                    dict(moment_bytes_chip=77)):
            assert planner.model_state_bytes_per_chip(*args, **kw2) == \
                jplanner.model_state_bytes_per_chip(*args, **kw2)


@pytest.mark.parametrize("kw", CONFIGS)
def test_meta_bytes_equal_jax_eval_shape(kw):
    cfg, jcfg = _pair(**kw)
    tree = planner.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in tree.parameters())
    assert planner.param_bytes(tree) == jplanner.param_bytes(jplanner.abstract_params(jcfg))
    state, jstate = planner._abstract_gan_state(cfg, "gan"), jplanner._abstract_gan_state(jcfg,
                                                                                          "gan")
    assert planner.param_bytes(state) == jplanner.param_bytes(jstate)
    for f in ("g_opt", "d_opt", "g_ab", "d_a"):
        assert planner.param_bytes(getattr(state, f)) == jplanner.param_bytes(getattr(jstate, f))
    cfg3, jcfg3 = _pair(**kw, num_classes=3)
    assert planner.param_bytes(planner._abstract_gan_state(cfg3, "cgan")) == \
        jplanner.param_bytes(jplanner._abstract_gan_state(jcfg3, "cgan"))


def _runtime_bytes(tree, spec_fn, sizes, itemsize=None):
    total = 0
    for p in tree.parameters():
        n = p.numel() * (itemsize or p.element_size())
        total += n // planner._spec_divisor(spec_fn(p), sizes)
    return total


@pytest.mark.parametrize("kw", CONFIGS[:3])
def test_tp_and_zero1_bytes_follow_the_port_runtime_rules(kw):
    cfg, jcfg = _pair(**kw)
    tree, jtree = planner.abstract_params(cfg), jplanner.abstract_params(jcfg)
    for m in (2, 4, 8):
        # the port's rule is JAX's for TP: the bytes agree
        assert planner.tp_param_bytes_per_chip(tree, m) == \
            _runtime_bytes(tree, lambda p: mesh_lib._leaf_spec(p, m), {"model": m})
        assert planner.tp_param_bytes_per_chip(tree, m) == jplanner.tp_param_bytes_per_chip(jtree,
                                                                                          m)
    for data, model in ((2, 1), (8, 1), (2, 2), (4, 2), (2, 4)):
        fake = planner._AbstractMesh({"data": data, "model": model})
        sizes = {"data": data, "model": model}
        got = planner.zero1_moment_bytes_per_chip(tree, data, model, "float32")
        assert got == 2 * _runtime_bytes(tree, lambda p: mesh_lib._zero1_spec(p, fake), sizes, 4)
        want = jplanner.zero1_moment_bytes_per_chip(jtree, data, model, "float32")
        if model == 1:
            assert got == want  # no TP: the two rules agree
    # the named gap (ROADMAP Queue C): a kernel TP splits whose last axis does
    # not divide by data·model stays on 'model' in the port (a rank updates
    # only what it holds) where JAX moves it to 'data': at data 4 × model 2 a
    # 12-wide kernel is split 2 ways here and 4 ways in JAX, at data 2 ×
    # model 4 4 ways here and 2 in JAX
    kw = dict(size=16, octaves=2, pixel_size=12, max_size=24)
    t, jt = planner.abstract_params(Config(**kw)), jplanner.abstract_params(jconfig.Config(**kw))
    k = t.octaves[0].down.kernel
    assert k.shape[-1] == 12
    for data, model, port_ways, jax_ways in ((4, 2, 2, 4), (2, 4, 4, 2)):
        fake = planner._AbstractMesh({"data": data, "model": model})
        spec = mesh_lib._zero1_spec(k, fake)
        assert spec == (None, None, None, "model")
        assert planner._spec_divisor(spec, fake.shape) == port_ways != jax_ways
        got = planner.zero1_moment_bytes_per_chip(t, data, model, "float32")
        want = jplanner.zero1_moment_bytes_per_chip(jt, data, model, "float32")
        assert (got > want) == (port_ways < jax_ways)


def test_throughput_model_reproduces_every_h100_grid_point():
    for dtype, grid in planner.MEASURED_GRID.items():
        assert set(grid) == {64, 128, 256, 512, 1024}
        for size, ladder in grid.items():
            for batch, ips in ladder:
                cfg = Config(size=size, octaves=4 if size == 64 else 6, batch_size=batch,
                             compute_dtype=dtype).validate()
                assert planner.predict_ips_per_chip(cfg, batch) == pytest.approx(ips, rel=1e-6)
    # no TPU number is left: no padding to 8, no fp32 factor, the card's HBM
    assert planner.HBM_GB_H100 == 80.0 and not hasattr(planner, "HBM_GB_V5E")
    cfg = Config(size=512).validate()
    p12, p16 = planner.predict_ips_per_chip(cfg, 12), planner.predict_ips_per_chip(cfg, 16)
    assert p12 < p16 and p12 != pytest.approx(p16 * 12 / 16, rel=1e-3)
    assert planner.predict_ips_per_chip(Config(compute_dtype="float16").validate(), 16) is None
    knee = planner._knee_batch(Config(compute_dtype="bfloat16").validate())
    assert knee >= 16


def test_plan_enumerates_jax_candidates():
    """With memory to spare (no lever engages on either side) the port
    enumerates JAX's candidates: names, overrides (PP's microbatch count
    from the same bubble model), fit, state bytes and the bytes across
    cards; activations differ by the measured constant only. Only DP is
    priced: the pipeline's measured steps over cards contradict the bubble
    model (``PP_NOTE``)."""
    for kw, chips in ((dict(batch_size=64), 8), (dict(batch_size=16), 4),
                      (dict(batch_size=32, size=128, octaves=5), 2)):
        cfg, jcfg = _pair(**kw)
        got = planner.plan(cfg, chips, hbm_gb=1e4)
        want = jplanner.plan(jcfg, chips, hbm_gb=1e4)
        key = lambda c: c["name"]  # noqa: E731
        g, w = sorted(got["candidates"], key=key), sorted(want["candidates"], key=key)
        assert [c["name"] for c in g] == [c["name"] for c in w]
        for a, b in zip(g, w):
            assert a["overrides"] == b["overrides"] and a["fits"] == b["fits"]
            assert a["state_gb"] == b["state_gb"] and a["ici_mb_step"] == b["ici_mb_step"]
            if not a["name"].startswith("PP"):  # PP's adds the stashed boundary inputs
                ratio = planner.ACT_CALIB[cfg.compute_dtype] / jplanner.ACT_CALIB
                assert a["act_gb"] == pytest.approx(b["act_gb"] * ratio, abs=0.011)
            if a["name"] != "DP":  # TP, spatial (as in JAX) and the pipeline: no cost model
                assert a["pred_img_s"] is None
            if a["name"].startswith("PP"):
                assert planner.PP_NOTE in a["note"]
        assert got["chosen"] is not None
    with pytest.raises(ValueError, match="divisible"):
        planner.plan(Config(mesh_slice=3).validate(), 8)


def test_auto_levers_equal_jax():
    cfg, jcfg = _pair(batch_size=64)

    def state_fn(mdt, z):
        return (4e9 if mdt == "float32" else 3e9) / z

    for budget in (9e9, 6e9, 4.5e9, 3.5e9, 1e9):
        for act in (lambda a: 2e9 / a, lambda a: 0.5e9 / a):
            for zw, dp, accum in ((8, 8, True), (1, 1, True), (4, 4, False)):
                got = planner._auto_levers(cfg, zw, dp, state_fn, act, budget, accum)
                want = jplanner._auto_levers(jcfg, zw, dp, state_fn, act, budget, accum)
                assert got[:3] == want[:3]
                # the bf16-moment note cites the card's B2, not the TPU's
                assert got[3].replace(planner.BF16_MOMENTS_NOTE,
                                      "bf16 moments (free — measured)") == want[3]


def test_gan_plans_and_levers():
    for model, kw in (("gan", dict(batch_size=16)), ("cgan", dict(batch_size=16, num_classes=3))):
        cfg, jcfg = _pair(**kw)
        got, want = planner.plan(cfg, 4, model=model), jplanner.plan(jcfg, 4, model=model)
        assert got["workload"] == want["workload"]
        assert [c["name"] for c in got["candidates"]] == ["DP"]
        assert got["candidates"][0]["state_gb"] == want["candidates"][0]["state_gb"]
        if model == "gan":
            r = planner.gan_step_cost_ratio(cfg)
            c = planner.GAN_STEP_COST["float32"]
            assert r == pytest.approx(c["base"] + c["cycle"] + c["identity"])
            assert got["candidates"][0]["pred_img_s"] == pytest.approx(
                planner.predict_ips_per_chip(cfg, 4) / r * 4, rel=1e-3)
        else:
            assert got["candidates"][0]["pred_img_s"] is None
        tight = planner.plan(cfg, 4, hbm_gb=1.6, model=model)
        assert tight["candidates"][0]["overrides"].get("moment_dtype") == "bfloat16"


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


@pytest.mark.parametrize("extra", [[], ["--model", "gan"], ["--model", "cgan",
                                                            "--num-classes", "3"]])
def test_cli_plan_json_has_jax_keys(capsys, extra):
    from gan_class_transfer2_tpu.cli import _plan as jax_plan

    args = ["plan", "--chips", "4", "--json", "--batch-size", "32", *extra]
    assert cli.main(args) == 0
    got = json.loads(capsys.readouterr().out)

    class A:
        chips, hbm_gb, budget_frac, json = 4, 80.0, 0.75, True
        model = extra[1] if extra else "diffusion"

    assert jax_plan(jconfig.Config(batch_size=32, num_classes=3 if "cgan" in extra
                                   else 0).validate(), A) == 0
    want = json.loads(capsys.readouterr().out)
    assert _keys(got) == _keys(want)
    assert got["hbm_gb"] == 80.0 and got["chips"] == 4


def test_cli_plan_table(capsys):
    assert cli.main(["plan", "--chips", "1", "--batch-size", "16"]) == 0
    out = capsys.readouterr().out
    assert "recommended: DP" in out and "strategy" in out and "80.0 GB HBM" in out
    assert "H100" in out and "remat" in out
    pred = [line for line in out.splitlines() if line.startswith("DP ")][0].split()
    assert float(pred[5]) == pytest.approx(
        planner.predict_ips_per_chip(Config(batch_size=16).validate(), 16), abs=1)
    assert np.isfinite(float(pred[5]))
