"""The published CycleGAN's cell on the CPU: the yardstick against the hand
counts of the layer list, and the cell down to its last line at 32², where
the published three-layer 70×70 PatchGAN runs (its patch map needs 24² or
more; the shared tests' 16² takes two layers, ``fit_patchgan``): a correct
rehearsal, traced and not, each planted fault and the control failing,
and the program against the reference through the image pool's swaps."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT, last_json_line, make_tiny_root

from perfbench import calibrate, faults, run
from perfbench.harness import counts
from perfbench.reference import cyclegan as ref
from perfbench.reference import model as M

CELL = "cyclegan256-train-bf16-b16"
CFG = SimpleNamespace(**json.loads((ROOT / "perfbench/configs/cyclegan-r9-256.json").read_text()))
G_MACS, D_MACS = 49_551_507_456, 3_146_809_344  # the layer list's counts at 256²


def _forward(net, shapes, cfg, channels):
    rec = M.Recorder()

    def fwd(x, *leaves):
        with torch.no_grad():
            net(cfg, dict(zip(shapes, leaves)), x, rec=rec)

    x = torch.zeros(1, channels, cfg.size, cfg.size)
    flops = counts.count_flops(fwd, x, *[torch.zeros(s) for s in shapes.values()])
    return flops, rec


def test_published_parameter_counts():
    import math

    assert sum(math.prod(s) for s in ref.generator_shapes(CFG).values()) == 11_378_179
    assert sum(math.prod(s) for s in ref.discriminator_shapes(CFG).values()) == 2_764_737


@pytest.mark.parametrize("net,macs,norms", [("generator", G_MACS, 23),
                                            ("discriminator", D_MACS, 3)])
def test_forward_flops_match_the_hand_counts(net, macs, norms):
    shapes = getattr(ref, f"{net}_shapes")(CFG)
    flops, rec = _forward(getattr(ref, net), shapes, CFG, 3)
    assert flops == 2 * macs
    assert sum(c[0] == "instance_norm" for c in rec) == norms


def test_the_trunk_holds_88_percent_of_the_generator():
    trunk = 2 * 9 * 64 * 64 * 9 * 256 * 256
    assert trunk == 43_486_543_872 and round(trunk / G_MACS, 2) == 0.88


def test_a_step_counts_156_norms_and_its_flops_by_hand():
    """A step of one image a class. G: six forwards, six weight gradients
    and six input gradients, less the stem's input gradient where G's input
    is data (G_AB(a), G_BA(b) and both identities). D: two passes held
    constant in G's loss (forward and input gradient), four in its own
    (forward, weight gradient, input gradient but the first layer's)."""
    from perfbench.traffic import cyclegan_train

    r = SimpleNamespace(ref_cfg=lambda: CFG, extra={})
    cyclegan_train.count_flops(r, 1)
    norms = [c[1] for c in r.extra["calls_per_unit"] if c[0] == "instance_norm"]
    assert len(norms) == 6 * 23 + 6 * 3 == 156
    assert sum(s[1:] == (256, 64, 64) for s in norms) == 6 * 19
    f_g, f_stem = 2 * G_MACS, 2 * 256 * 256 * 49 * 3 * 64
    f_d, f_d1 = 2 * D_MACS, 2 * 128 * 128 * 16 * 3 * 64
    assert r.extra["flops_per_unit"] == 18 * f_g - 4 * f_stem + 16 * f_d - 4 * f_d1


@pytest.fixture
def root32(tmp_path):
    """``make_tiny_root`` with the cell's tiny configuration at 32², two
    residual blocks, pools of 40², and an image pool of 3 a class, so the
    checked steps swap."""
    return _root32(tmp_path)


def _root32(tmp_path, dtype="float32"):
    root = make_tiny_root(tmp_path, dtype=dtype)
    path = root / "perfbench/configs/tiny-cyclegan-r9-256.json"
    cfg = json.loads(path.read_text())
    cfg.update(size=32, resnet_blocks=2, image_pool=3)
    path.write_text(json.dumps(cfg))
    path = root / f"perfbench/workloads/tiny-{CELL}.json"
    spec = json.loads(path.read_text())
    spec["params"].update(pool_side=40)
    path.write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("size,d_octaves", [(256, 3), (32, 3), (24, 3), (16, 2), (8, 1)])
def test_fit_patchgan_keeps_the_deepest_layout_the_images_admit(size, d_octaves):
    from perfbench.traffic import cyclegan_train

    r = SimpleNamespace(config={"size": size, "d_octaves": 3})
    cyclegan_train.fit_patchgan(r)
    assert r.config["d_octaves"] == d_octaves
    assert (size >> d_octaves) - 2 >= 1  # a patch map of one logit or more


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_a_correct_result(root32, trace, capsys):
    rc = run.main(["--workload", f"tiny-{CELL}", "--seed", str(2**31 + 23), "--seconds", "0.5",
                   "--trace", str(trace)], root=root32, device="cpu")
    line = last_json_line(capsys.readouterr().out)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1 and list(line)[-1] == "checks"
    assert set(line["checks"]) == {"grad_gap", "delta_gap"}
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "gan_img_per_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_makes_the_run_incorrect(root32, fault, capsys):
    with faults.FAULTS[fault]("gan_train"):
        rc = run.main(["--workload", f"tiny-{CELL}", "--seed", "7", "--seconds", "0.2",
                       "--trace", "0"], root=root32, device="cpu")
    line = last_json_line(capsys.readouterr().out)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


def test_calibrate_plants_the_faults_itself(root32, capsys):
    rows = calibrate.readings(f"tiny-{CELL}", ["program", "fault:unchanged"], [3], root=root32,
                              device="cpu")
    limits = json.loads((ROOT / f"perfbench/workloads/{CELL}.json").read_text())["limits"]
    assert all(rows[0][k] <= v for k, v in limits.items())
    assert any(rows[1][k] > v for k, v in limits.items())
    capsys.readouterr()


def test_the_control_fails_a_limit(tmp_path, capsys):
    root = _root32(tmp_path, dtype="bfloat16")
    limits = json.loads((ROOT / f"perfbench/workloads/{CELL}.json").read_text())["limits"]
    for row in calibrate.readings(f"tiny-{CELL}", ["control"], [1, 2, 3], root=root,
                                  device="cpu"):
        assert any(row[k] > v for k, v in limits.items()), (row, limits)
    capsys.readouterr()


def test_the_parent_program_fails_at_once(root32, monkeypatch, capsys):
    """A program whose ``Config`` lacks the ResNet generator stops set-up
    before building anything."""
    from gan_class_transfer2_tpu_torch import config

    new = {"generator", "resnet_blocks", "d_layout", "image_pool", "adam_b1"}
    monkeypatch.setattr(config, "_FIELD_NAMES", config._FIELD_NAMES - new)
    with pytest.raises(SystemExit, match="no ResNet generator"):
        run.main(["--workload", f"tiny-{CELL}", "--seed", "1", "--seconds", "0.2",
                  "--trace", "0"], root=root32, device="cpu")
    assert '"correct"' not in capsys.readouterr().out
