"""The check against planted faults: the harness driven at a tiny size on
the CPU (its look for a card skipped), with the timed path broken underneath
(``benchmark/faults.py``), must come out not correct; the same run unbroken
must come out correct. Within the cell's own limits. Also: the control that
each configuration gets (``calibrate.control``), and a bf16 cell rehearsed
in its own dtypes."""

import contextlib
import math

import pytest
import torch

from benchmark import calibrate, common, faults, program, rehearse, run

SPEC = common.benchmark_spec()
CASES = [(w["name"], f) for w in SPEC["workloads"]
         for f in faults.FAULTS[common.resolve(SPEC, w["name"])[2]["kind"]]]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_sound_run_is_correct(cell):
    out = rehearse.rehearse(cell)
    assert out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    kind = common.resolve(SPEC, cell)[2]["kind"]
    with faults.fault(fault, kind):
        out = rehearse.rehearse(cell)
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_control_by_configuration(config):
    """An fp32 configuration's control is the port's bf16 compute, as it
    always was; a bf16 configuration's is itself, with float8 planted."""
    cfg = common.load_json(common.ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == config))
    ctl = calibrate.control(cfg)
    if cfg["precision"]["dtype"] == "float32":
        assert ctl.overrides == {"compute_dtype": "bfloat16"} and isinstance(ctl.plant, contextlib.nullcontext)
    else:
        assert cfg["precision"]["dtype"] == "bfloat16" and ctl.overrides == {}
        assert not isinstance(ctl.plant, contextlib.nullcontext)


def test_fp8_plant_rounds_every_generator_conv():
    """Under ``fp8_convs`` each conv of a model's generator outputs values
    that float8 e4m3 holds, and its gradient passes through; the plant is
    gone after it."""
    from video_prediction_torch.ops.layers import Conv2D

    cfg = common.load_json(common.ROOT / "benchmark" / "configs" / "savp_bair64_bf16.json")
    hp = program.hparams(cfg, dict(rehearse.TINY, sequence_length=4))
    seen = []

    def watch(module, inputs, out):
        seen.append(out)

    with calibrate.fp8_convs():
        model, _ = program.build_model(cfg, hp, (32, 32, 3), 7, "cpu")
    plain, _ = program.build_model(cfg, hp, (32, 32, 3), 7, "cpu")
    convs = [m for m in model.generator.modules() if isinstance(m, Conv2D)]
    assert len(convs) >= 10
    for m in convs:
        m.register_forward_hook(watch)
    images = torch.rand(2, 4, 32, 32, 3)
    use_gt = torch.ones(3, 2, dtype=torch.bool)
    zs = torch.randn(2, 3, hp.nz)
    model.generator(images, use_gt, zs)["gen_images"].sum().backward()
    assert len(seen) >= len(convs)
    for out in seen:
        assert torch.equal(out, out.to(calibrate.FP8).to(out.dtype))
    assert all(p.grad is not None for p in model.generator.parameters() if p.requires_grad)
    assert not any(m._forward_hooks for m in plain.generator.modules())


def test_bf16_cell_rehearses_in_its_own_dtypes():
    """The bf16 cell at the tiny sizes in its configured bf16 compute and
    gates, through the harness: every number of the check is read."""
    cell = next(w["name"] for w in SPEC["workloads"] if w["config"] == "savp_bair64_bf16")
    out = run.run_cell(SPEC, cell, 12345, 0.5, False, "cpu",
                       overrides=dict(rehearse.TINY, **rehearse.TINY_SEQUENCE["train"]),
                       traffic_overrides=rehearse.TINY_TRAFFIC["train"])
    assert out["cell"].hp.compute_dtype == "bfloat16" and out["cell"].hp.gate_dtype == "bfloat16"
    assert out["result"]["attempted"] >= 1
    assert out["checks"] and all(math.isfinite(v["value"]) for v in out["checks"].values()), out["checks"]
