"""Each model's own parts (``benchmark/models/<model>.py``), found by the
configuration's ``model``: every configuration's model has them, and ``savp``
is its plain reference and its counts; a model without such a file stops a
run before its set-up, with a message that names the file."""

import json
from pathlib import Path

import pytest

from benchmark import common, models, run
from benchmark.kinds import train as train_kind

SPEC = common.benchmark_spec()
MODELS_DIR = Path(__file__).resolve().parents[1] / "models"
INTERFACE = ("train_steps", "eval_rollout", "train_step_flops", "rollout_flops", "kernel_bytes", "kernel_events")


@pytest.mark.parametrize("path", sorted(p for p in MODELS_DIR.glob("*.py") if p.name != "__init__.py"),
                         ids=lambda p: p.name)
def test_model_files_give_the_kinds_names(path):
    parts = models.find({"name": "any", "model": path.stem})
    assert all(callable(getattr(parts, name, None)) for name in INTERFACE), path.name


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_savp_resolves_to_its_reference_and_counts(config):
    from benchmark import counts
    from benchmark.models import savp
    from benchmark.reference import savp as reference

    cfg = common.load_json(common.ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == config))
    parts = models.find(cfg)
    assert cfg["model"] == "savp" and parts is savp
    assert parts.reference is reference and parts.counts is counts


@pytest.fixture
def absent(tmp_path, kth128, spec_with):
    """A cell whose configuration runs a model with no file here."""
    cfg = dict(kth128[1], name="absent_cfg", model="absent_model")
    path = tmp_path / "absent_cfg.json"
    path.write_text(json.dumps(cfg))
    return spec_with(path, cfg)


def test_unknown_model_exits_before_setup(absent, monkeypatch):
    def setup(self):
        raise AssertionError("set-up ran")

    monkeypatch.setattr(train_kind.Cell, "setup", setup)
    spec, cell = absent
    with pytest.raises(SystemExit) as stop:
        run.run_cell(spec, cell, 1, 0.1, False, "cpu")
    assert "benchmark/models/absent_model.py" in str(stop.value)


def test_unknown_model_exits_from_the_command(absent, monkeypatch):
    """``benchmark.run`` looks for the model's file before it looks for a
    card."""
    spec, cell = absent
    monkeypatch.setattr(common, "benchmark_spec", lambda: spec)
    with pytest.raises(SystemExit) as stop:
        run.main(["--workload", cell, "--seed", "1", "--seconds", "1"])
    assert "benchmark/models/absent_model.py" in str(stop.value)


@pytest.mark.parametrize("got,want,gaps", [([2.0, 0.5], [4.0, 0.25], [0.5, 1.0]),
                                           ([4.0, 0.0], [4.0, 0.0], [0.0, 0.0]),
                                           ([4.0, 0.125], [4.0, 0.0], [0.0, 0.125])])
def test_loss_gap_of_a_model_without_a_discriminator(got, want, gaps):
    """The train kind's loss gaps are relative, and absolute where the
    reference's loss is 0, as ``d_loss`` is for a model with no
    discriminator: a gap, never a division by 0."""
    assert train_kind.Cell.step_gaps({"losses": [got]}, {"losses": [want]}) == [gaps]
