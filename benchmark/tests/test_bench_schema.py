"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
resolved to its file: configurations, traffic mixes, kinds, per-layer
metric readers and each cell's limits."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import common

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_./%-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        own = [e["name"] for e in SPEC[group]]
        assert len(own) == len(set(own))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["workloads"] + SPEC["configs"]:
        assert LINE.match(e["why"])
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        e2e, layer = common.cell_metrics(SPEC, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer, w["name"]


def test_moves_is_reported_where_the_layer_metric_is():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_every_configuration_keeps_a_cell():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_layers_share_names():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    w, cfg, traffic = common.resolve(SPEC, cell)
    assert cfg["name"] == w["config"]
    assert importlib.import_module(f"benchmark.kinds.{traffic['kind']}").Cell
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    assert limits["limits"] and set(limits["limits"]) <= set(limits["readings"])
    for key in ("hparams", "image_shape", "precision", "peak_flops", "reduced", "assumed"):
        assert key in cfg


def assert_is_its_source(cfg):
    """The frozen hparams dict is the model's defaults, then its zoo file,
    then the dataset's sequence structure under the configuration's dataset
    hparams (``dataset_hparams``, none where it states none), as the port's
    CLIs merge them. The image shape is the dataset's frames as the port's
    reader shapes them (``data/base.py``: cropped to ``crop_size``, then
    scaled to ``scale_size``); the long sequence is the dataset's; the action
    and state dims (0 where a configuration states none) are the dataset's
    where its hparams read them (``use_state``), states only where the model
    uses them, as the port's first batch fixes them (``models/base.py#input_dims``)."""
    import numpy as np

    from video_prediction_torch.configs.hparams import resolve_model_hparams
    from video_prediction_torch.data import get_dataset_class
    from video_prediction_torch.data.native_loader import bilinear_resize_uint8, center_crop_or_pad
    from video_prediction_torch.models import get_model_class

    dataset = get_dataset_class(cfg["dataset"])
    seq = dataset.default_hparams.replace(**cfg.get("dataset_hparams", {}))
    hp = resolve_model_hparams(get_model_class(cfg["model"]).default_hparams(), str(ROOT / cfg["zoo_file"]),
                               extra={"context_frames": seq.context_frames, "sequence_length": seq.sequence_length,
                                      "batch_size": cfg["hparams"]["batch_size"]})
    assert json.loads(json.dumps(hp.to_dict())) == cfg["hparams"]
    frames = np.zeros((1, *dataset.IMAGE_SHAPE), np.uint8)
    if seq.crop_size:
        frames = center_crop_or_pad(frames, seq.crop_size)
    if seq.scale_size and frames.shape[1:3] != (seq.scale_size, seq.scale_size):
        frames = bilinear_resize_uint8(frames, seq.scale_size, seq.scale_size)
    assert tuple(cfg["image_shape"]) == frames.shape[1:]
    assert cfg["long_sequence_length"] == seq.long_sequence_length
    actions = dataset.ACTION_DIM if dataset.ACTION_KEY and seq.use_state else 0
    states = dataset.STATE_DIM if dataset.STATE_KEY and seq.use_state and hp.use_states else 0
    assert (cfg.get("action_dim", 0), cfg.get("state_dim", 0)) == (actions, states)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configuration_is_its_source(config):
    assert_is_its_source(common.load_json(ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == config)))


def test_configuration_stating_dataset_hparams_resolves(kth128, spec_with):
    """A configuration at 128 px (crop 120, scale 128) is its source, and a
    cell of it resolves to its file, its traffic and its model's parts."""
    from benchmark import models
    from benchmark.models import savp

    path, cfg = kth128
    assert_is_its_source(cfg)
    spec, cell = spec_with(path, cfg)
    _, got, traffic = common.resolve(spec, cell)
    assert got == cfg and traffic["kind"] == "train"
    assert models.find(got) is savp


def test_conditioned_configuration_is_its_source(sna_l2):
    """An action-conditioned configuration states its dataset's dims."""
    cfg = sna_l2[1]
    assert_is_its_source(cfg)
    for change in ({"action_dim": 0}, {"state_dim": 2}, {"dataset_hparams": {}}):
        with pytest.raises(AssertionError):
            assert_is_its_source(dict(cfg, **change))


@pytest.mark.parametrize("change", [{"image_shape": [64, 64, 3]},
                                    {"dataset_hparams": {"crop_size": 120, "scale_size": 96}},
                                    {"dataset_hparams": {}}, {"action_dim": 4}])
def test_shape_or_dims_unlike_the_source_fail(kth128, change):
    """The 128 px configuration with a shape its stated ``scale_size`` does
    not give, or with dims its dataset does not read, is not its source."""
    cfg = dict(kth128[1], **change)
    with pytest.raises(AssertionError):
        assert_is_its_source(cfg)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_resolves(metric):
    assert callable(common.load_reader(metric))


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_check_budget_fits():
    cells = 24  # what later PRs may grow to
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
