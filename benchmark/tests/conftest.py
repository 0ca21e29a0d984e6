"""Configurations the benchmark runs no cell of, written into a test's own
directory: files that a later configuration may be."""

import json

import pytest

from benchmark import common


@pytest.fixture
def kth128(tmp_path):
    """``savp_kth64`` at ``hparams/kth/ours_savp_128``: KTH's frames cropped
    to 120 and scaled to 128 (``hparams/README.md``), batch 8 as published.
    Its file and the dict it holds."""
    cfg = common.load_json(common.BENCH_DIR / "configs" / "savp_kth64.json")
    cfg.update(name="savp_kth128", zoo_file="hparams/kth/ours_savp_128/model_hparams.json",
               dataset_hparams={"crop_size": 120, "scale_size": 128}, image_shape=[128, 128, 3],
               hparams=dict(cfg["hparams"], batch_size=8))
    path = tmp_path / "savp_kth128.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def _spec_with(cfg_path, cfg, traffic: str = "train_b16_k4"):
    spec = common.benchmark_spec()
    entry = {"name": cfg["name"], "source": cfg["source"], "file": str(cfg_path), "reduced": [], "why": "a test's"}
    cell = {"name": f"{cfg['name']}.{traffic}", "config": cfg["name"], "traffic": traffic, "chips": 1,
            "why": "a test's"}
    return dict(spec, configs=spec["configs"] + [entry], workloads=spec["workloads"] + [cell]), cell["name"]


@pytest.fixture
def spec_with():
    """``spec_with(cfg_path, cfg, traffic="train_b16_k4")``: ``BENCHMARK.json``
    with one more configuration, ``cfg`` in its file ``cfg_path``, and one
    cell of it under ``traffic``; and that cell's name."""
    return _spec_with


@pytest.fixture
def sna_l2(tmp_path):
    """``hparams/bair/sna_l2`` (Ebert et al. 2017) on BAIR with its actions
    and states read (``use_state``): 4-D actions, 3-D end-effector states.
    Its file and the dict it holds."""
    from video_prediction_torch.configs.hparams import resolve_model_hparams
    from video_prediction_torch.data import get_dataset_class
    from video_prediction_torch.models import get_model_class

    seq = get_dataset_class("bair").default_hparams.replace(use_state=True)
    hp = resolve_model_hparams(get_model_class("sna").default_hparams(),
                               str(common.ROOT / "hparams" / "bair" / "sna_l2" / "model_hparams.json"),
                               extra={"context_frames": seq.context_frames, "sequence_length": seq.sequence_length,
                                      "batch_size": 16})
    base = common.load_json(common.BENCH_DIR / "configs" / "savp_bair64.json")
    cfg = dict(base, name="sna_bair64", source="SAVP repo hparams/bair/sna_l2 (Ebert et al. 2017)", model="sna",
               zoo_file="hparams/bair/sna_l2/model_hparams.json", dataset_hparams={"use_state": True}, action_dim=4,
               state_dim=3, hparams=json.loads(json.dumps(hp.to_dict())))
    path = tmp_path / "sna_bair64.json"
    path.write_text(json.dumps(cfg))
    return path, cfg
