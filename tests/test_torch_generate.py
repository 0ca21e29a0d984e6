"""The port's generation CLI (``python -m video_prediction_torch.generate``)
end to end on the CPU at a small width: write a run directory with seeded
weights, restore it, roll out, and write GIFs."""

import json
import os

import pytest
import torch

from video_prediction_torch import generate
from video_prediction_torch.configs.hparams import DatasetHparams, resolve_model_hparams, zoo_dir
from video_prediction_torch.models import get_model_class
from video_prediction_torch.train.checkpoint import PARAMS_FILE, checkpoint_file, load_params, write_run_dir

torch.set_num_threads(1)


def _run_dir(tmp_path, seq=4):
    cls = get_model_class("savp")
    hp = resolve_model_hparams(
        cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
        extra=dict(ngf=4, nef=8, nz=4, sequence_length=seq),
    )
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)  # the synthetic dataset's shapes
    model.init_weights(torch.Generator().manual_seed(0))
    run_dir = str(tmp_path / "run")
    write_run_dir(run_dir, "savp", "synthetic", hp, DatasetHparams(sequence_length=seq), model)
    return run_dir, model


def test_generate_writes_gifs(tmp_path):
    run_dir, _ = _run_dir(tmp_path)
    results = tmp_path / "results"
    summary = generate.main([
        "--checkpoint", run_dir, "--results_dir", str(results), "--device", "cpu",
        "--batch_size", "2", "--num_samples", "3", "--num_stochastic_samples", "2", "--save_png",
    ])
    out_dir = results / "synthetic" / "savp" / "generated"
    assert summary["out_dir"] == str(out_dir)
    assert summary["rollouts"] == 4 and summary["gifs"] == 6 and summary["all_finite"]
    gifs = sorted(p.name for p in out_dir.glob("*.gif"))
    assert gifs == [f"gen_{i:05d}_sample{s:02d}.gif" for i in range(3) for s in range(2)]
    assert all(os.path.getsize(out_dir / g) > 0 for g in gifs)
    assert len(list(out_dir.glob("gen_00000_sample00_t*.png"))) == 3  # T-1 frames


def test_run_dir_round_trip(tmp_path):
    run_dir, model = _run_dir(tmp_path)
    with open(os.path.join(run_dir, "options.json")) as f:
        assert json.load(f) == {"model": "savp", "dataset": "synthetic", "seed": 0}
    assert os.path.exists(checkpoint_file(run_dir, PARAMS_FILE))
    clone = get_model_class("savp")(model.hparams, image_shape=(64, 64, 3), action_dim=4)
    load_params(run_dir, clone)
    for (k, a), (_, b) in zip(model.state_dict().items(), clone.state_dict().items()):
        assert torch.equal(a, b), k


def test_missing_params_raise(tmp_path):
    run_dir, model = _run_dir(tmp_path)
    os.remove(checkpoint_file(run_dir, PARAMS_FILE))
    with pytest.raises(FileNotFoundError, match="params"):
        load_params(run_dir, model)


def test_generate_at_another_length_restores_a_model_with_discriminators(tmp_path):
    """A run with discriminators (their dense width follows the trained
    length) generates at a longer length: the model keeps the trained length
    for its parameter shapes, and the generator takes the data's."""
    run_dir, model = _run_dir(tmp_path)
    assert "video" in model.discriminator  # ours_savp: clip of min(10, 4 - 1) frames
    summary = generate.main(["--checkpoint", run_dir, "--results_dir", str(tmp_path / "results"), "--device", "cpu",
                             "--batch_size", "1", "--num_samples", "1", "--sequence_length", "7", "--save_png"])
    assert summary["all_finite"] and summary["gifs"] == 1
    assert len(list((tmp_path / "results" / "synthetic" / "savp" / "generated").glob("*.png"))) == 6  # T-1 frames
