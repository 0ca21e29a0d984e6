"""Run directories and the params checkpoint.

A run directory holds ``options.json`` (model, dataset, seed),
``model_hparams.json``, ``dataset_hparams.json`` — the files the JAX
package's ``scripts/train.py`` writes — and the port's own params file,
``checkpoints/params.pt``: the model's ``state_dict`` saved with
``torch.save``. (The JAX package's orbax checkpoints cannot be read without
jax; ``convert.py`` maps a flax params tree to this ``state_dict``.) Full
train-state checkpoints are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn as nn

from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams

PARAMS_FILE = os.path.join("checkpoints", "params.pt")


def save_params(run_dir: str, model: nn.Module) -> None:
    path = os.path.join(run_dir, PARAMS_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)


def load_params(run_dir: str, model: nn.Module, device: Optional[torch.device] = None) -> None:
    """Load ``checkpoints/params.pt`` into ``model`` (strict: every key and shape)."""
    path = os.path.join(run_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no params checkpoint at {path}")
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True))


def write_run_dir(run_dir: str, model_name: str, dataset_name: str, hparams: ModelHparams,
                  dataset_hparams: DatasetHparams, model: nn.Module, seed: int = 0) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "options.json"), "w") as f:
        json.dump({"model": model_name, "dataset": dataset_name, "seed": seed}, f, indent=2)
    with open(os.path.join(run_dir, "model_hparams.json"), "w") as f:
        json.dump(hparams.to_dict(), f, indent=2)
    with open(os.path.join(run_dir, "dataset_hparams.json"), "w") as f:
        json.dump(dataset_hparams.to_dict(), f, indent=2)
    save_params(run_dir, model)
