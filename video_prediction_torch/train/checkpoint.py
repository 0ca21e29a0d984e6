"""Run directories, the params checkpoint and the full train-state checkpoint.

A run directory holds ``options.json`` (model, dataset, seed),
``model_hparams.json``, ``dataset_hparams.json`` — the files the JAX
package's ``scripts/train.py`` writes — and the port's own checkpoints:

- ``checkpoints/params.pt``: the model's ``state_dict`` (parameters and
  spectral ``u`` buffers), what ``generate`` reads;
- ``checkpoints/train_state.pt``: the full train state for ``--resume``
  (the counterpart of the JAX package's orbax ``TrainState``, in
  ``torch.save`` form): the step, the model's ``state_dict``, both Adam
  states with their slots keyed by parameter name
  (``state.optimizer_state``), and the step-noise generator's state, or a
  seed for it.

The JAX package's orbax checkpoints cannot be read without jax: a JAX run
directory is carried over in two stages, ``tools/export_jax_run.py`` where
jax is, then ``python -m video_prediction_torch.convert``, which writes a
run directory of this form (``train_state.pt``'s generator as a seed:
the JAX key is not carried). The port keeps one checkpoint a run directory
where the JAX package keeps the last three; the exporter picks one step.

Under a process group (``parallel/distributed.py``) the writers write on rank
0 only, then every rank waits at a barrier, so that no rank reads a file
before it is whole; every rank calls them alike. The readers run on every
rank.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import torch
import torch.nn as nn

from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams
from video_prediction_torch.parallel.distributed import barrier, is_primary
from video_prediction_torch.train.state import load_optimizer, optimizer_param_names, optimizer_state

PARAMS_FILE = os.path.join("checkpoints", "params.pt")
TRAIN_STATE_FILE = os.path.join("checkpoints", "train_state.pt")


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # atomic: a reader never sees a partial file


def _cpu_state_dict(model: nn.Module):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_params(run_dir: str, model: nn.Module) -> None:
    if is_primary():
        _save(_cpu_state_dict(model), os.path.join(run_dir, PARAMS_FILE))
    barrier()


def load_params(run_dir: str, model: nn.Module, device: Optional[torch.device] = None) -> None:
    """Load ``checkpoints/params.pt`` into ``model``: every key and shape, except
    that a params file without discriminators (written before the port had
    them) still loads into a model with them, for generation."""
    path = os.path.join(run_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no params checkpoint at {path}")
    missing, unexpected = model.load_state_dict(torch.load(path, map_location=device, weights_only=True),
                                                strict=False)
    missing = [k for k in missing if not k.startswith("discriminator.")]
    if missing or unexpected:
        raise RuntimeError(f"params checkpoint {path} does not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")


def warm_start(run_dir: str, model: nn.Module) -> List[str]:
    """Copy into ``model`` each parameter of ``run_dir``'s
    ``checkpoints/params.pt`` whose name and shape match one of its own, as
    the JAX package's ``checkpoint.py#_merge_matching`` merges a restored
    params tree into a fresh one; the others, and the buffers (spectral
    ``u``, outside the JAX params tree), keep their values. Returns the names
    copied."""
    path = os.path.join(run_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no params checkpoint at {path}")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    copied = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in saved and saved[name].shape == p.shape:
                p.copy_(saved[name])
                copied.append(name)
    return copied


def write_options(run_dir: str, model_name: str, dataset_name: str, hparams: ModelHparams,
                  dataset_hparams: DatasetHparams, seed: int = 0) -> None:
    if is_primary():
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "options.json"), "w") as f:
            json.dump({"model": model_name, "dataset": dataset_name, "seed": seed}, f, indent=2)
        with open(os.path.join(run_dir, "model_hparams.json"), "w") as f:
            json.dump(hparams.to_dict(), f, indent=2)
        with open(os.path.join(run_dir, "dataset_hparams.json"), "w") as f:
            json.dump(dataset_hparams.to_dict(), f, indent=2)
    barrier()


def write_run_dir(run_dir: str, model_name: str, dataset_name: str, hparams: ModelHparams,
                  dataset_hparams: DatasetHparams, model: nn.Module, seed: int = 0) -> None:
    write_options(run_dir, model_name, dataset_name, hparams, dataset_hparams, seed)
    save_params(run_dir, model)


def _adam_state(model: nn.Module, opt: Optional[torch.optim.Adam]) -> Optional[dict]:
    return None if opt is None else optimizer_state(opt, optimizer_param_names(model, opt))


def save_train_state(run_dir: str, ts) -> None:
    """Write ``checkpoints/train_state.pt`` and ``checkpoints/params.pt`` for
    the train state ``ts`` (``train.state.TrainState``)."""
    if is_primary():
        _save({
            "step": ts.step,
            "model": _cpu_state_dict(ts.model),
            "opt_g": _adam_state(ts.model, ts.opt_g),
            "opt_d": _adam_state(ts.model, ts.opt_d),
            "rng": ts.rng.get_state(),
        }, os.path.join(run_dir, TRAIN_STATE_FILE))
    save_params(run_dir, ts.model)


def has_train_state(run_dir: str) -> bool:
    return os.path.exists(os.path.join(run_dir, TRAIN_STATE_FILE))


def load_train_state(run_dir: str, ts) -> None:
    """Restore ``ts`` in place from ``checkpoints/train_state.pt`` (strict:
    every parameter, buffer and optimizer slot, by name; a file with the
    slots by position, written before names were, loads too). A state saved
    by a run of one step a call resumes into Adams built for several
    (``state.make_optimizers``), and the reverse. An int in place of the
    generator's state (a converted JAX run) seeds the generator."""
    path = os.path.join(run_dir, TRAIN_STATE_FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    ts.model.load_state_dict(saved["model"])
    for opt, key in ((ts.opt_g, "opt_g"), (ts.opt_d, "opt_d")):
        if (opt is None) != (saved[key] is None):
            raise RuntimeError(f"train state {path}: {key} does not fit the model")
        if opt is not None:
            load_optimizer(opt, saved[key], optimizer_param_names(ts.model, opt))
    if isinstance(saved["rng"], int):
        ts.rng.manual_seed(saved["rng"])
    else:
        ts.rng.set_state(saved["rng"])
    ts.step = int(saved["step"])
