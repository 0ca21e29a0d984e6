"""Run directories, the params checkpoint and the full train-state checkpoint.

A run directory holds ``options.json`` (model, dataset, seed),
``model_hparams.json``, ``dataset_hparams.json`` — the files the JAX
package's ``scripts/train.py`` writes — and the port's checkpoints, one
directory a step, as the JAX package's ``CheckpointManager`` keeps them
(``video_prediction_tpu/train/checkpoint.py``: orbax, ``max_to_keep=3``):

- ``checkpoints/<step>/params.pt``: the model's ``state_dict`` (parameters
  and spectral ``u`` buffers), what ``generate`` and ``evaluate`` read;
- ``checkpoints/<step>/train_state.pt``: the full train state for
  ``--resume`` (the counterpart of the JAX package's orbax ``TrainState``,
  in ``torch.save`` form): the step, the model's ``state_dict``, both Adam
  states with their slots keyed by parameter name
  (``state.optimizer_state``), and the step-noise generator's state, or a
  seed for it.

A save writes ``checkpoints/<step>.tmp/``, renames it to
``checkpoints/<step>/`` once both files are whole, and only then deletes
the step directories beyond the newest ``MAX_TO_KEEP`` by step number and
any ``*.tmp`` directory a killed save left (orbax's order). A step already
kept is not written again (``save_train_state`` returns False), as the JAX
manager skips it. The readers take the newest kept step, or a given one
(``step=``), and never look at a ``*.tmp`` directory. A run directory
written before steps had directories holds ``checkpoints/params.pt`` and
``checkpoints/train_state.pt``: it reads as its one step while it has no
step directory (nothing writes that layout any more, and a save into it
leaves those two files as they are).

The JAX package's orbax checkpoints cannot be read without jax: a JAX run
directory is carried over in two stages, ``tools/export_jax_run.py`` where
jax is, then ``python -m video_prediction_torch.convert``, which writes the
exported step of a run directory of this form (``train_state.pt``'s
generator as a seed: the JAX key is not carried).

Under a process group (``parallel/distributed.py``) the writers write on rank
0 only, then every rank waits at a barrier, so that no rank reads a file
before it is whole; every rank calls them alike. The readers run on every
rank.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams
from video_prediction_torch.parallel.distributed import barrier, is_primary
from video_prediction_torch.train.state import load_optimizer, optimizer_param_names, optimizer_state

CHECKPOINT_DIR = "checkpoints"
PARAMS_FILE = "params.pt"
TRAIN_STATE_FILE = "train_state.pt"
MAX_TO_KEEP = 3  # the JAX CheckpointManager's default
TMP_SUFFIX = ".tmp"


def kept_steps(run_dir: str) -> List[int]:
    """The steps of ``run_dir``'s whole step directories, oldest first."""
    root = os.path.join(run_dir, CHECKPOINT_DIR)
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit() and os.path.isdir(os.path.join(root, d)))


def _flat_dir(run_dir: str) -> Optional[str]:
    """``checkpoints/`` of a run directory in the flat layout (no step
    directory, the files beside each other), else None."""
    root = os.path.join(run_dir, CHECKPOINT_DIR)
    if kept_steps(run_dir) or not any(os.path.exists(os.path.join(root, f)) for f in (PARAMS_FILE, TRAIN_STATE_FILE)):
        return None
    return root


def _flat_step(root: str) -> Optional[int]:
    path = os.path.join(root, TRAIN_STATE_FILE)
    return int(torch.load(path, mmap=True, weights_only=True)["step"]) if os.path.exists(path) else None


def latest_step(run_dir: str) -> Optional[int]:
    """The newest kept step of ``run_dir``; in the flat layout the step its
    train state holds; None where there is no checkpoint (or only a flat
    params file, which holds no step)."""
    steps = kept_steps(run_dir)
    if steps:
        return steps[-1]
    flat = _flat_dir(run_dir)
    return None if flat is None else _flat_step(flat)


def checkpoint_file(run_dir: str, name: str, step: Optional[int] = None) -> str:
    """The path of ``name`` (``PARAMS_FILE`` or ``TRAIN_STATE_FILE``) in
    ``run_dir``'s step ``step`` (default: the newest kept); raises
    ``FileNotFoundError`` where that step or its file is missing."""
    steps = kept_steps(run_dir)
    flat = _flat_dir(run_dir)
    if flat is not None and (step is None or step == _flat_step(flat)):
        where = flat
    elif steps and (step is None or step in steps):
        where = os.path.join(run_dir, CHECKPOINT_DIR, str(steps[-1] if step is None else step))
    else:
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} in "
                                f"{os.path.join(run_dir, CHECKPOINT_DIR)} (kept steps: {steps})")
    path = os.path.join(where, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {name} at {path}")
    return path


def _step_of(path: str) -> Optional[int]:
    """The step a checkpoint file belongs to, by its directory; None for the flat layout."""
    name = os.path.basename(os.path.dirname(path))
    return int(name) if name.isdigit() else None


def save_step(run_dir: str, step: int, files: Callable[[], Dict[str, object]]) -> bool:
    """Write ``files()`` (``{file name: object}``, ``torch.save``d) as the
    checkpoint of ``step``: into ``checkpoints/<step>.tmp/``, renamed into
    place when whole, then the steps beyond the newest ``MAX_TO_KEEP`` and
    any stale ``*.tmp`` directory deleted. Writes nothing and returns False
    where ``step`` is kept already. Rank 0 writes; every rank returns alike."""
    root = os.path.join(run_dir, CHECKPOINT_DIR)
    final = os.path.join(root, str(step))
    fresh = not os.path.isdir(final)
    barrier()  # every rank has looked before rank 0 writes
    if fresh and is_primary():
        tmp = final + TMP_SUFFIX
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, obj in files().items():
            torch.save(obj, os.path.join(tmp, name))
        os.rename(tmp, final)
        for d in os.listdir(root):
            if d.endswith(TMP_SUFFIX):
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        for old in kept_steps(run_dir)[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(root, str(old)))
    barrier()
    return fresh


def _cpu_state_dict(model: nn.Module):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def load_params(run_dir: str, model: nn.Module, device: Optional[torch.device] = None,
                step: Optional[int] = None) -> Optional[int]:
    """Load the params file of step ``step`` (default: the newest kept) into
    ``model``: every key and shape, except that a params file without
    discriminators (written before the port had them) still loads into a
    model with them, for generation. Returns the step read (in the flat
    layout its train state's, None without one)."""
    path = checkpoint_file(run_dir, PARAMS_FILE, step)
    missing, unexpected = model.load_state_dict(torch.load(path, map_location=device, weights_only=True),
                                                strict=False)
    missing = [k for k in missing if not k.startswith("discriminator.")]
    if missing or unexpected:
        raise RuntimeError(f"params checkpoint {path} does not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    return _step_of(path) if _step_of(path) is not None else latest_step(run_dir)


def warm_start(run_dir: str, model: nn.Module) -> List[str]:
    """Copy into ``model`` each parameter of ``run_dir``'s newest params
    file whose name and shape match one of its own, as the JAX package's
    ``checkpoint.py#_merge_matching`` merges a restored params tree into a
    fresh one; the others, and the buffers (spectral ``u``, outside the JAX
    params tree), keep their values. Returns the names copied."""
    saved = torch.load(checkpoint_file(run_dir, PARAMS_FILE), map_location="cpu", weights_only=True)
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
    """The option files and ``model``'s params as the checkpoint of step 0
    (no train state): a run directory ``generate`` and ``evaluate`` read."""
    write_options(run_dir, model_name, dataset_name, hparams, dataset_hparams, seed)
    save_step(run_dir, 0, lambda: {PARAMS_FILE: _cpu_state_dict(model)})


def _adam_state(model: nn.Module, opt: Optional[torch.optim.Adam]) -> Optional[dict]:
    return None if opt is None else optimizer_state(opt, optimizer_param_names(model, opt))


def save_train_state(run_dir: str, ts) -> bool:
    """Write the checkpoint of ``ts.step`` (``train.state.TrainState``): its
    train state and params files. False, and nothing written, where that
    step is kept already (a final save after a periodic one)."""
    def files():
        model = _cpu_state_dict(ts.model)
        return {TRAIN_STATE_FILE: {"step": ts.step, "model": model, "opt_g": _adam_state(ts.model, ts.opt_g),
                                   "opt_d": _adam_state(ts.model, ts.opt_d), "rng": ts.rng.get_state()},
                PARAMS_FILE: model}

    return save_step(run_dir, ts.step, files)


def has_train_state(run_dir: str) -> bool:
    """Whether the newest kept step of ``run_dir`` has a train state."""
    try:
        checkpoint_file(run_dir, TRAIN_STATE_FILE)
    except FileNotFoundError:
        return False
    return True


def load_train_state(run_dir: str, ts, step: Optional[int] = None) -> None:
    """Restore ``ts`` in place from the train state of step ``step`` (default:
    the newest kept; strict: every parameter, buffer and optimizer slot, by
    name; a file with the slots by position, written before names were,
    loads too). A state saved by a run of one step a call resumes into
    Adams built for several (``state.make_optimizers``), and the reverse. An
    int in place of the generator's state (a converted JAX run) seeds the
    generator."""
    path = checkpoint_file(run_dir, TRAIN_STATE_FILE, step)
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
