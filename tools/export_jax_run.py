#!/usr/bin/env python
"""Export a JAX run directory for the PyTorch port (stage one of two).

    python tools/export_jax_run.py RUN_DIR EXPORT_DIR [--step N]

Runs where jax and orbax run (the TPU host, say). Reads the orbax train
state of step N (default: the latest) in ``RUN_DIR/checkpoints``, as the JAX
package's ``train/checkpoint.py#CheckpointManager.restore_dict`` reads it
(orbax's own reader, no template), but each array as a host numpy array:
``restore_dict`` places each array as the mesh that saved it did, which a
host without those devices refuses (a run trained on 8 devices, exported on
one). It writes ``EXPORT_DIR``: the run's ``options.json``, ``model_hparams.json``
and ``dataset_hparams.json`` as they are, and ``jax_train_state.npz``, every
leaf of the restored tree under its ``/``-joined path, list positions as
integers (``params/generator/...``, ``model_state/spectral/...``,
``opt_state_g/0/mu/...``, ``opt_state_g/0/count``, ``opt_state_g/1/count``,
``step``, ``rng``). The restore has no template, so an optax chain comes back
as a list and an absent discriminator's optimizer state as ``()``: the
export walks what the restore returns and rebuilds no optax type.

Stage two runs where torch is, the GPU machine included, and needs no jax::

    python -m video_prediction_torch.convert EXPORT_DIR --output_dir PORT_RUN_DIR
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Any, Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

JAX_STATE_FILE = "jax_train_state.npz"
RUN_FILES = ("options.json", "model_hparams.json", "dataset_hparams.json")


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` (dicts by key, lists and tuples by position) as
    a numpy array under its ``/``-joined path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def checkpoint_steps(run_dir: str) -> list:
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoints directory in {run_dir}")
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())


def restore_numpy(ckpt_dir: str, step: int) -> Any:
    """The train state of ``step`` in the orbax directory ``ckpt_dir``, without
    a template (an optax chain as a list), every array a numpy array on the
    host, whatever devices or mesh wrote it."""
    import jax
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir), item_handlers=ocp.PyTreeCheckpointHandler())
    try:
        meta = mgr.item_metadata(step)
        meta = getattr(meta, "tree", meta)
        args = jax.tree_util.tree_map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
        return mgr.restore(step, args=ocp.args.PyTreeRestore(restore_args=args))
    finally:
        mgr.close()


def export_run(run_dir: str, export_dir: str, step: Optional[int] = None) -> int:
    """Write ``export_dir`` from step ``step`` (default: the latest) of the
    JAX run directory ``run_dir``; returns the step."""
    steps = checkpoint_steps(run_dir)
    step = steps[-1] if step is None and steps else step
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} in {run_dir}/checkpoints (steps: {steps})")
    flat = flatten(restore_numpy(os.path.join(run_dir, "checkpoints"), step))
    os.makedirs(export_dir, exist_ok=True)
    for name in RUN_FILES:
        shutil.copyfile(os.path.join(run_dir, name), os.path.join(export_dir, name))
    np.savez(os.path.join(export_dir, JAX_STATE_FILE), **flat)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir", help="a run directory of scripts/train.py (options, hparams, checkpoints/)")
    p.add_argument("export_dir")
    p.add_argument("--step", type=int, default=None, help="the checkpoint's step (default: the latest)")
    args = p.parse_args(argv)
    step = export_run(args.run_dir, args.export_dir, args.step)
    print(f"exported step {step} of {args.run_dir} to {args.export_dir}")
    return step


if __name__ == "__main__":
    main()
