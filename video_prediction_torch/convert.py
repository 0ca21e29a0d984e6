"""Carry weights across: a flax params tree -> the port's ``state_dict``.

Takes the JAX package's ``params`` (as from ``init_variables`` or a restored
checkpoint) as nested dicts of numpy arrays — for example
``jax.tree_util.tree_map(np.asarray, params)`` — and, optionally, the
spectral-norm ``u`` vectors as a tree laid out like ``params``, and returns
the ``state_dict`` of ``models.base.VideoPredictionModel``. For the whole
model the ``u`` tree is ``{"discriminator": state["spectral"]}`` (the JAX
package keys ``state["spectral"]`` by discriminator, like
``params["discriminator"]``). Imports no jax.

Mapping:
- the flax tree's module path becomes the torch module path: ``SAVPCell_0``
  is ``cell``; the ``Conv_0`` wrapper level of ``Conv2D`` and the
  ``_SpectralKernel_0`` level of the spectral layers disappear;
  ``Conv2D_0`` inside ``ConvPool2D``/``UpsampleConv2D`` is ``conv``; the
  ``ConvTranspose_0`` level of ``ConvTranspose2D`` disappears too;
- conv kernels HWIO -> OIHW, conv3d kernels THWIO -> OITHW, dense kernels
  ``[in, out]`` -> ``[out, in]``; biases, norm scales and the generator's
  learned initial states (``init_state_{i}``) as they are. A
  ``ConvTranspose`` kernel maps as a conv kernel does: ``ConvTranspose2D``
  flips it and swaps its in/out axes for ``F.conv_transpose2d`` when it
  runs; ``Local2D``'s rank-6 ``kernel`` and ``SeparableLocal2D``'s
  ``vertical``/``horizontal`` keep their names and the JAX layout, which
  the port's layers read as they are;
  ``_SplitInputConv2D``'s single ``[k,k,C1+C2,F]`` kernel under
  ``mask_head/Conv_0`` becomes one ``[F,C1+C2,k,k]`` conv weight;
- the five LayerNorms of a ConvLSTM cell (``ln_i``, ``ln_f``, ``ln_g``,
  ``ln_o``, ``ln_c``) pack into its ``ln`` ``[10, C]``: scale then bias for
  i, f, g, o, c — the rows kernel K2 reads;
- each spectral ``u`` becomes the ``u`` buffer of its layer
  (``discriminator.video.sn_conv3d0.u``), for every discriminator and its
  ``_vae`` twin (``image``, ``video``, ``acvideo``); the learned prior's
  leaves under ``SAVPCell_0/prior`` become ``generator.cell.prior``; the
  frozen VGG16 of ``vgg_cdist_weight`` is outside ``params`` and outside the
  ``state_dict``.

Any subtree converts the same way (one layer's or one discriminator's
params give that module's ``state_dict``).

A whole JAX run directory carries over in two stages. Where jax is (the
TPU host, say), ``tools/export_jax_run.py RUN_DIR EXPORT_DIR [--step N]``
writes an export directory: the run's ``options.json``,
``model_hparams.json`` and ``dataset_hparams.json`` as they are, and
``jax_train_state.npz``, every leaf of the orbax train state under its
``/``-joined path (``params/...``, ``model_state/spectral/...``,
``opt_state_g/0/mu/...``, ``opt_state_g/0/nu/...``,
``opt_state_g/0/count``, ``opt_state_g/1/count``, the same under
``opt_state_d`` where there are discriminators, ``step``, ``rng``). Then,
where torch is::

    python -m video_prediction_torch.convert EXPORT_DIR --output_dir PORT_RUN_DIR

writes a run directory of the port (``train/checkpoint.py``): the three
JSON files as they are, and the exported step's checkpoint,
``checkpoints/<step>/params.pt`` and ``train_state.pt``, which
``generate``, ``evaluate`` and the
train CLI's ``--resume`` and ``--checkpoint`` read. ``train_state_from_jax``
does the mapping: the params and the spectral ``u`` as above; each optax
chain ``[scale_by_adam {count, mu, nu}, scale_by_schedule {count}]`` becomes
a ``torch.optim.Adam`` state keyed by parameter name
(``train/state.py#load_optimizer``), ``mu`` and ``nu`` through
``flax_to_state_dict`` (they have the params' tree, so the transposes and
the LayerNorm packing apply to them alike), the count Adam's ``step``. The
JAX key (``rng``, threefry) has no ``torch.Generator`` counterpart: the port
seeds the step noise with ``options.json``'s seed + 1, as
``train/state.py#create_train_state`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from video_prediction_torch.train.state import GEN_KEYS

JAX_STATE_FILE = "jax_train_state.npz"
RUN_FILES = ("options.json", "model_hparams.json", "dataset_hparams.json")

_RENAME = {"SAVPCell_0": "cell", "Conv2D_0": "conv"}
_DROPPED = ("Conv_0", "ConvTranspose_0", "_SpectralKernel_0")
_LN_GATES = ("ln_i", "ln_f", "ln_g", "ln_o", "ln_c")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _key(modules, leaf: str) -> str:
    return ".".join([_RENAME.get(m, m) for m in modules if m not in _DROPPED] + [leaf])


def flax_to_state_dict(params: Mapping[str, Any],
                       spectral: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    ln_rows: Dict[str, Dict[tuple, np.ndarray]] = {}
    for path, arr in _flatten(spectral or {}).items():
        *modules, leaf = path
        if leaf != "u":
            raise ValueError(f"unexpected spectral state {'/'.join(path)}")
        out[_key(modules, leaf)] = torch.tensor(arr)
    for path, arr in _flatten(params).items():
        *modules, leaf = path
        if modules and modules[-1] in _LN_GATES:
            ln_rows.setdefault(_key(modules[:-1], "ln"), {})[(modules[-1], leaf)] = arr
            continue
        if leaf == "kernel" and arr.ndim == 6:
            pass  # Local2D's [H,W,kh,kw,Cin,Cout]: the port keeps the JAX layout and the name
        elif leaf == "kernel":
            if arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)  # THWIO -> OITHW
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T  # [in, out] -> [out, in]
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        elif leaf not in ("bias", "scale", "vertical", "horizontal") and not leaf.startswith("init_state_"):
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[_key(modules, leaf)] = torch.tensor(arr)
    for key, rows in ln_rows.items():
        missing = [f"{g}/{leaf}" for g in _LN_GATES for leaf in ("scale", "bias") if (g, leaf) not in rows]
        if missing or len(rows) != 2 * len(_LN_GATES):
            raise ValueError(f"{key}: the ConvLSTM LayerNorms are not whole: missing {missing}, "
                             f"leaves {sorted('/'.join(r) for r in rows)}")
        packed = np.stack([rows[(g, leaf)] for g in _LN_GATES for leaf in ("scale", "bias")])
        out[key] = torch.tensor(packed)
    return out


def _nest(flat: Mapping[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def _adam(name: str, tree: Mapping[str, Any], step: int, params: Mapping[str, torch.Tensor]) -> Optional[dict]:
    """The optax chain state ``tree`` (``{"0": {count, mu, nu}, "1":
    {count}}`` by position) of ``params`` as a torch Adam state keyed by
    parameter name; None where there is neither."""
    if not tree and not params:
        return None
    adam, schedule = tree.get("0", {}), tree.get("1", {})
    unplaced = ([f"{name}/{k}" for k in tree if k not in ("0", "1")]
                + [f"{name}/0/{k}" for k in adam if k not in ("count", "mu", "nu")]
                + [f"{name}/1/{k}" for k in schedule if k != "count"])
    if unplaced:
        raise ValueError(f"leaves with no place in the port's train state: {unplaced}")
    for which, count in (("Adam", adam.get("count")), ("schedule", schedule.get("count"))):
        if count is None or np.ndim(count) or int(count) != step:
            raise ValueError(f"{name}: the {which} count {count} is not the step {step}")
    slots: Dict[str, Dict[str, torch.Tensor]] = {p: {"step": torch.tensor(float(step))} for p in params}
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        converted = flax_to_state_dict(adam.get(moment, {}))
        missing, orphans = sorted(set(params) - set(converted)), sorted(set(converted) - set(params))
        if missing:
            raise ValueError(f"{name}: parameters without their Adam {moment}: {missing}")
        if orphans:
            raise ValueError(f"{name}: Adam {moment} without its parameter: {orphans}")
        for p, v in converted.items():
            if v.shape != params[p].shape:
                raise ValueError(f"{name}: Adam {moment} of {p} has shape {tuple(v.shape)}, the parameter "
                                 f"{tuple(params[p].shape)}")
            slots[p][key] = v
    return {"state": slots, "param_groups": [{"params": list(params)}]}


def train_state_from_jax(flat: Mapping[str, np.ndarray], seed: int) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A JAX train state, flat by ``/``-joined path as the exporter writes
    it, as the port's ``(state_dict, train_state)``: ``state_dict`` the
    model's (the params file), ``train_state`` what
    ``train/checkpoint.py#save_train_state`` writes, with the generator's
    state the seed ``seed + 1``. Raises on a leaf it does not place, a
    ``model_state`` other than ``spectral``, an Adam moment without its
    parameter or the reverse, and an Adam or schedule count that is not the
    step."""
    trees: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {
        k: {} for k in ("params", "model_state", "opt_state_g", "opt_state_d")}
    scalars: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        top, *rest = path.split("/")
        if top in ("step", "rng") and not rest:
            scalars[top] = np.asarray(arr)
        elif top in trees and rest:
            trees[top][tuple(rest)] = np.asarray(arr)
        else:
            raise ValueError(f"leaf {path!r} has no place in the port's train state")
    if "step" not in scalars:
        raise ValueError("the JAX train state has no step")
    step = int(scalars["step"])
    params, model_state = _nest(trees["params"]), _nest(trees["model_state"])
    others = sorted(set(model_state) - {"spectral"})
    if others:
        raise ValueError(f"model_state subtrees the port does not hold: {others}")
    tops = sorted(set(params) - set(GEN_KEYS) - {"discriminator"})
    if tops:
        raise ValueError(f"params subtrees outside the generator and discriminator sides: {tops}")
    named = flax_to_state_dict(params)
    state_dict = flax_to_state_dict(params, {"discriminator": model_state.get("spectral", {})})
    sides = {"opt_state_g": {k: v for k, v in named.items() if k.split(".")[0] in GEN_KEYS},
             "opt_state_d": {k: v for k, v in named.items() if k.split(".")[0] == "discriminator"}}
    train_state = {"step": step, "model": state_dict, "rng": seed + 1}
    for tree, key in (("opt_state_g", "opt_g"), ("opt_state_d", "opt_d")):
        train_state[key] = _adam(tree, _nest(trees[tree]), step, sides[tree])
    return state_dict, train_state


def convert_run(export_dir: str, output_dir: str) -> dict:
    """Write the port run directory ``output_dir`` from the export directory
    ``export_dir`` (the module docstring): the option files and the
    checkpoint of the exported step. The JSON files must parse with the
    port's hparams. Returns the step, the seconds it took and the files'
    sizes in bytes."""
    from video_prediction_torch.configs.hparams import (DatasetHparams, ModelHparams, apply_overrides,
                                                          load_hparams_json)
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, TRAIN_STATE_FILE, checkpoint_file, save_step

    t0 = time.perf_counter()
    apply_overrides(ModelHparams(), load_hparams_json(os.path.join(export_dir, "model_hparams.json")))
    apply_overrides(DatasetHparams(), load_hparams_json(os.path.join(export_dir, "dataset_hparams.json")))
    with open(os.path.join(export_dir, "options.json")) as f:
        seed = int(json.load(f)["seed"])
    with np.load(os.path.join(export_dir, JAX_STATE_FILE)) as npz:
        flat = {k: npz[k] for k in npz.files}
    state_dict, train_state = train_state_from_jax(flat, seed)
    os.makedirs(output_dir, exist_ok=True)
    for name in RUN_FILES:
        shutil.copyfile(os.path.join(export_dir, name), os.path.join(output_dir, name))
    step = train_state["step"]
    if not save_step(output_dir, step, lambda: {PARAMS_FILE: state_dict, TRAIN_STATE_FILE: train_state}):
        raise FileExistsError(f"{output_dir} keeps a checkpoint of step {step} already")
    sizes = {name: os.path.getsize(checkpoint_file(output_dir, name, step)) for name in (PARAMS_FILE, TRAIN_STATE_FILE)}
    sizes[JAX_STATE_FILE] = os.path.getsize(os.path.join(export_dir, JAX_STATE_FILE))
    return {"step": step, "seconds": time.perf_counter() - t0, "bytes": sizes}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Convert an exported JAX run directory (tools/export_jax_run.py) "
                                "into a run directory of the port.")
    p.add_argument("export_dir")
    p.add_argument("--output_dir", required=True, help="the port run directory to write")
    args = p.parse_args(argv)
    out = convert_run(args.export_dir, args.output_dir)
    sizes = ", ".join(f"{name} {n / 2**20:.1f} MiB" for name, n in out["bytes"].items())
    print(f"converted step {out['step']} of {args.export_dir} into {args.output_dir} in {out['seconds']:.2f} s: "
          f"{sizes}")
    return out


if __name__ == "__main__":
    main()
