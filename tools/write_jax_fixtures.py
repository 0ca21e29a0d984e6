#!/usr/bin/env python
"""Write the JAX-made fixtures that the port's tests and ``chip_smoke.py``
read (the GPU machine has no jax).

    python tools/write_jax_fixtures.py [--out tests/fixtures]

Runs the JAX package on the CPU and writes:

- ``jax_run_small/``: the export directory (``tools/export_jax_run.py``) of a
  ``bair_action_free/ours_savp`` run at a small width (``SMALL``, 32 px
  synthetic clips) taken to step 3, and ``steps.npz``: the batches of steps
  3 and 4, the JAX train step's noise at those steps (``step_noise``) and
  JAX's ``g_loss`` and ``d_loss`` of those two steps;
- ``jax_state_shapes/<config>.json``: for each of ``FULL_WIDTH``, the option
  files the JAX train CLI writes and every leaf of the exported train state
  (path, shape, dtype) at full width, from ``jax.eval_shape`` (nothing is
  compiled).

``tests/test_torch_jax_run.py`` builds the same run and the same shapes
afresh with these functions and holds the files to them. ``mesh_run``, the
small run trained and saved on a device mesh, writes no file here:
``tests/test_torch_jax_mesh_run.py`` runs it where jax is.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for path in (ROOT, TOOLS):
    if path not in sys.path:
        sys.path.insert(0, path)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from export_jax_run import RUN_FILES, export_run, flatten  # noqa: E402
from video_prediction_tpu.configs import hparams as jhp  # noqa: E402
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset  # noqa: E402
from video_prediction_tpu.models import get_model_class  # noqa: E402
from video_prediction_tpu.train import create_train_state, make_train_step  # noqa: E402
from video_prediction_tpu.train.checkpoint import CheckpointManager  # noqa: E402

# the small run: tests/test_torch_train.py's widths, with a rolled time scan
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2, scan_unroll=1)
SMALL_SIZE = 32
SAVED_STEP = 3  # the run's checkpoint; then steps 3 and 4 (0-based) on
RUN_STEPS = 5
MESH_BATCH = 4  # mesh_run's global batch: mesh_for_batch(4, spatial=2) on 8 devices is data 4 x spatial 2
MESH_SAVED_STEPS = (2, SAVED_STEP)  # mesh_run's checkpoints
SEED = 0
# full width: (zoo directory, zoo file, model, extra hparams, the dataset the run trains on);
# chip_smoke.py's OBJECTIVES on bair/ours_savp
OBJECTIVES = dict(learn_prior=True, z_l1_weight=1.0, image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1,
                  acvideo_sn_gan_weight=0.1, acvideo_sn_vae_gan_weight=0.1, vgg_cdist_weight=1.0)
FULL_WIDTH = {
    "bair_action_free_ours_savp": ("bair_action_free", "ours_savp", "savp", {}, "bair"),
    "synthetic_ours_savp": ("synthetic", "ours_savp", "savp", {}, "synthetic"),
    "bair_dna_l2": ("bair", "dna_l2", "dna", {}, "bair"),
    "bair_ours_savp_objectives": ("bair", "ours_savp", "savp", OBJECTIVES, "bair"),
}
VGG_FILE = "vgg16.npz"  # the name the objectives config's vgg_weights_path stands for in its shape file
FULL_BATCH = 2  # the batch the shapes are taken at (no parameter depends on it)
ACTION_DIM, STATE_DIM = 4, 3  # the synthetic and BAIR clips'


def dataset_hparams(dataset: str, hp) -> jhp.DatasetHparams:
    """The dataset hparams ``scripts/train.py`` writes for ``hp``."""
    dhp = jhp.DatasetHparams(context_frames=hp.context_frames, sequence_length=hp.sequence_length)
    return dhp.replace(use_state=True) if dataset == "bair" and hp.use_states else dhp


def write_options(run_dir: str, model: str, dataset: str, hp, dhp) -> None:
    """The three option files, as ``scripts/train.py`` writes them."""
    os.makedirs(run_dir, exist_ok=True)
    for name, obj in zip(RUN_FILES, ({"model": model, "dataset": dataset, "seed": SEED}, hp.to_dict(),
                                     dhp.to_dict())):
        with open(os.path.join(run_dir, name), "w") as f:
            json.dump(obj, f, indent=2)


def save_state(ts, run_dir: str) -> None:
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    mgr.save(ts)
    mgr.wait()
    mgr.close()


# ---- the small run ------------------------------------------------------- #

def small_hparams(config: str):
    name = "sv2p" if config == "sv2p" else "savp"
    zoo = jhp.zoo_dir() / "bair_action_free" / config / "model_hparams.json"
    return name, jhp.resolve_model_hparams(get_model_class(name).default_hparams(), str(zoo), extra=SMALL)


def small_batches() -> List[Dict[str, np.ndarray]]:
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=SMALL_SIZE).make_iterator(SMALL["batch_size"])
    t = SMALL["sequence_length"]
    return [{k: v[:, :t] for k, v in next(it).items() if k in ("images", "actions")} for _ in range(RUN_STEPS)]


def step_noise(rng, step: int, hp, b: int, t: int) -> Dict[str, np.ndarray]:
    """The JAX train step's noise at ``step`` (its key chain: ``fold_in(rng,
    step)``, split into forward and clip keys, the forward key into
    scheduled sampling, posterior and prior), as numpy arrays."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, step))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    tz = 1 if hp.latent_time_invariant else t - 1
    return {
        "use_gt_u": np.array(jax.random.uniform(rng_ss, (t - 1, b))),
        "eps_q": np.array(jax.random.normal(rng_q, (b, tz, hp.nz))),
        "z_p": np.array(jax.random.normal(rng_p, (b, tz, hp.nz))),
        "clip_start": np.array(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }


def _perturbed_state(model, batch: Dict[str, np.ndarray]):
    """``create_train_state`` from ``SEED`` with each leaf of the params moved
    off its init value (a numpy seed)."""
    ts = create_train_state(model, jax.random.PRNGKey(SEED), {k: jnp.asarray(v) for k, v in batch.items()})
    rs = np.random.RandomState(0)
    return ts.replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * (1.0 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
                              + 0.05 * rs.randn(*a.shape).astype(np.float32)),
        ts.params,
    ))


def small_run(config: str, run_dir: str) -> Dict[str, Any]:
    """A JAX run directory of ``config`` at ``SMALL`` in ``run_dir``: the
    weights of ``create_train_state`` from ``SEED``, each leaf moved off its
    init value, then ``RUN_STEPS`` train steps, the orbax checkpoint written
    at step ``SAVED_STEP``. Returns the batches, each step's noise and
    ``(g_loss, d_loss)``, and the train state after the last step (``final``,
    flat by the exporter's paths)."""
    model_name, hp = small_hparams(config)
    model = get_model_class(model_name)(hp, mode="train")
    batches = small_batches()
    ts = _perturbed_state(model, batches[0])
    write_options(run_dir, model_name, "synthetic", hp, dataset_hparams("synthetic", hp))
    step = make_train_step(model, donate=False)
    losses = []
    for i, batch in enumerate(batches):
        if i == SAVED_STEP:
            save_state(ts, run_dir)
        ts, scalars = step(ts, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
    b, t = batches[0]["images"].shape[:2]
    return {"batches": batches, "losses": losses, "noise": [step_noise(ts.rng, i, hp, b, t) for i in range(RUN_STEPS)],
            "final": flatten(saveable(ts)), "hparams": hp, "model": model_name}


def mesh_run(config: str, run_dir: str) -> Dict[str, Any]:
    """``small_run`` on a device mesh: the weights of ``small_run``, then
    ``RUN_STEPS`` train steps at the global batch ``MESH_BATCH`` through
    ``make_train_step(model, mesh=mesh_for_batch(MESH_BATCH, spatial=2))``
    (data 4 x spatial 2 on 8 devices: the batch sharded over the data axis,
    image height over the spatial one, the state replicated), the orbax
    checkpoint written by one ``CheckpointManager`` at each of
    ``MESH_SAVED_STEPS``. Returns ``small_run``'s fields, and ``saved``: the
    state at each saved step, flat by the exporter's paths."""
    from video_prediction_tpu.parallel.mesh import mesh_for_batch, shard_batch

    model_name, hp = small_hparams(config)
    hp = hp.replace(batch_size=MESH_BATCH)
    model = get_model_class(model_name)(hp, mode="train")
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=SMALL_SIZE).make_iterator(MESH_BATCH)
    t = SMALL["sequence_length"]
    batches = [{k: v[:, :t] for k, v in next(it).items() if k in ("images", "actions")} for _ in range(RUN_STEPS)]
    ts = _perturbed_state(model, batches[0])
    write_options(run_dir, model_name, "synthetic", hp, dataset_hparams("synthetic", hp))
    mesh = mesh_for_batch(MESH_BATCH, spatial=2)
    step = make_train_step(model, mesh=mesh, donate=False)
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    losses, saved = [], {}
    try:
        for i, batch in enumerate(batches):
            if i in MESH_SAVED_STEPS:
                assert mgr.save(ts)
                saved[i] = flatten(saveable(ts))
            ts, scalars = step(ts, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
            losses.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
        mgr.wait()
    finally:
        mgr.close()
    b = batches[0]["images"].shape[0]
    return {"batches": batches, "losses": losses, "noise": [step_noise(ts.rng, i, hp, b, t) for i in range(RUN_STEPS)],
            "final": flatten(saveable(ts)), "saved": saved, "hparams": hp, "model": model_name,
            "mesh": dict(mesh.shape)}


def steps_arrays(run: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``steps.npz``: step k's batch, noise and JAX losses (k = 3, 4) under
    ``step<k>/...``."""
    out = {}
    for k in range(SAVED_STEP, RUN_STEPS):
        out.update({f"step{k}/{key}": v for key, v in run["batches"][k].items()})
        out.update({f"step{k}/noise/{key}": v for key, v in run["noise"][k].items()})
        out[f"step{k}/g_loss"], out[f"step{k}/d_loss"] = (np.float64(x) for x in run["losses"][k])
    return out


# ---- full-width shapes ---------------------------------------------------- #

def full_width_hparams(config: str, vgg_path: str = VGG_FILE):
    zoo_set, zoo, model_name, extra, dataset = FULL_WIDTH[config]
    if extra.get("vgg_cdist_weight"):
        extra = dict(extra, vgg_weights_path=vgg_path)
    path = jhp.zoo_dir() / zoo_set / zoo / "model_hparams.json"
    hp = jhp.resolve_model_hparams(get_model_class(model_name).default_hparams(), str(path), extra=extra or None)
    return dataset, model_name, hp


def write_vgg_weights(path: str) -> None:
    """A VGG16 ``.npz`` of zeros in the layout both packages read: the
    objectives config's models read it when built; no value is used here."""
    vgg, c_in = {}, 3
    for block, n_convs, ch in [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]:
        for i in range(1, n_convs + 1):
            vgg[f"conv{block}_{i}/kernel"] = np.zeros((3, 3, c_in, ch), np.float32)
            vgg[f"conv{block}_{i}/bias"] = np.zeros((ch,), np.float32)
            c_in = ch
    np.savez_compressed(path, **vgg)


def full_width_batch(hp) -> Dict[str, np.ndarray]:
    b, t = FULL_BATCH, hp.sequence_length
    return {"images": np.zeros((b, t, 64, 64, 3), np.uint8), "actions": np.zeros((b, t, ACTION_DIM), np.float32),
            "states": np.zeros((b, t, STATE_DIM), np.float32)}


def train_state_shapes(model, batch: Dict[str, np.ndarray]):
    """``create_train_state`` as a tree of ``jax.ShapeDtypeStruct``."""
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    return jax.eval_shape(functools.partial(create_train_state, model), jax.random.PRNGKey(SEED), specs)


def saveable(ts) -> Dict[str, Any]:
    """The tree the JAX package's checkpoint writes (``_to_saveable``), each
    optax state as the dict of its fields that a restore without a template
    returns."""
    def plain(tree):
        if hasattr(tree, "_asdict"):
            return {k: plain(v) for k, v in tree._asdict().items()}
        if isinstance(tree, (list, tuple)):
            return [plain(v) for v in tree]
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        return tree

    return {"step": ts.step, "params": ts.params, "model_state": ts.model_state,
            "opt_state_g": plain(ts.opt_state_g), "opt_state_d": plain(ts.opt_state_d), "rng": ts.rng}


def leaf_table(tree) -> Dict[str, list]:
    """``{path: [shape, dtype]}`` of every leaf, by the exporter's paths."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            out[prefix] = [list(node.shape), str(np.dtype(node.dtype))]

    walk(tree, "")
    return out


def state_shapes(config: str, vgg_path: str) -> Dict[str, Any]:
    """The shape file of ``config``: the option files and the leaf table."""
    dataset, model_name, hp = full_width_hparams(config, vgg_path)
    dhp = dataset_hparams(dataset, hp)
    model = get_model_class(model_name)(hp, mode="train")
    leaves = leaf_table(saveable(train_state_shapes(model, full_width_batch(hp))))
    hp_dict = hp.to_dict()
    if hp.vgg_cdist_weight:
        hp_dict["vgg_weights_path"] = VGG_FILE
    return {"options": {"model": model_name, "dataset": dataset, "seed": SEED}, "model_hparams": hp_dict,
            "dataset_hparams": dhp.to_dict(), "leaves": leaves}


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures"))
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    with tempfile.TemporaryDirectory() as tmp:
        run = small_run("ours_savp", os.path.join(tmp, "run"))
        small_dir = os.path.join(args.out, "jax_run_small")
        shutil.rmtree(small_dir, ignore_errors=True)
        export_run(os.path.join(tmp, "run"), small_dir, SAVED_STEP)
        np.savez(os.path.join(small_dir, "steps.npz"), **steps_arrays(run))
        vgg = os.path.join(tmp, VGG_FILE)
        write_vgg_weights(vgg)
        shape_dir = os.path.join(args.out, "jax_state_shapes")
        os.makedirs(shape_dir, exist_ok=True)
        for config in FULL_WIDTH:
            with open(os.path.join(shape_dir, f"{config}.json"), "w") as f:
                json.dump(state_shapes(config, vgg), f, indent=1, sort_keys=True)
    print(f"wrote {small_dir} and {shape_dir}")


if __name__ == "__main__":
    main()
