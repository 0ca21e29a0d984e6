"""The import guard: a subprocess rehearses every cell, and so each kind of
traffic, at a tiny size on the CPU through the harness's own functions
(``benchmark/rehearse.py``), and no module whose top-level name is ``jax``,
``jaxlib``, ``flax``, ``optax``, ``orbax`` or ``video_prediction_tpu`` may
be loaded in it (compared whole: ``video_prediction_torch`` is the port)."""

import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import common

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compare_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "video_prediction_tpu.models",
              "video_prediction_torch", "video_prediction_torch.models", "jaxtyping", "optax_like", "orbax.checkpoint"]
    assert common.forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                                "orbax.checkpoint", "video_prediction_tpu.models"]


def test_rehearsal_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-m", "benchmark.rehearse", "--trace"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    kinds = {common.resolve(common.benchmark_spec(), w)[2]["kind"] for w in line["cells"]}
    assert kinds == {"train", "generate", "evaluate"}
    for cell, r in line["cells"].items():
        assert r["attempted"] >= 1 and r["metrics"], cell


def test_no_card_no_result():
    """Without a CUDA device a run exits with code 2 and prints no result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "savp_bair64.generate_b8x8", "--seed",
                          str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == "", (out.returncode, out.stdout[-500:])
