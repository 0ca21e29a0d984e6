"""The port's shell drivers (``video_prediction_torch/scripts/{train,evaluate}_all.sh``,
copies of ``scripts/{train,evaluate}_all.sh`` that call ``python -m
video_prediction_torch.{train,evaluate}``): ``evaluate_all.sh`` over a runs
root that holds one tiny CPU run and a directory without ``options.json``;
``train_all.sh``'s variant-to-model mapping read from both scripts, and the
commands it runs for every variant of a zoo, recorded by a stand-in
``python``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_prediction_torch.train.__main__ import main as train_main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_SCRIPTS = REPO / "video_prediction_torch" / "scripts"
ZOO = REPO / "hparams" / "bair_action_free" / "ours_savp" / "model_hparams.json"
SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4"
TIMEOUT = 300


def _env(bin_dir: Path) -> dict:
    """The environment with ``bin_dir`` first on PATH."""
    return {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}


def _case_block(script: Path) -> str:
    return re.search(r'case "\$variant" in\n(.*?)\n\s*esac', script.read_text(), re.S).group(1)


def test_train_all_maps_variants_to_models_as_the_jax_script():
    port, jax_script = _case_block(PORT_SCRIPTS / "train_all.sh"), _case_block(REPO / "scripts" / "train_all.sh")
    assert port == jax_script
    assert "dna*) model=dna" in port and "*) model=savp" in port


def test_train_all_runs_the_port_cli_for_every_variant(tmp_path):
    """A stand-in ``python`` records each call: ``-m video_prediction_torch.train``
    on every variant of ``hparams/bair`` with its model, its JSON, its run
    directory and the extra flags, and the repository on ``PYTHONPATH``."""
    bin_dir, log = tmp_path / "bin", tmp_path / "calls.txt"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(f'#!/usr/bin/env bash\necho "$PYTHONPATH|$*" >> {log}\n')
    stub.chmod(0o755)
    proc = subprocess.run(["bash", str(PORT_SCRIPTS / "train_all.sh"), "bair", "/data/bair", str(tmp_path / "runs"),
                           "--max_steps", "3", "--device", "cpu"], env=_env(bin_dir), capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    variants = sorted(p.name for p in (REPO / "hparams" / "bair").iterdir() if (p / "model_hparams.json").is_file())
    calls = log.read_text().splitlines()
    assert len(calls) == len(variants) == proc.stdout.count("=== bair/")
    for variant, call in zip(variants, calls):
        pythonpath, args = call.split("|")
        assert pythonpath.split(os.pathsep)[0] == str(REPO)
        model = next(m for prefix, m in (("dna", "dna"), ("sna", "sna"), ("sv2p", "sv2p"), ("", "savp"))
                     if variant.startswith(prefix))
        json_path = REPO / "hparams" / "bair" / variant / "model_hparams.json"
        args = args.split()
        assert args[:8] == ["-m", "video_prediction_torch.train", "--dataset", "bair", "--input_dir", "/data/bair",
                            "--model", model]
        assert args[8] == "--model_hparams_dict" and Path(args[9]).resolve() == json_path
        assert args[10:] == ["--output_dir", f"{tmp_path}/runs/bair/{variant}", "--max_steps", "3", "--device", "cpu"]


def test_train_all_refuses_an_unknown_dataset(tmp_path):
    proc = subprocess.run(["bash", str(PORT_SCRIPTS / "train_all.sh"), "nope", "", str(tmp_path)],
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 1 and "no hparams zoo for dataset 'nope'" in proc.stderr


def test_evaluate_all_evaluates_each_run_of_a_runs_root(tmp_path):
    runs = tmp_path / "runs" / "synthetic"
    summary = train_main(["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO),
                          "--model_hparams", SMALL, "--output_dir", str(runs / "ours_savp"), "--max_steps", "1",
                          "--batch_size", "2", "--device", "cpu", "--no_tensorboard"])
    assert summary["step"] == 1
    (runs / "not_a_run").mkdir()  # no options.json: skipped
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    python = bin_dir / "python"  # this interpreter (and its environment), whatever PATH holds
    python.write_text(f'#!/usr/bin/env bash\nexec "{sys.executable}" "$@"\n')
    python.chmod(0o755)
    results = tmp_path / "results"
    proc = subprocess.run(["bash", str(PORT_SCRIPTS / "evaluate_all.sh"), str(runs), "", str(results),
                           "--device", "cpu", "--batch_size", "2", "--num_samples", "2",
                           "--num_stochastic_samples", "2"], cwd=tmp_path, env=_env(bin_dir), capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.count("=== evaluating") == 1
    out = results / "synthetic" / "savp"
    for stem in ("psnr_avg", "psnr_max", "ssim_avg", "ssim_max"):
        values = np.loadtxt(out / f"{stem}.txt")
        assert values.shape == (2, 3) and np.isfinite(values).all(), stem  # 2 examples x 3 frames predicted
    assert (out / "index.html").is_file()


def test_convergence_rehearses_on_the_cpu_and_repeat_scores_as_in_jax(tmp_path):
    """``convergence.sh`` at a small width on the CPU (2 steps, one seed): a
    trained run and ``repeat`` each print their best-of-4 means over 64 test
    sequences, finite; ``repeat`` does not depend on the model, and on the
    port's synthetic stream (the JAX package's bytes) it scores the JAX
    package's 14.83 dB / 0.662 (``ARCHITECTURE.md``'s convergence table)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    python = bin_dir / "python"
    python.write_text(f'#!/usr/bin/env bash\nexec "{sys.executable}" "$@"\n')
    python.chmod(0o755)
    env = {**_env(bin_dir), "STEPS": "2", "DEVICE": "cpu", "BATCH": "2", "MODEL_HPARAMS": "ngf=4,nef=8,ndf=4,nz=4"}
    proc = subprocess.run(["bash", str(PORT_SCRIPTS / "convergence.sh"), str(tmp_path / "runs"), "7"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    found = re.findall(r"^convergence (\w+): psnr_max (\S+) ssim_max (\S+)$", proc.stdout, re.M)
    lines = {name: (float(p), float(q)) for name, p, q in found}
    assert sorted(lines) == ["repeat", "seed7"] and np.isfinite(list(lines.values())).all()
    assert "convergence seed7: trained 2 steps" in proc.stdout
    psnr, ssim = lines["repeat"]
    assert round(psnr, 2) == 14.83 and round(ssim, 3) == 0.662


def test_convergence_stage_b_rehearses_legs_a_kill_and_the_curves_on_the_cpu(tmp_path):
    """``STAGE=b convergence.sh`` at a small width on the CPU: legs stopped at
    step 4 and 12 (``--steps_per_call 4``, ``--save_freq 4``), each evaluated;
    the leg past step 8 killed with SIGKILL once step 8 is kept and resumed
    from the newest kept step; the run keeps three steps; the curves read
    from the event files every 4 steps, and d_loss before the crossover."""
    from video_prediction_torch.train.checkpoint import kept_steps

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    python = bin_dir / "python"
    python.write_text(f'#!/usr/bin/env bash\nexec "{sys.executable}" "$@"\n')
    python.chmod(0o755)
    env = {**_env(bin_dir), "STAGE": "b", "STEPS": "12", "STOPS": "4", "SAVE_FREQ": "4", "KILL_AFTER": "8",
           "KILL_DELAY": "0", "SUMMARY_FREQ": "4", "DEVICE": "cpu", "BATCH": "2",
           "MODEL_HPARAMS": "ngf=4,nef=8,ndf=4,nz=4"}
    proc = subprocess.run(["bash", str(PORT_SCRIPTS / "convergence.sh"), str(tmp_path / "runs"), "7"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    found = re.findall(r"^convergence (\w+): psnr_max (\S+) ssim_max (\S+)$", proc.stdout, re.M)
    lines = {name: (float(p), float(q)) for name, p, q in found}
    assert sorted(lines) == ["b_seed7_step12", "b_seed7_step4", "repeat"] and np.isfinite(list(lines.values())).all()
    assert re.search(r"^convergence b_seed7: killed with SIGKILL 0 s after step 8 was kept; resuming from step "
                     r"(8|12)$", proc.stdout, re.M), proc.stdout
    assert "convergence b_seed7: trained to step 12" in proc.stdout
    assert kept_steps(str(tmp_path / "runs" / "b_seed7")) == [4, 8, 12]
    curve_steps = [int(n) for n in re.findall(r"^curve step (\d+): g_loss=\S+ d_loss=\S+", proc.stdout, re.M)]
    assert curve_steps == [4, 8, 12], proc.stdout
    assert re.search(r"^curve d_loss before the crossover \(step None\): mean \S+ over \d+ summaries", proc.stdout,
                     re.M)


@pytest.mark.parametrize("script", ["train_all.sh", "evaluate_all.sh", "convergence.sh"])
def test_the_drivers_are_executable_and_parse(script):
    path = PORT_SCRIPTS / script
    assert os.access(path, os.X_OK)
    assert subprocess.run(["bash", "-n", str(path)], timeout=60).returncode == 0
