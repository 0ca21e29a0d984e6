"""A JAX run directory written on a device mesh, carried into the port, on
the CPU: ``tools/write_jax_fixtures.py#mesh_run`` trains the small
``bair_action_free/ours_savp`` run at a global batch of 4 through
``make_train_step(model, mesh=mesh_for_batch(4, spatial=2))`` on the JAX
tests' 8 CPU devices (data 4 x spatial 2: the batch and the image height
sharded, the state replicated) and saves it with the JAX
``CheckpointManager`` at steps 2 and 3. The exporter
(``tools/export_jax_run.py``) reads step 3 here and step 2 in a process
with one device, which the mesh's shardings do not name; the converter
writes each as the port's step; the port resumes step 3 and takes steps 3
and 4 with the JAX step's own noise, held to
``tests/test_torch_jax_run.py``'s tolerances: the losses within
``TRAJ_RTOL`` of the JAX mesh run's, every parameter within the leaf rule
(Adam's bound where JAX's second moment says the gradient is rounding
noise), Adam's step 5.

All JAX-side work is in the module fixture ``mesh_side``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_jax_run import (
    GRAD_FLOOR,
    GRAD_TOL,
    TRAJ_RTOL,
    _nested,
    _run_dir_model,
    _torch_batch,
    _torch_noise,
    export_jax_run,
    fx,
)

from video_prediction_torch.convert import JAX_STATE_FILE, convert_run, flax_to_state_dict
from video_prediction_torch.train.checkpoint import kept_steps, load_params, load_train_state
from video_prediction_torch.train.state import create_train_state
from video_prediction_torch.train.step import make_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXPORT_TIMEOUT = 240  # seconds for the one-device exporter process


@pytest.fixture(scope="module")
def mesh_side(tmp_path_factory):
    """The mesh run, its step-3 export (8 devices) and step-2 export (a
    process with one device)."""
    tmp = tmp_path_factory.mktemp("mesh_side")
    run = fx.mesh_run("ours_savp", str(tmp / "run"))
    run["steps"] = export_jax_run.checkpoint_steps(str(tmp / "run"))
    run["export"] = tmp / "export3"
    assert export_jax_run.export_run(str(tmp / "run"), str(run["export"])) == fx.SAVED_STEP
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    run["export2"] = tmp / "export2"
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "export_jax_run.py"), str(tmp / "run"),
                           str(run["export2"]), "--step", "2"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=EXPORT_TIMEOUT)
    run["export2_proc"] = proc
    return run


def test_the_run_is_sharded_and_keeps_both_steps(mesh_side):
    assert mesh_side["mesh"] == {"data": 4, "model": 2}
    assert mesh_side["steps"] == list(fx.MESH_SAVED_STEPS)
    assert all(np.isfinite(mesh_side["losses"]).ravel())


def test_a_host_with_one_device_exports_the_mesh_written_step(mesh_side):
    """The orbax arrays carry the 8-device mesh's shardings; the exporter
    reads them as host arrays, so one device does: the step-2 export holds
    every leaf of the state the run saved at step 2, bit for bit."""
    proc = mesh_side["export2_proc"]
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "exported step 2" in proc.stdout
    with np.load(mesh_side["export2"] / JAX_STATE_FILE) as npz:
        got = {k: npz[k] for k in npz.files}
    want = mesh_side["saved"][2]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], np.asarray(v)), k


@pytest.mark.parametrize("step", fx.MESH_SAVED_STEPS)
def test_each_saved_step_converts_and_loads_strictly(mesh_side, tmp_path, step):
    export = mesh_side["export2" if step == 2 else "export"]
    out = convert_run(str(export), str(tmp_path / "port"))
    assert out["step"] == step and kept_steps(str(tmp_path / "port")) == [step]
    model = _run_dir_model(tmp_path / "port", mesh_side["batches"][0])
    ts = create_train_state(model, 0, "cpu")
    load_train_state(str(tmp_path / "port"), ts)  # strict: every key of the model and of both Adams
    load_params(str(tmp_path / "port"), model)
    assert ts.step == step
    ref = flax_to_state_dict(_nested(mesh_side["saved"][step])["params"])
    params = dict(model.named_parameters())
    assert sorted(ref) == sorted(params)
    assert all(torch.equal(params[k].detach(), v) for k, v in ref.items())


@pytest.fixture(scope="module")
def resumed(mesh_side, tmp_path_factory):
    """The port resumed from the converted step-3 directory, after steps 3
    and 4 on the mesh run's batches with the JAX step's noise."""
    port_dir = tmp_path_factory.mktemp("mesh_port") / "run"
    convert_run(str(mesh_side["export"]), str(port_dir))
    model = _run_dir_model(port_dir, mesh_side["batches"][0])
    ts = create_train_state(model, 0, "cpu")
    load_train_state(str(port_dir), ts)
    start = ts.step
    step = make_train_step(model)
    losses = []
    for k in range(fx.SAVED_STEP, fx.RUN_STEPS):
        scalars = step(ts, _torch_batch(mesh_side["batches"][k]), noise=_torch_noise(mesh_side["noise"][k]))
        losses.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
    return ts, start, losses


def test_resumed_steps_match_the_jax_mesh_run(mesh_side, resumed):
    ts, start, losses = resumed
    assert start == fx.SAVED_STEP and ts.step == fx.RUN_STEPS
    np.testing.assert_allclose(np.array(losses), np.array(mesh_side["losses"][fx.SAVED_STEP:]), rtol=TRAJ_RTOL)


def test_resumed_parameters_and_adam_steps_match_the_jax_mesh_run(mesh_side, resumed):
    """``tests/test_torch_jax_run.py``'s parameter rule: every parameter
    within the leaf rule of the JAX mesh run's, the weights whose gradient
    is rounding noise (JAX's second moment at most ``GRAD_FLOOR`` squared of
    the largest) within Adam's bound, 2 lr a step."""
    ts, _, _ = resumed
    final = _nested(mesh_side["final"])
    ref = flax_to_state_dict(final["params"])
    nu = {}
    for tree in ("opt_state_g", "opt_state_d"):
        nu.update(flax_to_state_dict(final[tree]["0"]["nu"]))
    params = dict(ts.model.named_parameters())
    assert sorted(nu) == sorted(ref) == sorted(params)
    nu_top = max(float(v.max()) for v in nu.values())
    top = max(float(v.abs().max()) for v in ref.values())
    adam_bound = 2.0 * ts.model.hparams.lr * (fx.RUN_STEPS - fx.SAVED_STEP)
    bad = []
    for name, r in ref.items():
        err = (params[name].detach() - r).abs()
        noise = nu[name] <= GRAD_FLOOR**2 * nu_top
        bound = GRAD_TOL * float(r.abs().max()) + GRAD_FLOOR * top
        if not bool((err <= torch.where(noise, adam_bound, bound)).all()):  # NaN fails too
            bad.append(f"{name}: max |d| {float(err.max()):.3g} ({int(noise.sum())} noise weights)")
    assert not bad, bad
    for opt in (ts.opt_g, ts.opt_d):
        assert {float(s["step"]) for s in opt.state.values()} == {float(fx.RUN_STEPS)}
