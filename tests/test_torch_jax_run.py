"""A JAX run directory carried into the port, on the CPU: the exporter
(``tools/export_jax_run.py``, where jax is) and the converter
(``video_prediction_torch/convert.py``, where torch is).

(a) JAX runs of ``bair_action_free/ours_savp`` (both Adams, spectral ``u``)
and ``ours_vae_l1`` (no discriminator: ``opt_state_d`` is ``()``) at
``tests/test_torch_train.py``'s small width, written by the JAX
``CheckpointManager`` at step 3, exported and converted; the port resumes and
takes steps 3 and 4 with the JAX step's own noise: the losses within
``TRAJ_RTOL`` of JAX's, every parameter within ``GRAD_TOL`` of its largest
entry plus ``GRAD_FLOOR`` of the model's largest, Adam's step 5.
(b) Full width, nothing compiled: ``jax.eval_shape`` of ``create_train_state``
for four zoo configurations, filled from a numpy seed, written by the real
orbax writer, exported and converted; every key loads strictly into the port
model and both Adams, and each leaf equals its source under the layout map.
(c) The converter's refusals. (d) ``generate``, ``evaluate``, ``train
--resume`` and ``train --checkpoint`` on a converted directory. (e) A
``train_state.pt`` with its Adam slots by position (the format before names)
still resumes. The fixtures that ``chip_smoke.py`` reads on the GPU machine
(``tests/fixtures/``, written by ``tools/write_jax_fixtures.py``) are held
against a fresh JAX run.

All JAX-side work is in the module fixture ``jax_side``.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import fill_jax_state
from video_prediction_torch import evaluate, generate
from video_prediction_torch.configs.hparams import apply_overrides, load_hparams_json
from video_prediction_torch.convert import JAX_STATE_FILE, convert_run, flax_to_state_dict, train_state_from_jax
from video_prediction_torch.models import get_model_class, input_dims
from video_prediction_torch.train import schedules
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_torch.train.checkpoint import (
    CHECKPOINT_DIR,
    PARAMS_FILE,
    TRAIN_STATE_FILE,
    checkpoint_file,
    load_params,
    load_train_state,
    save_train_state,
)
from video_prediction_torch.train.state import (
    create_train_state,
    load_optimizer,
    make_optimizers,
    optimizer_param_names,
)
from video_prediction_torch.train.step import make_train_step

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fx = _tool("write_jax_fixtures")  # puts tools/ on sys.path: export_jax_run imports as itself
import export_jax_run  # noqa: E402

torch.set_num_threads(1)

RESUMED = ["ours_savp", "ours_vae_l1"]
TRAJ_RTOL = 1e-4  # tests/test_torch_train.py's: Adam steps
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-5  # tests/test_torch_train.py's leaf rule
# the checked-in fixture against a fresh JAX run on this host: the losses by
# TRAJ_RTOL; the draws by float32 rounding; Adam's moments by the leaf rule;
# the parameters by the leaf rule plus one learning rate a step, the most an
# Adam step moves a weight, which rounding may send either way where the
# gradient is rounding noise (the conv biases in front of an instance norm)
NOISE_TOL = 1e-6
ENTRY_SEED = 3  # the converted directory of (d): a 64 px state at step 3


def _key_name(key):
    for attr in ("name", "key", "idx"):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    raise TypeError(key)


def _write_jax_state(shapes, values, run_dir):
    """The JAX ``TrainState`` ``shapes`` with the leaves of ``values`` (by
    exported path), written by the JAX package's ``CheckpointManager``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    filled = []
    for path, _ in leaves:
        name = "/".join(_key_name(k) for k in path)
        filled.append(values[name])
    fx.save_state(jax.tree_util.tree_unflatten(treedef, filled), run_dir)


def _filled_export(tmp, name, model_name, dataset, hp, batch, seed, step):
    """Fill ``create_train_state``'s shapes for ``hp`` from ``seed`` at
    ``step``, write it as a JAX run directory, export it. Returns the export
    directory, the leaf table and whether the export read back every value."""
    from video_prediction_tpu.models import get_model_class as j_get_model_class

    shapes = fx.train_state_shapes(j_get_model_class(model_name)(hp, mode="train"), batch)
    table = fx.leaf_table(fx.saveable(shapes))
    values = fill_jax_state({"leaves": table}, seed, step)
    run_dir, export_dir = tmp / f"{name}_run", tmp / f"{name}_export"
    fx.write_options(str(run_dir), model_name, dataset, hp, fx.dataset_hparams(dataset, hp))
    _write_jax_state(shapes, values, str(run_dir))
    export_jax_run.export_run(str(run_dir), str(export_dir))
    shutil.rmtree(run_dir)
    with np.load(export_dir / JAX_STATE_FILE) as npz:
        same = sorted(npz.files) == sorted(values) and all(
            npz[k].dtype == v.dtype and np.array_equal(npz[k], v) for k, v in values.items())
    return {"export": export_dir, "table": table, "exact": same, "hp": hp, "model": model_name}


class _JaxSide:
    """Everything JAX: (a)'s two runs, exported; (b)'s four full-width
    exports; (d)'s 64 px export; and the shape tables for the fixtures."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.vgg = str(tmp / fx.VGG_FILE)
        fx.write_vgg_weights(self.vgg)
        self.runs = {}
        for config in RESUMED:
            run = fx.small_run(config, str(tmp / f"{config}_run"))
            run["export"] = tmp / f"{config}_export"
            export_jax_run.export_run(str(tmp / f"{config}_run"), str(run["export"]))
            self.runs[config] = run
        self.full = {}
        self.shape_files = {}
        for i, config in enumerate(fx.FULL_WIDTH):
            dataset, model_name, hp = fx.full_width_hparams(config, self.vgg)
            self.full[config] = _filled_export(tmp, config, model_name, dataset, hp, fx.full_width_batch(hp),
                                               seed=i, step=1000)
            self.shape_files[config] = fx.state_shapes(config, self.vgg)
        _, hp = fx.small_hparams("ours_savp")
        batch = {k: v for k, v in fx.full_width_batch(hp).items() if k != "states"}
        self.entry = _filled_export(tmp, "entry", "savp", "synthetic", hp, batch, seed=ENTRY_SEED, step=3)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return _JaxSide(tmp_path_factory.mktemp("jax_side"))


def _run_dir_model(run_dir, batch):
    """The port model a run directory describes, for ``batch``'s shapes."""
    with open(os.path.join(run_dir, "options.json")) as f:
        name = json.load(f)["model"]
    cls = get_model_class(name)
    hp = apply_overrides(cls.default_hparams(), load_hparams_json(os.path.join(run_dir, "model_hparams.json")))
    return cls(hp, **input_dims(hp, batch))


def _nested(flat):
    """A flat ``{path: array}`` as nested dicts."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _torch_noise(noise):
    return {k: int(v) if k == "clip_start" else torch.from_numpy(np.asarray(v)) for k, v in noise.items()}


def _assert_leaf_rule(got, ref, tol, floor, extra=0.0, what=""):
    """max |got - ref| over each tensor within ``tol`` of its largest entry,
    plus ``floor`` of the largest over all of ``ref``, plus ``extra``."""
    top = max(float(v.abs().max()) for v in ref.values() if v.numel())
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        err = float((got[k].float() - r.float()).abs().max()) if r.numel() else 0.0
        assert err <= tol * float(r.abs().max()) + floor * top + extra, f"{what}{k}: max |d| {err:.3g}"


# ---- (a) resume a JAX run ---------------------------------------------------- #

@pytest.fixture(scope="module", params=RESUMED)
def resumed(request, jax_side, tmp_path_factory):
    """The port resumed from the converted step-3 directory of the JAX run,
    after its steps 3 and 4."""
    run = jax_side.runs[request.param]
    port_dir = tmp_path_factory.mktemp("port") / request.param
    convert_run(str(run["export"]), str(port_dir))
    model = _run_dir_model(port_dir, run["batches"][0])
    ts = create_train_state(model, 0, "cpu")
    load_train_state(str(port_dir), ts)
    start = ts.step
    step = make_train_step(model)
    losses = []
    for k in range(fx.SAVED_STEP, fx.RUN_STEPS):
        scalars = step(ts, _torch_batch(run["batches"][k]), noise=_torch_noise(run["noise"][k]))
        losses.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
    return run, ts, start, losses


def test_resumed_steps_match_jax(resumed):
    run, ts, start, losses = resumed
    assert start == fx.SAVED_STEP and ts.step == fx.RUN_STEPS
    np.testing.assert_allclose(np.array(losses), np.array(run["losses"][fx.SAVED_STEP:]), rtol=TRAJ_RTOL)


def test_resumed_parameters_and_adam_steps_match_jax(resumed):
    """Every parameter after the two steps within the leaf rule of JAX's,
    except the weights whose gradient is rounding noise (JAX's second moment
    of the weight at most ``GRAD_FLOOR`` squared of the model's largest: the
    conv biases in front of an instance norm, and the stem's weights on
    inputs constant over the image): Adam moves those by up to a learning
    rate a step, in either direction."""
    run, ts, _, _ = resumed
    final = _nested(run["final"])
    ref = flax_to_state_dict(final["params"])
    nu = {}
    for tree in ("opt_state_g", "opt_state_d"):
        nu.update(flax_to_state_dict(final.get(tree, {}).get("0", {}).get("nu", {})))
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
        if opt is not None:
            assert {float(s["step"]) for s in opt.state.values()} == {float(fx.RUN_STEPS)}
    assert (ts.opt_d is None) == ("discriminator" not in final["params"])


def test_converted_adam_holds_the_jax_moments(jax_side, tmp_path):
    """The converted Adams are the JAX step-3 moments, by parameter name, in
    the model's order however the flax tree orders them."""
    run = jax_side.runs["ours_savp"]
    with np.load(run["export"] / JAX_STATE_FILE) as npz:
        flat = {k: npz[k] for k in npz.files}
    _, state = train_state_from_jax(flat, seed=0)
    model = _run_dir_model(run["export"], run["batches"][0])
    for key, opt, tree in zip(("opt_g", "opt_d"), make_optimizers(model), ("opt_state_g", "opt_state_d")):
        assert sorted(state[key]["state"]) == sorted(optimizer_param_names(model, opt))
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref = flax_to_state_dict(_nested(flat)[tree]["0"][moment])
            for name, slots in state[key]["state"].items():
                assert torch.equal(slots[slot], ref[name]), (key, name, moment)
                assert float(slots["step"]) == fx.SAVED_STEP


# ---- (b) full width -------------------------------------------------------- #

@pytest.mark.parametrize("config", list(fx.FULL_WIDTH))
def test_full_width_state_loads_strictly(jax_side, tmp_path, config):
    full = jax_side.full[config]
    assert full["exact"], "the export does not read back the values written"
    out = convert_run(str(full["export"]), str(tmp_path / "port"))
    assert out["step"] == 1000
    model = _run_dir_model(tmp_path / "port", fx.full_width_batch(full["hp"]))
    ts = create_train_state(model, 0, "cpu")
    load_train_state(str(tmp_path / "port"), ts)  # strict: every key of the model and of both Adams
    load_params(str(tmp_path / "port"), model)
    assert ts.step == 1000
    with np.load(full["export"] / JAX_STATE_FILE) as npz:
        flat = {k: npz[k] for k in npz.files}
    nested = _nested(flat)
    ref = flax_to_state_dict(nested["params"], {"discriminator": nested.get("model_state", {}).get("spectral", {})})
    state = model.state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(state[k], v), k
    n_source = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    assert n_source == sum(p.numel() for p in model.parameters())
    adams = [(opt, tree) for opt, tree in ((ts.opt_g, "opt_state_g"), (ts.opt_d, "opt_state_d")) if opt is not None]
    assert sorted(tree for _, tree in adams) == sorted(k for k in nested if k.startswith("opt_state"))
    assert sum(len(opt.state) for opt, _ in adams) == len(list(model.parameters()))
    for opt, tree in adams:
        moments = {m: flax_to_state_dict(nested[tree]["0"][m]) for m in ("mu", "nu")}
        params = [p for group in opt.param_groups for p in group["params"]]
        for name, p in zip(optimizer_param_names(model, opt), params):
            slots = opt.state[p]
            assert float(slots["step"]) == 1000.0
            assert torch.equal(slots["exp_avg"], moments["mu"][name]), name
            assert torch.equal(slots["exp_avg_sq"], moments["nu"][name]), name
    del flat, nested, ref, state


# ---- (c) the converter's refusals ------------------------------------------- #

def _mutations():
    return {
        "unplaced leaf": (lambda f: f.update({"opt_state_g/2/count": np.int32(3)}), "no place"),
        "unplaced top-level leaf": (lambda f: f.update({"batch_stats/x": np.zeros(2, np.float32)}), "no place"),
        "model_state other than spectral": (
            lambda f: f.update({"model_state/batch_stats/mean": np.zeros(2, np.float32)}), "model_state"),
        "parameter without its moment": (
            lambda f: f.pop(next(k for k in sorted(f) if k.startswith("opt_state_g/0/mu/"))), "without their Adam mu"),
        "moment without its parameter": (
            lambda f: f.update({"opt_state_d/0/nu/discriminator/bogus/kernel": np.zeros((3, 2), np.float32)}),
            "without its parameter"),
        "adam count not the step": (lambda f: f.update({"opt_state_g/0/count": np.int32(4)}), "Adam count"),
        "schedule count not the step": (lambda f: f.update({"opt_state_d/1/count": np.int32(2)}), "schedule count"),
        "no step": (lambda f: f.pop("step"), "no step"),
    }


@pytest.mark.parametrize("case", list(_mutations()))
def test_converter_refuses(jax_side, case):
    mutate, match = _mutations()[case]
    with np.load(jax_side.runs["ours_savp"]["export"] / JAX_STATE_FILE) as npz:
        flat = {k: npz[k] for k in npz.files}
    train_state_from_jax(flat, seed=0)  # as exported: converts
    mutate(flat)
    with pytest.raises(ValueError, match=match):
        train_state_from_jax(flat, seed=0)


def test_converter_refuses_hparams_the_port_does_not_know(jax_side, tmp_path):
    export = tmp_path / "export"
    shutil.copytree(jax_side.runs["ours_savp"]["export"], export)
    hp = json.loads((export / "model_hparams.json").read_text())
    hp["bogus"] = 1
    (export / "model_hparams.json").write_text(json.dumps(hp))
    with pytest.raises(ValueError, match="bogus"):
        convert_run(str(export), str(tmp_path / "port"))


# ---- (d) the entry points on a converted directory ------------------------------ #

@pytest.fixture(scope="module")
def entry_dir(jax_side, tmp_path_factory):
    port = tmp_path_factory.mktemp("entry") / "run"
    convert_run(str(jax_side.entry["export"]), str(port))
    return port


def test_generate_and_evaluate_read_a_converted_run(entry_dir, tmp_path):
    gen = generate.main(["--checkpoint", str(entry_dir), "--results_dir", str(tmp_path / "gen"), "--device", "cpu",
                         "--batch_size", "2", "--num_samples", "2"])
    assert gen["all_finite"] and gen["gifs"]
    out = evaluate.main(["--checkpoint", str(entry_dir), "--results_dir", str(tmp_path / "eval"), "--device", "cpu",
                         "--batch_size", "2", "--num_samples", "2", "--num_stochastic_samples", "2"])
    assert out["no_nan"] and out["rollouts"]


def test_train_resumes_a_converted_run(entry_dir, tmp_path, capsys):
    """``--resume`` on the converted directory: "resumed from step 3", and
    the learning-rate, KL-anneal and scheduled-sampling schedules go on at
    step 3; Adam's steps read 4 after one step."""
    run = tmp_path / "run"
    shutil.copytree(entry_dir, run)
    hp = apply_overrides(get_model_class("savp").default_hparams(), load_hparams_json(run / "model_hparams.json"))
    out = train_main(["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict",
                      str(run / "model_hparams.json"), "--output_dir", str(run), "--resume", "--device", "cpu",
                      "--max_steps", "4", "--summary_freq", "1", "--progress_freq", "1", "--no_tensorboard"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert (out["start_step"], out["step"]) == (3, 4) and out["all_finite"]
    s = out["summaries"]
    assert s["lr"] == schedules.learning_rate(3, hp)
    assert s["schedule_sampling_prob"] == schedules.ground_truth_prob(3, hp)
    assert s["kl_weight"] == hp.kl_weight * schedules.kl_weight(3, hp)
    state = torch.load(checkpoint_file(run, TRAIN_STATE_FILE), weights_only=True)
    for opt in ("opt_g", "opt_d"):
        assert {float(slots["step"]) for slots in state[opt]["state"].values()} == {4.0}


def test_train_warm_starts_from_a_converted_run(entry_dir, tmp_path):
    out = train_main(["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict",
                      str(entry_dir / "model_hparams.json"), "--output_dir", str(tmp_path / "warm"), "--checkpoint",
                      str(entry_dir), "--device", "cpu", "--max_steps", "1", "--no_tensorboard"])
    assert out["start_step"] == 0 and out["step"] == 1 and out["all_finite"]
    saved = torch.load(checkpoint_file(entry_dir, PARAMS_FILE), weights_only=True)
    assert sorted(out["warm_started"]) == sorted(k for k in saved if not k.endswith(".u"))


# ---- (e) the format before names -------------------------------------------- #

def test_train_state_with_adam_slots_by_position_still_resumes(jax_side, tmp_path):
    """A ``train_state.pt`` whose Adams are ``opt.state_dict()`` as they are
    (slots by position in ``split_params`` order) resumes into a fresh state
    with every slot, and its next step equals that of the state it came
    from."""
    run = jax_side.runs["ours_savp"]
    port = tmp_path / "port"
    convert_run(str(run["export"]), str(port))
    batch, noise = _torch_batch(run["batches"][3]), _torch_noise(run["noise"][3])
    model = _run_dir_model(port, run["batches"][0])
    ts = create_train_state(model, 0, "cpu")
    load_train_state(str(port), ts)
    old = {"step": ts.step, "model": model.state_dict(), "opt_g": ts.opt_g.state_dict(),
           "opt_d": ts.opt_d.state_dict(), "rng": ts.rng.get_state()}
    assert all(isinstance(i, int) for i in old["opt_g"]["state"])
    old_dir = tmp_path / "old"
    (old_dir / CHECKPOINT_DIR).mkdir(parents=True)
    torch.save(old, old_dir / CHECKPOINT_DIR / TRAIN_STATE_FILE)  # and the flat layout before step directories
    fresh = create_train_state(_run_dir_model(port, run["batches"][0]), 5, "cpu")
    load_train_state(str(old_dir), fresh)
    assert fresh.step == fx.SAVED_STEP
    for opt, ref in ((fresh.opt_g, ts.opt_g), (fresh.opt_d, ts.opt_d)):
        for p, q in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            for k, v in ref.state[q].items():
                assert torch.equal(opt.state[p][k], v), k
    a = make_train_step(ts.model)(ts, batch, noise=noise)
    b = make_train_step(fresh.model)(fresh, batch, noise=noise)
    assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    # and the port's own writer now keys the slots by name
    save_train_state(str(tmp_path / "new"), fresh)
    new = torch.load(checkpoint_file(tmp_path / "new", TRAIN_STATE_FILE), weights_only=True)
    assert sorted(new["opt_g"]["state"]) == sorted(optimizer_param_names(fresh.model, fresh.opt_g))


def test_load_optimizer_refuses_another_model(jax_side, tmp_path):
    run = jax_side.runs["ours_savp"]
    port = tmp_path / "port"
    convert_run(str(run["export"]), str(port))
    saved = torch.load(checkpoint_file(port, TRAIN_STATE_FILE), weights_only=True)
    model = _run_dir_model(port, run["batches"][0])
    opt_g, _ = make_optimizers(model)
    names = optimizer_param_names(model, opt_g)
    del saved["opt_g"]["state"][names[0]]
    load_optimizer(opt_g, saved["opt_g"], names)  # a slot-less parameter is one before its first step
    saved["opt_g"]["param_groups"][0]["params"].remove(names[0])
    with pytest.raises(ValueError, match="missing"):
        load_optimizer(opt_g, saved["opt_g"], names)


# ---- the fixtures chip_smoke.py reads --------------------------------------- #

def test_small_run_fixture_matches_a_fresh_jax_run(jax_side):
    run = jax_side.runs["ours_savp"]
    fixture = FIXTURES / "jax_run_small"
    for name in export_jax_run.RUN_FILES:
        assert json.loads((fixture / name).read_text()) == json.loads((run["export"] / name).read_text()), name
    with np.load(fixture / JAX_STATE_FILE) as a, np.load(run["export"] / JAX_STATE_FILE) as b:
        assert sorted(a.files) == sorted(b.files)
        fixed, fresh = {k: a[k] for k in a.files}, {k: b[k] for k in b.files}
    assert int(fixed["step"]) == fx.SAVED_STEP
    lr = run["hparams"].lr
    for prefix, extra in (("params/", fx.SAVED_STEP * lr), ("opt_state_g/0/mu/", 0.0), ("opt_state_g/0/nu/", 0.0),
                          ("opt_state_d/0/mu/", 0.0), ("opt_state_d/0/nu/", 0.0), ("model_state/", 0.0)):
        got = {k: torch.from_numpy(v) for k, v in fixed.items() if k.startswith(prefix)}
        ref = {k: torch.from_numpy(v) for k, v in fresh.items() if k.startswith(prefix)}
        assert ref
        _assert_leaf_rule(got, ref, GRAD_TOL, GRAD_FLOOR, extra, what=prefix)
    for k in fresh:
        if fresh[k].dtype != np.float32:
            assert np.array_equal(fixed[k], fresh[k]), k
    with np.load(fixture / "steps.npz") as npz:
        steps = {k: npz[k] for k in npz.files}
    want = fx.steps_arrays(run)
    assert sorted(steps) == sorted(want)
    for k, v in want.items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(steps[k], v, rtol=TRAJ_RTOL, err_msg=k)
        elif "/noise/" in k:
            np.testing.assert_allclose(steps[k], v, rtol=NOISE_TOL, atol=NOISE_TOL, err_msg=k)
        else:
            assert np.array_equal(steps[k], v), k


@pytest.mark.parametrize("config", list(fx.FULL_WIDTH))
def test_state_shape_fixture_matches_jax(jax_side, config):
    fixed = json.loads((FIXTURES / "jax_state_shapes" / f"{config}.json").read_text())
    fresh = json.loads(json.dumps(jax_side.shape_files[config]))
    assert fixed == fresh
    # and the tree the real orbax writer and the exporter produced
    assert fresh["leaves"] == {k: v for k, v in jax_side.full[config]["table"].items()}
