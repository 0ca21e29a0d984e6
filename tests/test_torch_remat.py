"""``remat`` in the port (``models/savp.py#recomputes``, ``_checkpoint``,
``SAVPCell.stretches``) on the CPU:

- (a) the losses, every gradient leaf and the parameters after the step with
  ``remat`` off, ``full`` and ``names`` agree within 1e-6 (in fact bit for
  bit: the recompute runs the same ops on the same inputs), through
  ``make_train_step`` and through ``MultiStep(2)`` (eager on the CPU), for
  the flagship and with ``learn_prior`` and ``use_states`` on;
- (b) the cell is recomputed exactly when the rule says (``remat`` and
  (``scan_unroll != 0`` or ``remat_prevent_cse``), under grad only): the
  cell's submodules are counted with forward pre-hooks during
  ``backward()``. ``full`` reruns the whole cell a timestep, in forward
  order; ``names`` reruns each stretch of ``stretches()`` on its own, from
  the heads back to the stem;
- (c) the cell draws no random numbers (the checkpoint keeps no RNG state);
- (d) an unknown ``remat_policy`` raises;
- (e) the train step's losses and gradients with ``remat_policy="names"``
  against the JAX package's with the same policy;
- (f) a spatial shard (dp1 x sp2, two gloo processes): ``full`` and
  ``names`` against ``remat=False`` on each rank, the learned prior on (its
  gathered frame and ``whole()`` inside the recompute).

Small shapes, as ``ROADMAP.md``'s rules for port tests ask: 32 px, ngf=4,
nef=8, nz=4, 6 frames."""

import copy
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_objectives import _seeded
from test_torch_parallel import spawn
from test_torch_train import GRAD_FLOOR, GRAD_TOL, LOSS_RTOL, _noise

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models import input_dims
from video_prediction_torch.models import savp as tsavp
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import make_eval_step, make_train_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class

torch.set_num_threads(1)

SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2)
B, T = 2, 6
SAME_TOL = 1e-6  # remat changes what is kept, not the maths
POLICIES = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
            "names": dict(remat=True, remat_policy="names")}
CONFIGS = {"flagship": {}, "learn_prior+use_states": dict(learn_prior=True, use_states=True)}


def _hparams(module=thp, **extra):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return module.resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo),
                                        extra={**SMALL, **extra})


def _batches(n=2, states=True):
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=32).make_iterator(B)
    keep = ("images", "actions", "states") if states else ("images", "actions")
    return [{k: torch.from_numpy(v[:, :T]) for k, v in next(it).items() if k in keep} for _ in range(n)]


def _model(hp, batch, seed=0):
    model = t_get_model_class("savp")(hp, **input_dims(hp, batch))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _max_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _step(hp, batches, k):
    """``len(batches)`` steps, ``k`` a call, of the model seeded alike: every
    step's scalars, the first call's gradients, the parameters after."""
    model = _model(hp, batches[0])
    ts = TrainState(model, *make_optimizers(model, k), 0, torch.Generator().manual_seed(1))
    step = make_train_step(model, k)
    rows, grads = [], None
    for c in range(len(batches) // k):
        if k == 1:
            s = step(ts, batches[c])
            rows.append(torch.stack([v.float() for v in s.values()])[None])
        else:
            step(ts, {key: torch.stack([b[key] for b in batches[c * k:(c + 1) * k]]) for key in batches[0]})
            rows.append(step.scalars_by_step.clone())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"scalars": torch.cat(rows), "grads": grads, "state": copy.deepcopy(model.state_dict())}


@pytest.fixture(scope="module")
def step_runs():
    batches = _batches()
    return {(config, k, policy): _step(_hparams(**extra, **remat), batches, k)
            for config, extra in CONFIGS.items() for k in (1, 2) for policy, remat in POLICIES.items()}


@pytest.mark.parametrize("k", [1, 2], ids=["train_step", "multistep2"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("policy", ["full", "names"])
def test_remat_step_equals_the_step_without_it(step_runs, config, k, policy):
    """Every scalar of every step, every gradient leaf of the first call and
    every parameter and spectral ``u`` after the run within 1e-6 of the run
    with ``remat=False`` (two steps: one call of ``MultiStep(2)``, or two
    single steps)."""
    off, on = step_runs[config, k, "off"], step_runs[config, k, policy]
    assert float((on["scalars"] - off["scalars"]).abs().max()) <= SAME_TOL
    assert sorted(on["grads"]) == sorted(off["grads"])
    assert _max_diff(on["grads"], off["grads"]) <= SAME_TOL
    assert _max_diff(on["state"], off["state"]) <= SAME_TOL


def _backward_calls(hp, batch, grad=True):
    """The cell's direct submodules called (forward pre-hooks) in the
    forward and in the backward of one ``compute_losses``, in order, and
    the number of ``_checkpoint`` calls in the forward."""
    model = _model(hp, batch)
    cell = model.generator.cell
    seq = []
    for name, child in cell.named_children():
        child.register_forward_pre_hook(lambda mod, args, name=name: seq.append(name))
    calls = []

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return checkpoint(fn, *args, **kwargs)

    checkpoint = tsavp._checkpoint
    tsavp._checkpoint = counting
    try:
        with torch.set_grad_enabled(grad):
            total, _ = model.compute_losses(batch, 0, noise=model.draw_noise(B, T, torch.Generator().manual_seed(1)))
    finally:
        tsavp._checkpoint = checkpoint
    forward = list(seq)
    seq.clear()
    if grad:
        total.backward()
    return cell, forward, seq, len(calls)


# (remat, scan_unroll, remat_prevent_cse) -> recomputes
RULE = [(False, 1, False, False), (False, 0, True, False), (True, 0, False, False), (True, 0, True, True),
        (True, 1, False, True), (True, 3, False, True), (True, 1, True, True)]


@pytest.mark.parametrize("remat, unroll, prevent_cse, want", RULE,
                         ids=[f"remat{int(r)}-unroll{u}-cse{int(c)}" for r, u, c, _ in RULE])
@pytest.mark.parametrize("policy", ["full", "names"])
def test_recompute_follows_the_rule(policy, remat, unroll, prevent_cse, want):
    """No submodule of the cell runs in the backward without recompute; with
    it, each runs once a timestep, as in the forward: ``full`` reruns the
    forward's sequence (one whole cell a timestep, one checkpoint a
    timestep); ``names`` reruns each stretch as a block, the stretches of a
    timestep from the heads back to the stem (one checkpoint a stretch)."""
    hp = _hparams(remat=remat, remat_policy=policy, scan_unroll=unroll, remat_prevent_cse=prevent_cse)
    assert tsavp.recomputes(hp) == want
    cell, forward, backward, checkpoints = _backward_calls(hp, _batches(1)[0])
    stretches = cell.stretches()
    if not want:
        assert backward == [] and checkpoints == 0
        return
    if policy == "full":
        assert backward == forward and checkpoints == T - 1
        return
    assert checkpoints == (T - 1) * len(stretches)
    of = {name: i for i, s in enumerate(stretches) for name in s}
    blocks, i = [], 0
    while i < len(backward):
        block = stretches[of[backward[i]]]
        assert backward[i:i + len(block)] == block, f"a stretch rerun in pieces at {i}: {backward}"
        blocks.append(of[backward[i]])
        i += len(block)
    assert sorted(blocks) == sorted(list(range(len(stretches))) * (T - 1))
    assert blocks[0] == len(stretches) - 1 and backward != forward  # the heads first


def test_stretches_cover_every_submodule_the_cell_calls():
    """The stretches name each submodule of the cell once, in the order a
    timestep calls them (``names`` keeps only what lies between them)."""
    hp = _hparams(learn_prior=True, use_states=True)
    cell, forward, _, _ = _backward_calls(hp, _batches(1)[0], grad=False)
    per_step = forward[:len(forward) // (T - 1)]
    assert [n for s in cell.stretches() for n in s] == per_step
    assert sorted(per_step) == sorted(dict(cell.named_children()))


@pytest.mark.parametrize("policy", ["full", "names"])
def test_no_grad_rollouts_take_no_checkpoint(policy):
    """``remat`` on: the eval rollout under ``no_grad``, the eval step under
    ``inference_mode`` and a training forward under ``no_grad`` take no
    checkpoint (the JAX package's no-grad rollout has no remat either)."""
    hp = _hparams(remat_policy=policy)
    batch = _batches(1)[0]
    _, forward, backward, checkpoints = _backward_calls(hp, batch, grad=False)
    assert forward and not backward and checkpoints == 0
    model = _model(hp, batch)
    checkpoint = tsavp._checkpoint
    tsavp._checkpoint = None  # a call would raise
    try:
        with torch.no_grad():
            model(batch, train=False, zs_prior=torch.zeros(B, T - 1, hp.nz))
        make_eval_step(model)(batch, zs_prior=torch.zeros(B, T - 1, hp.nz))
    finally:
        tsavp._checkpoint = checkpoint


def test_the_cell_draws_no_random_numbers():
    """One cell call, and its recompute in the backward, leave the CPU
    generator's state as it was: the checkpoint keeps no RNG state."""
    hp = _hparams(learn_prior=True, use_states=True)
    batch = _batches(1)[0]
    model = _model(hp, batch)
    noise = model.draw_noise(B, T, torch.Generator().manual_seed(1))
    before = torch.get_rng_state()
    total, _ = model.compute_losses(batch, 0, noise=noise)
    assert torch.equal(torch.get_rng_state(), before)
    total.backward()
    assert torch.equal(torch.get_rng_state(), before)


def test_unknown_remat_policy_raises():
    """``ModelHparams`` refuses it at construction, and a generator whose
    hparams were changed after it refuses it when called with ``remat`` on
    (the JAX package's ``savp.py:501``); with ``remat`` off it is not read."""
    with pytest.raises(ValueError, match="remat_policy"):
        _hparams(remat_policy="selective")
    hp = _hparams()
    batch = _batches(1)[0]
    model = _model(hp, batch)
    hp.remat_policy = "selective"
    with pytest.raises(ValueError, match="unknown remat_policy 'selective'"):
        model.compute_losses(batch, 0, noise=model.draw_noise(B, T, torch.Generator().manual_seed(1)))
    hp.remat = False
    model.compute_losses(batch, 0, noise=model.draw_noise(B, T, torch.Generator().manual_seed(1)))


@pytest.fixture(scope="module")
def jax_names():
    """The JAX package's train-step gradients and loss terms with
    ``remat_policy="names"`` (``scan_unroll=1``: a rolled scan), from seeded
    weights, the batch a jit argument; the weights as a port state dict."""
    jh = _hparams(jhp, remat_policy="names", scan_unroll=1)
    jmodel = j_get_model_class("savp")(jh, mode="train")
    host = {k: v.numpy() for k, v in _batches(1, states=False)[0].items()}
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    params, state = _seeded(jax.eval_shape(lambda b: jmodel.init_variables(jax.random.PRNGKey(0), b), jbatch), 7)
    params, state = jax.tree_util.tree_map(jnp.asarray, (params, state))
    rng = jax.random.PRNGKey(5)

    def loss_fn(p, batch):
        return jmodel.compute_losses(p, state, batch, jax.random.fold_in(rng, 0), jnp.zeros((), jnp.int32),
                                     train=True)

    grads, aux = jax.jit(jax.grad(loss_fn, has_aux=True))(params, jbatch)
    return {"grads": flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)),
            "losses": {**{f"g/{k}": float(v) for k, v in aux["g_losses"].items()},
                       **{f"d/{k}": float(v) for k, v in aux["d_losses"].items()}},
            "state_dict": flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                             {"discriminator": jax.tree_util.tree_map(np.asarray, state["spectral"])}),
            "batch": {k: torch.from_numpy(v) for k, v in host.items()}, "rng": rng}


def test_names_step_matches_jax(jax_names):
    """With ``remat_policy="names"`` on both sides, every loss term within
    ``tests/test_torch_train.py``'s LOSS_RTOL of the JAX step's and every
    gradient leaf within its GRAD_TOL of the leaf's max plus GRAD_FLOOR of
    the model's largest."""
    th = _hparams(remat_policy="names", scan_unroll=1)
    assert tsavp.recomputes(th)
    batch = jax_names["batch"]
    model = t_get_model_class("savp")(th, **input_dims(th, batch))
    model.load_state_dict(jax_names["state_dict"])
    total, aux = model.compute_losses(batch, 0, noise=_noise(jax_names["rng"], 0, B, T, th))
    total.backward()
    losses = {**{f"g/{k}": float(v.detach()) for k, v in aux["g_losses"].items()},
              **{f"d/{k}": float(v.detach()) for k, v in aux["d_losses"].items()}}
    assert sorted(losses) == sorted(jax_names["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(v, jax_names["losses"][k], rtol=LOSS_RTOL, err_msg=k)
    ref = jax_names["grads"]
    params = dict(model.named_parameters())
    assert sorted(ref) == sorted(params)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    for name, p in params.items():
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * float(ref[name].abs().max()) + floor, f"{name}: max |dg| {err:.3g}"


# one rank (argv: the job directory, the rank): a train step under dp1 x sp2
# for each policy's model, from the same weights, batch and noise
SPATIAL_WORKER = textwrap.dedent(
    """
    import copy, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.parallel.mesh import make_spatial_mesh, shard_batch
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    path, rank = sys.argv[1], int(sys.argv[2])
    job = torch.load(f"{path}/job.pt", weights_only=False)
    assert maybe_initialize(f"file://{path}/rendezvous", 2, rank, device="cpu")
    try:
        sp = make_spatial_mesh(2)
        mine = shard_batch(job["batch"], sp.data_rank, sp.data_size, spatial=(sp.coord, sp.k))
        out = {}
        for name, model in job["models"].items():
            m = copy.deepcopy(model)
            ts = TrainState(m, *make_optimizers(m), 0, torch.Generator())
            s = make_train_step(m, group=dist.group.WORLD, spatial=sp)(ts, mine, job["noise"])
            out[name] = {"scalars": {k: v.clone() for k, v in s.items()},
                         "grads": {k: p.grad.clone() for k, p in m.named_parameters()},
                         "state": copy.deepcopy(m.state_dict())}
        torch.save(out, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    """
)


def test_remat_on_a_spatial_shard_equals_the_shard_without_it(tmp_path):
    """dp1 x sp2 in two gloo processes (a timeout fails: a deadlock is the
    bug), the flagship with the learned prior: on each rank the scalars,
    gradients and parameters after the step with ``full`` and ``names``
    within 1e-6 of those with ``remat=False``. The recompute reruns the
    halo exchanges, the pooled statistics and the prior's gather inside the
    backward, in the mesh of the forward."""
    batch = {k: v for k, v in _batches(1)[0].items() if k != "states"}
    models = {}
    for policy, remat in POLICIES.items():
        hp = _hparams(learn_prior=True, **remat)
        assert tsavp.recomputes(hp) == (policy != "off")
        models[policy] = _model(hp, batch)
    noise = models["off"].draw_noise(B, T, torch.Generator().manual_seed(3))
    torch.save({"models": models, "batch": batch, "noise": noise}, tmp_path / "job.pt")
    spawn(SPATIAL_WORKER, tmp_path, world=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r, out in enumerate(ranks):
        off = out["off"]
        assert all(bool(torch.isfinite(v)) for v in off["scalars"].values())
        for policy in ("full", "names"):
            on = out[policy]
            assert _max_diff(on["scalars"], off["scalars"]) <= SAME_TOL, (r, policy)
            assert _max_diff(on["grads"], off["grads"]) <= SAME_TOL, (r, policy)
            assert _max_diff(on["state"], off["state"]) <= SAME_TOL, (r, policy)
