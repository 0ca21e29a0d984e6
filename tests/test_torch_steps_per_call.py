"""K train steps a call (``train/step.py#make_train_step(steps_per_call=K)``)
on the CPU, where the K-step body runs eagerly (the plain version of the
CUDA graph): the schedules' device forms against the JAX package's and the
host forms; a K=3 call against 3 single port steps, at the tolerances of the
JAX package's own test (``tests/test_model_train.py:349-373``); a K=3 call
from converted JAX weights with the JAX step's noise against JAX
``make_train_step(steps_per_call=3)``; ``DeviceFeeder(stack=K)``; the Adams
built for K > 1 and their checkpoints; the launch counters' bookkeeping for
graph replays. Small shapes: 32 px, ngf=4, nef=8, ndf=4, nz=4, 6 frames,
``scan_unroll=1`` on the JAX side."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch import kernels as K
from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.data import DeviceFeeder
from video_prediction_torch.data.loader import stack_batches
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.train import schedules as tsched
from video_prediction_torch.train.checkpoint import load_train_state, save_train_state
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import MultiStep, _launch_delta, make_train_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.train import create_train_state as j_create_train_state
from video_prediction_tpu.train import make_train_step as j_make_train_step
from video_prediction_tpu.train import schedules as jsched

torch.set_num_threads(1)

SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2, scan_unroll=1)
STEPS = 3
SCHED_RTOL = 1e-6
# the host forms compute in double precision, JAX in float32: beside 1e-6
# relative, one float32 ulp of the schedule's largest term, which the
# cancellation in lr + (end_lr - lr) * frac or 1 - step / n leaves in JAX's
# result (9.999989e-06 for an end_lr of 1e-05 from an lr of 2e-4)
HOST_ATOL = {"learning_rate": lambda hp: float(np.spacing(np.float32(max(hp.lr, hp.end_lr)))),
             "kl_weight": lambda hp: float(np.spacing(np.float32(1.0))),
             "ground_truth_prob": lambda hp: float(np.spacing(np.float32(1.0)))}
PARAM_ATOL, LOSS_RTOL = 1e-5, 1e-5  # tests/test_model_train.py:349-373
TRAJ_RTOL = 1e-4  # tests/test_torch_train.py: Adam steps from converted weights
STEP_GRID = [0, 1, 2, 7, 99, 450, 900, 3999, 4000, 4001, 5000, 6000, 7999, 8000, 12000, 30000, 99999, 300000]
SCHEDULES = [
    dict(schedule_sampling="inverse_sigmoid", schedule_sampling_k=900.0),
    dict(schedule_sampling="inverse_sigmoid", schedule_sampling_k=300.0, schedule_sampling_exact=True),
    dict(schedule_sampling="linear", schedule_sampling_steps=(1000, 9000)),
    dict(schedule_sampling="linear", schedule_sampling_steps=(1000, 9000), schedule_sampling_exact=True),
    dict(schedule_sampling="none"),
    dict(schedule_sampling="always"),
    dict(kl_anneal="none"),
    dict(kl_anneal="linear", kl_anneal_steps=(4000, 8000)),
    dict(kl_anneal="sigmoid", kl_anneal_steps=(4000, 8000)),
    dict(kl_anneal="sigmoid", kl_anneal_steps=(50000, 100000), kl_anneal_k=5000.0),
    dict(decay_steps=(100000, 300000), lr=2e-4, end_lr=1e-5),
    dict(decay_steps=(0, 0), lr=2e-4),
]


def _id(case):
    return ",".join(f"{k}={v}" for k, v in case.items())


def _hp(module, **kw):
    return module.ModelHparams().replace(**kw)


@pytest.mark.parametrize("case", SCHEDULES, ids=_id)
def test_device_schedules_equal_jax_and_host(case):
    """Each schedule of a 0-d step tensor is a float32 tensor equal to JAX's
    (float32) within 1e-6, and so is the host float, within 1e-6 and
    ``HOST_ATOL``, over a grid of steps."""
    th, jh = _hp(thp, **case), _hp(jhp, **case)
    for step in STEP_GRID:
        t_step = torch.tensor(step)
        j_step = jnp.asarray(step, jnp.int32)
        for name in ("learning_rate", "kl_weight", "ground_truth_prob"):
            dev = getattr(tsched, name)(t_step, th)
            host = getattr(tsched, name)(step, th)
            ref = float(getattr(jsched, name)(j_step, jh))
            assert torch.is_tensor(dev) and dev.dtype == torch.float32 and dev.ndim == 0, name
            assert isinstance(host, float), name
            np.testing.assert_allclose(float(dev), ref, rtol=SCHED_RTOL, atol=0, err_msg=f"{name} at {step}")
            np.testing.assert_allclose(host, ref, rtol=SCHED_RTOL, atol=HOST_ATOL[name](th),
                                       err_msg=f"{name} (host) at {step}")


@pytest.mark.parametrize("case", SCHEDULES[:6], ids=_id)
def test_training_mask_of_a_step_tensor_equals_jax(case):
    """The training branch of ``sample_use_gt_mask`` at a step tensor (the
    count ``round(p * B)`` on the device under ``schedule_sampling_exact``)
    equals JAX's mask from the same uniforms, and the mask at the int step."""
    th, jh = _hp(thp, context_frames=2, **case), _hp(jhp, context_frames=2, **case)
    batch, seq = 16, 12
    for i, step in enumerate(STEP_GRID):
        rng = jax.random.PRNGKey(i)
        ref = np.asarray(jsched.sample_use_gt_mask(rng, jnp.asarray(step, jnp.int32), batch, seq, jh, True))
        u = torch.from_numpy(np.asarray(jax.random.uniform(rng, (seq - 1, batch))))
        dev = tsched.sample_use_gt_mask(batch, seq, th, True, step=torch.tensor(step), uniforms=u)
        host = tsched.sample_use_gt_mask(batch, seq, th, True, step=step, uniforms=u)
        np.testing.assert_array_equal(dev.numpy(), ref, err_msg=f"step {step}")
        np.testing.assert_array_equal(host.numpy(), ref, err_msg=f"step {step} (host)")


# ---- the K-step call ----------------------------------------------------- #


def _jax_hparams():
    zoo = jhp.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return jhp.resolve_model_hparams(j_get_model_class("savp").default_hparams(), str(zoo), extra=SMALL)


def _port_hparams():
    zoo = thp.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return thp.resolve_model_hparams(t_get_model_class("savp").default_hparams(), str(zoo), extra=SMALL)


def _batches(n=STEPS):
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=32).make_iterator(2)
    return [{k: v[:, :6] for k, v in next(it).items() if k in ("images", "actions")} for _ in range(n)]


def _stack(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}


def _port_model(seed=0):
    model = t_get_model_class("savp")(_port_hparams(), image_shape=(32, 32, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _state(model, steps_per_call, seed=1):
    return TrainState(model, *make_optimizers(model, steps_per_call), 0, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("single_kind", [1, STEPS], ids=["float_lr", "tensor_lr"])
def test_k_step_call_equals_k_single_steps(single_kind):
    """One call of 3 steps (noise drawn from ``ts.rng``) equals 3 single
    steps from the same weights and generator seed: step 3, every parameter
    within 1e-5, the last g_loss within 1e-5 relative, and every step's
    scalars in ``scalars_by_step``. The single steps run with Adams of either
    kind (a host-float or a tensor learning rate)."""
    batches = _batches()
    model = _port_model()
    single, multi = _state(copy.deepcopy(model), single_kind), _state(model, STEPS)
    step1, step3 = make_train_step(single.model), make_train_step(multi.model, STEPS)
    assert isinstance(step3, MultiStep)
    rows = []
    for b in batches:
        s1 = step1(single, {k: torch.from_numpy(v) for k, v in b.items()})
        rows.append([float(v) for v in s1.values()])
    s3 = step3(multi, _stack(batches))
    assert single.step == multi.step == STEPS
    assert list(s3) == list(s1) == step3.keys
    np.testing.assert_allclose(float(s3["g_loss"]), float(s1["g_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(step3.scalars_by_step.numpy(), np.array(rows), rtol=LOSS_RTOL, atol=1e-7)
    for (name, a), b in zip(single.model.named_parameters(), multi.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=PARAM_ATOL, err_msg=name)
    for (name, a), b in zip(single.model.named_buffers(), multi.model.buffers()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=PARAM_ATOL, err_msg=name)


def _jax_noise(rng, step, hp):
    """The JAX train step's noise at ``step``, as the port takes it (the key
    chain of ``tests/test_torch_train.py``)."""
    b, t = 2, 6
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, step))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    return {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (t - 1, b)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (b, t - 1, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (b, t - 1, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }


def test_k_step_call_matches_jax_fused_steps():
    """A port call of 3 steps from converted JAX weights (every leaf moved
    off its init) with the JAX step's noise equals JAX's
    ``make_train_step(steps_per_call=3)`` (``lax.scan`` over the stacked
    batches): step 3 and the last step's g_loss and d_loss within 1e-4."""
    jh, th = _jax_hparams(), _port_hparams()
    batches = _batches()
    jmodel = j_get_model_class("savp")(jh, mode="train")
    ts = j_create_train_state(jmodel, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items()})
    rs = np.random.RandomState(0)
    ts = ts.replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * (1.0 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
                              + 0.05 * rs.randn(*a.shape).astype(np.float32)), ts.params))
    params0 = jax.tree_util.tree_map(np.asarray, ts.params)
    spectral0 = jax.tree_util.tree_map(np.asarray, ts.model_state.get("spectral", {}))
    j_step = j_make_train_step(jmodel, donate=False, steps_per_call=STEPS)
    j_ts, j_scalars = j_step(ts, {k: jnp.asarray(np.stack([b[k] for b in batches])) for k in batches[0]})

    model = t_get_model_class("savp")(th, image_shape=(32, 32, 3), action_dim=4)
    model.load_state_dict(flax_to_state_dict(params0, {"discriminator": spectral0}))
    port = _state(model, STEPS)
    scalars = make_train_step(model, STEPS)(port, _stack(batches),
                                            noises=[_jax_noise(ts.rng, i, th) for i in range(STEPS)])
    assert port.step == int(j_ts.step) == STEPS
    for key in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(scalars[key]), float(j_scalars[key]), rtol=TRAJ_RTOL, err_msg=key)


def test_k_step_call_refuses_unstacked_batches_and_a_bad_k():
    model = _port_model()
    ts = _state(model, STEPS)
    step = make_train_step(model, STEPS)
    with pytest.raises(ValueError, match="stacked"):  # [B, ...] with B = 2, not [3, B, ...]
        step(ts, {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()})
    with pytest.raises(ValueError, match="noise"):
        step(ts, _stack(_batches()), noises=[{}])
    with pytest.raises(ValueError, match="at least 1"):
        make_train_step(model, 0)
    assert ts.step == 0


@pytest.mark.parametrize("keep_graph", [False, True])
def test_dump_graph_needs_a_kept_captured_graph(tmp_path, keep_graph):
    """``dump_graph`` raises before a capture, and for a graph not kept
    (a CPU call captures nothing)."""
    step = MultiStep(STEPS)
    step.keep_graph = keep_graph
    step(_state(_port_model(), STEPS), _stack(_batches()))
    with pytest.raises(ValueError, match="keep_graph"):
        step.dump_graph(str(tmp_path / "graph.dot"))
    assert not (tmp_path / "graph.dot").exists()


# ---- the feeder, the Adams, the counters ----------------------------------- #


def test_device_feeder_stacks_k_host_batches():
    """``DeviceFeeder(stack=3)`` hands over ``np.stack`` of 3 consecutive
    host batches, drops a last group short of 3, and closes the host stream."""
    host = _batches(7)
    closed = []

    def stream():
        try:
            yield from host
        finally:
            closed.append(True)

    feeder = DeviceFeeder(stream(), "cpu", stack=3)
    got = list(feeder)
    feeder.close()
    assert len(got) == 2 and closed == [True]
    for i, batch in enumerate(got):
        assert sorted(batch) == sorted(host[0])
        for k, v in batch.items():
            np.testing.assert_array_equal(v.numpy(), np.stack([h[k] for h in host[3 * i:3 * i + 3]]))
    assert list(stack_batches(iter(host), 1)) and len(list(stack_batches(iter(host), 8))) == 0
    with pytest.raises(ValueError, match="at least 1"):
        DeviceFeeder(iter(host), "cpu", stack=0)


def test_adams_for_k_steps_have_a_tensor_learning_rate():
    model = _port_model()
    for k, is_tensor in ((1, False), (4, True)):
        for opt in make_optimizers(model, k):
            for group in opt.param_groups:
                assert torch.is_tensor(group["lr"]) == is_tensor
                assert float(group["lr"]) == pytest.approx(model.hparams.lr)
                assert group["capturable"] is False  # the CPU: Adam is capturable on CUDA only


@pytest.mark.parametrize("kinds", [(1, 2), (2, 1)], ids=["1_to_2", "2_to_1"])
def test_train_state_resumes_into_the_other_kind_of_adam(tmp_path, kinds):
    """A train state saved with one kind of Adam restores into the other: the
    restoring Adam keeps its learning-rate form, every slot and the step
    count are restored, and the next step equals that of the saving state."""
    saved_k, loaded_k = kinds
    batches = _batches(3)
    model = _port_model()
    ts = _state(model, saved_k)
    step = make_train_step(model)
    for b in batches[:2]:
        step(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    save_train_state(str(tmp_path), ts)
    restored = _state(_port_model(seed=5), loaded_k, seed=9)
    load_train_state(str(tmp_path), restored)
    assert restored.step == 2
    for opt, ref in ((restored.opt_g, ts.opt_g), (restored.opt_d, ts.opt_d)):
        for group in opt.param_groups:
            assert torch.is_tensor(group["lr"]) == (loaded_k > 1)
        for p, q in zip(opt.param_groups[0]["params"], ref.param_groups[0]["params"]):
            for name, v in ref.state[q].items():
                assert torch.equal(opt.state[p][name], v), name
    last = {k: torch.from_numpy(v) for k, v in batches[2].items()}
    a, b = step(ts, last), make_train_step(restored.model)(restored, last)
    np.testing.assert_allclose(float(b["g_loss"]), float(a["g_loss"]), rtol=LOSS_RTOL)
    for (name, p), q in zip(ts.model.named_parameters(), restored.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), atol=PARAM_ATOL, err_msg=name)


def test_launch_counters_take_back_a_capture_and_add_each_replay():
    """The bookkeeping of a graph's launches: the counts a capture added are
    taken back out, and each replay adds them once."""
    saved = {name: dict(fn.launches) for name, fn in K.WRAPPERS.items()}
    try:
        K.reset_launch_counts()
        K.add_launches({"composite": {"float32": 3}})
        before = K.launch_dtypes()
        K.add_launches({"composite": {"float32": 11}, "fused_ln_gate": {"bfloat16": 66}})  # a capture
        delta = _launch_delta(before, K.launch_dtypes())
        assert delta == {"composite": {"float32": 11}, "fused_ln_gate": {"bfloat16": 66}}
        K.add_launches(delta, -1)
        assert K.launch_counts()["composite"] == 3 and K.launch_counts()["fused_ln_gate"] == 0
        for _ in range(2):  # two replays
            K.add_launches(delta)
        assert K.launch_dtypes() == {"composite": {"float32": 25}, "fused_ln_gate": {"bfloat16": 132}}
    finally:
        for name, fn in K.WRAPPERS.items():
            fn.launches = saved[name]
