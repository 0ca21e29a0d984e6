"""Data-parallel training in the port (``video_prediction_torch/parallel/``,
``train/step.py``'s ``group``) on the CPU over gloo: ``maybe_initialize``'s
resolution order and its no-op (as ``tests/test_distributed.py`` checks the
JAX function's, with the init call recorded), ``local_device``,
``per_host_batch``, ``shard_batch`` and ``shard_noise`` against a global
draw, and a 2-rank train step, spawned as two processes that meet through a
``file://`` rendezvous: against the one-process port step on the same global
batch, weights and noise, against the JAX single-device 5-step trajectory,
and ``MultiStep(3)`` at 2 ranks against one process; both ranks' parameters
and spectral ``u``s equal; the eval step's metrics reduced over the ranks;
``MultiStep``'s refusal of gloo on CUDA (its guard, without a card).

Small shapes, as ``tests/test_torch_train.py``: 32 px, ngf=4, nef=8, ndf=4,
nz=4, 6 frames, clip_length 4, global batch 2 (one row a rank)."""

import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.parallel import distributed as D
from video_prediction_torch.parallel.mesh import (
    NOISE_BATCH_DIM,
    all_reduce_mean_,
    broadcast_module_,
    shard_batch,
    shard_noise,
)
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import MultiStep, make_eval_step, make_train_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.train import create_train_state as j_create_train_state
from video_prediction_tpu.train import make_train_step as j_make_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2)
WORLD = 2
STEPS = 5  # single steps, as tests/test_torch_train.py's trajectory
K = 3  # MultiStep: two calls of K steps
LOSS_RTOL = 1e-5  # the split changes only the order of the batch sums
PARAM_ATOL = 2e-5  # the JAX package's data-parallel tolerance, tests/test_model_train.py:248-253
# the reduced gradient against the one-process one: 1e-4 of the leaf's max
# |g| plus 1e-5 of the model's largest (tests/test_torch_train.py's rule)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-5
TRAJ_RTOL = 1e-4  # five Adam steps against JAX, tests/test_torch_train.py
SPAWN_TIMEOUT = 240  # seconds for a spawned run: a deadlock fails the test
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


# ---------------------------------------------------------------------------
# maybe_initialize, local_device, per_host_batch
# ---------------------------------------------------------------------------


@pytest.fixture()
def clean_env(monkeypatch):
    for v in TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.fixture()
def record_init(clean_env):
    """Intercept ``dist.init_process_group``; returns the recorded calls."""
    calls = []
    clean_env.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    return calls


@pytest.fixture()
def fake_cuda(clean_env):
    """A CUDA card as ``maybe_initialize`` sees it; returns the devices set current."""
    current = []
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "set_device", current.append)
    return current


class TestMaybeInitialize:
    def test_noop_single_process(self, record_init):
        assert D.maybe_initialize() is False
        assert record_init == []

    def test_explicit_args_win(self, record_init, clean_env):
        clean_env.setenv("MASTER_ADDR", "envhost")
        clean_env.setenv("MASTER_PORT", "1234")
        clean_env.setenv("WORLD_SIZE", "8")
        clean_env.setenv("RANK", "7")
        assert D.maybe_initialize("file:///tmp/rdzv", 2, 1, device="cpu") is True
        assert record_init == [(("gloo",), {"init_method": "file:///tmp/rdzv", "world_size": 2, "rank": 1})]

    def test_env_var_resolution(self, record_init, clean_env):
        clean_env.setenv("MASTER_ADDR", "localhost")
        clean_env.setenv("MASTER_PORT", "29500")
        clean_env.setenv("WORLD_SIZE", "4")
        clean_env.setenv("RANK", "2")
        assert D.maybe_initialize(device="cpu") is True
        assert record_init == [(("gloo",), {"init_method": "env://", "world_size": 4, "rank": 2})]

    def test_env_without_master_addr_is_noop(self, record_init, clean_env):
        clean_env.setenv("WORLD_SIZE", "2")
        clean_env.setenv("RANK", "0")
        assert D.maybe_initialize(device="cpu") is False
        assert record_init == []

    def test_init_method_needs_world_and_rank(self, record_init):
        with pytest.raises(ValueError, match="world size and a rank"):
            D.maybe_initialize("file:///tmp/rdzv", device="cpu")
        assert record_init == []

    def test_nccl_on_cuda_at_local_rank_and_backend_named(self, record_init, fake_cuda, clean_env):
        clean_env.setenv("MASTER_ADDR", "localhost")
        clean_env.setenv("WORLD_SIZE", "2")
        clean_env.setenv("RANK", "1")
        clean_env.setenv("LOCAL_RANK", "1")
        assert D.maybe_initialize() is True
        assert fake_cuda == [torch.device("cuda", 1)]
        assert record_init[-1][0] == ("nccl",)
        assert D.maybe_initialize("file:///tmp/rdzv", 2, 0, backend="gloo", device="cuda:0") is True
        assert fake_cuda[-1] == torch.device("cuda", 0) and record_init[-1][0] == ("gloo",)

    def test_an_existing_group_is_used_as_it_is(self, record_init, clean_env):
        clean_env.setattr(dist, "is_initialized", lambda: True)
        assert D.maybe_initialize("file:///tmp/rdzv", 2, 0, device="cpu") is False
        assert record_init == []

    def test_a_failed_init_raises(self, clean_env, tmp_path):
        with pytest.raises((ValueError, RuntimeError)):
            D.maybe_initialize(f"bogus://{tmp_path}", 1, 0, device="cpu")
        assert not dist.is_initialized()

    def test_cuda_without_a_card_raises(self, clean_env, tmp_path):
        clean_env.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.maybe_initialize(f"file://{tmp_path}/rdzv", 1, 0)
        assert not dist.is_initialized()


def test_local_device(fake_cuda, clean_env):
    assert D.local_device("cpu") == torch.device("cpu")
    assert D.local_device("cuda") == torch.device("cuda", 0)
    clean_env.setenv("LOCAL_RANK", "3")
    assert D.local_device("cuda") == torch.device("cuda", 3)
    assert D.local_device("cuda:1") == torch.device("cuda", 1)  # an explicit index is taken as given


class TestPerHostBatch:
    def test_single_process_passthrough(self):
        assert D.world_size() == 1 and D.rank() == 0 and D.is_primary()
        assert D.per_host_batch(16) == 16

    def test_divides(self, monkeypatch):
        monkeypatch.setattr(D, "world_size", lambda: 4)
        assert D.per_host_batch(16) == 4

    def test_indivisible_raises(self, monkeypatch):
        monkeypatch.setattr(D, "world_size", lambda: 3)
        with pytest.raises(ValueError, match="not divisible"):
            D.per_host_batch(16)


# ---------------------------------------------------------------------------
# shard_batch, shard_noise; the collectives in one process
# ---------------------------------------------------------------------------


def _port_hparams(**extra):
    zoo = thp.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return thp.resolve_model_hparams(t_get_model_class("savp").default_hparams(), str(zoo), extra={**SMALL, **extra})


def _port_model(**extra):
    return t_get_model_class("savp")(_port_hparams(**extra), image_shape=(32, 32, 3), action_dim=4)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_noise_against_a_global_draw(world):
    """The ranks' slices of one global draw put back together are the draw;
    ``clip_start`` is every rank's whole."""
    noise = _port_model().draw_noise(4, 6, torch.Generator().manual_seed(0))
    assert sorted(noise) == sorted([*NOISE_BATCH_DIM, "clip_start"])
    shards = [shard_noise(noise, r, world) for r in range(world)]
    for key, dim in NOISE_BATCH_DIM.items():
        assert all(s[key].shape[dim] == 4 // world for s in shards)
        assert torch.equal(torch.cat([s[key] for s in shards], dim=dim), noise[key]), key
    assert all(s["clip_start"] is noise["clip_start"] for s in shards)
    with pytest.raises(ValueError, match="not divisible"):
        shard_noise(noise, 0, 3)


@pytest.mark.parametrize("stacked", [False, True], ids=["batch", "stacked"])
def test_shard_batch_against_the_global_batch(stacked):
    """Numpy and tensor leaves, split along the batch dim (dim 1 of a
    ``[K, B, ...]`` stack); the ranks' rows make up the batch."""
    rng = np.random.RandomState(0)
    lead = (3,) if stacked else ()
    batch = {"images": rng.randint(0, 255, lead + (4, 6, 8, 8, 3)).astype(np.uint8),
             "actions": torch.from_numpy(rng.randn(*lead, 4, 6, 4).astype(np.float32))}
    dim = 1 if stacked else 0
    shards = [shard_batch(batch, r, WORLD, stacked=stacked) for r in range(WORLD)]
    np.testing.assert_array_equal(np.concatenate([s["images"] for s in shards], axis=dim), batch["images"])
    assert torch.equal(torch.cat([s["actions"] for s in shards], dim=dim), batch["actions"])
    assert shards[1]["images"].shape[dim] == 2
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, 0, 3, stacked=stacked)


@pytest.fixture()
def one_rank_group(tmp_path):
    """A 1-rank gloo group in this process, destroyed after the test."""
    assert D.maybe_initialize(f"file://{tmp_path}/rdzv", 1, 0, device="cpu")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collectives_at_one_rank(one_rank_group):
    """The mean over one rank is the tensor itself, for tensors of several
    shapes and dtypes and two that share storage; a broadcast from rank 0
    leaves the module as it was."""
    base = torch.arange(6, dtype=torch.float32)
    tensors = [base.clone().reshape(2, 3), torch.tensor(2.5), base[1:3], base[1:3], torch.ones(3, dtype=torch.bfloat16)]
    want = [t.clone() for t in tensors]
    all_reduce_mean_(tensors, one_rank_group)
    assert all(torch.equal(t, w) and t.dtype == w.dtype for t, w in zip(tensors, want))
    model = _port_model()
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    broadcast_module_(model, 0, one_rank_group)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_multistep_refuses_gloo_on_cuda(one_rank_group):
    """gloo's collectives do not capture into a CUDA graph: the guard that a
    ``MultiStep``'s CUDA call runs first raises, with no eager fallback;
    without a group, or under NCCL, it passes."""
    with pytest.raises(ValueError, match="do not capture"):
        MultiStep(K, one_rank_group).check_capturable()
    MultiStep(K).check_capturable()


def test_data_parallel_refuses_exact_schedule_sampling(monkeypatch, one_rank_group):
    """``schedule_sampling_exact`` counts round(p * B) ground-truth samples a
    timestep over the whole batch, which no rank sees: a data-parallel step
    refuses to count them per rank. Each rank's mask is its columns of the
    global batch's (``_rank_noise`` ranks the global uniforms before it
    slices them), at one step and K a call, and a rank's own count would
    differ: two of two samples at p = 2/3 where the global batch takes one."""
    from video_prediction_torch.train import schedules
    from video_prediction_torch.train.step import _rank_noise

    model = _port_model(schedule_sampling_exact=True)
    hp = model.hparams
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    for k in (1, K):
        make_train_step(model, k, group=one_rank_group)  # builds: no refusal at any world size
    ts = TrainState(model, None, None, 0, torch.Generator().manual_seed(3))
    images = torch.zeros(1, 6, 32, 32, 3)
    for step in (0, 1, 4):
        noise = model.draw_noise(2, 6, torch.Generator().manual_seed(step))
        whole = schedules.sample_use_gt_mask(2, 6, hp, True, step=step, uniforms=noise["use_gt_u"])
        masks, own = [], []
        for rank in range(2):
            monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
            mine = _rank_noise(ts, images, noise, one_rank_group)
            masks.append(schedules.sample_use_gt_mask(1, 6, hp, True, step=step, uniforms=mine["use_gt_u"],
                                                      ranks=mine["use_gt_rank"], total=mine["use_gt_batch"]))
            own.append(schedules.sample_use_gt_mask(1, 6, hp, True, step=step, uniforms=mine["use_gt_u"]))
        assert torch.equal(torch.cat(masks, dim=1), whole), step
        assert int(whole[hp.context_frames:].sum()) == (hp.sequence_length - 1 - hp.context_frames) * round(
            schedules.ground_truth_prob(step, hp) * 2)
        if step == 0:
            assert not torch.equal(torch.cat(own, dim=1), whole)


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX
# ---------------------------------------------------------------------------

# schedule_sampling_exact, in a worker and in this process (no jax in it)
EXACT = textwrap.dedent(
    """
    def exact_runs(job, group, rank):
        \"\"\"``schedule_sampling_exact``: two single steps and one call of
        ``MultiStep(k)`` from ``job["exact_model"]`` on the job's batches and
        noise (this rank's rows of 2 under ``group``), each step's scalars, and
        each single step's mask as the model takes it (this rank's columns).\"\"\"
        import copy
        import torch
        from video_prediction_torch.parallel.mesh import shard_batch
        from video_prediction_torch.train import schedules
        from video_prediction_torch.train.state import TrainState, make_optimizers
        from video_prediction_torch.train.step import _rank_noise, make_train_step

        world = 1 if group is None else 2
        m = copy.deepcopy(job["exact_model"])
        ts = TrainState(m, *make_optimizers(m), 0, torch.Generator())
        step = make_train_step(m, group=group)
        out = {"steps": [], "masks": []}
        for batch, noise in zip(job["batches"][:2], job["noises"]):
            batch = shard_batch(batch, rank, world)
            mine = noise if group is None else _rank_noise(ts, batch["images"], noise, group)
            b, t = batch["images"].shape[:2]
            out["masks"].append(schedules.sample_use_gt_mask(
                b, t, m.hparams, True, step=ts.step, uniforms=mine["use_gt_u"], ranks=mine.get("use_gt_rank"),
                total=mine.get("use_gt_batch")))
            out["steps"].append({k: float(v) for k, v in step(ts, batch, noise).items()})
        k = job["k"]
        m = copy.deepcopy(job["exact_model"])
        ts = TrainState(m, *make_optimizers(m, k), 0, torch.Generator())
        multi = make_train_step(m, k, group=group)
        stack = {key: torch.stack([b[key] for b in job["batches"][:k]]) for key in job["batches"][0]}
        multi(ts, shard_batch(stack, rank, world, stacked=True), job["noises"][:k])
        out["multi"] = multi.scalars_by_step.clone()
        return out
    """
)
_exact = {}
exec(EXACT, _exact)

# one rank of the 2-rank runs; argv: the job directory, the rank
WORKER = EXACT + textwrap.dedent(
    """
    import copy, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.parallel.mesh import shard_batch
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_eval_step, make_train_step

    path, rank = sys.argv[1], int(sys.argv[2])
    assert maybe_initialize(f"file://{path}/rendezvous", 2, rank, device="cpu")
    try:
        job = torch.load(f"{path}/job.pt", weights_only=False)
        group = dist.group.WORLD
        out = {}
        m = copy.deepcopy(job["model"])
        ts = TrainState(m, *make_optimizers(m), 0, torch.Generator())
        step = make_train_step(m, group=group)
        out["steps"] = []
        for i, (batch, noise) in enumerate(zip(job["batches"][:job["steps"]], job["noises"])):
            s = step(ts, shard_batch(batch, rank, 2), noise)
            out["steps"].append({k: float(v) for k, v in s.items()})
            if i == 0:
                out["grads1"] = {k: p.grad.clone() for k, p in m.named_parameters()}
                out["state1"] = copy.deepcopy(m.state_dict())
        out["state"] = copy.deepcopy(m.state_dict())
        m = copy.deepcopy(job["model"])
        k = job["k"]
        ts = TrainState(m, *make_optimizers(m, k), 0, torch.Generator())
        step = make_train_step(m, k, group=group)
        out["multi"] = []
        for c in range(2):
            stack = {key: torch.stack([b[key] for b in job["batches"][c * k:(c + 1) * k]]) for key in job["batches"][0]}
            step(ts, shard_batch(stack, rank, 2, stacked=True), job["noises"][c * k:(c + 1) * k])
            out["multi"].append(step.scalars_by_step.clone())
        out["multi_state"] = copy.deepcopy(m.state_dict())
        out["exact"] = exact_runs(job, group, rank)
        _, metrics = make_eval_step(m, group)(shard_batch(job["batches"][0], rank, 2),
                                              zs_prior=shard_batch({"z": job["zs_prior"]}, rank, 2)["z"])
        out["metrics"] = {k: v.clone() for k, v in metrics.items() if v.ndim == 0}
        torch.save(out, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    """
)


def spawn(code: str, path: Path, world: int = WORLD, timeout: float = SPAWN_TIMEOUT) -> None:
    """Run ``code`` as ``world`` processes (argv: ``path``, the rank) from the
    repository's root, without a launcher's environment; each must exit 0
    within ``timeout`` seconds (a deadlock fails)."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    logs = [open(path / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(path), str(r)], cwd=REPO, env=env, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read()[-4000:])
        log.close()
    assert all(p.returncode == 0 for p in procs), (
        f"exit codes {[p.returncode for p in procs]} (killed after {timeout} s if negative):\n" + "\n".join(outputs))


def _jax_hparams():
    zoo = jhp.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return jhp.resolve_model_hparams(j_get_model_class("savp").default_hparams(), str(zoo), extra=SMALL)


def _jax_noise(rng, step, b, t, hp):
    """The JAX train step's noise at ``step`` for the global batch, as the port
    takes it (``tests/test_torch_train.py#_noise``)."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, step))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    return {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (t - 1, b)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (b, t - 1, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (b, t - 1, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX 5-step trajectory from perturbed initial weights; the port's
    one-process runs from the same weights, batches and noise (5 single
    steps; two calls of ``MultiStep(3)``; an eval step); the same at 2 ranks,
    from the two spawned processes' files."""
    jh, th = _jax_hparams(), _port_hparams()
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=32).make_iterator(2)
    host = [{k: v[:, :6] for k, v in next(it).items() if k in ("images", "actions")} for _ in range(2 * K)]
    jmodel = j_get_model_class("savp")(jh, mode="train")
    ts = j_create_train_state(jmodel, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in host[0].items()})
    rng = np.random.RandomState(0)
    # every leaf off its init value, as tests/test_torch_train.py perturbs them
    ts = ts.replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
                              + 0.05 * rng.randn(*a.shape).astype(np.float32)), ts.params))
    model = t_get_model_class("savp")(th, image_shape=(32, 32, 3), action_dim=4)
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ts.params),
                                             {"discriminator": jax.tree_util.tree_map(
                                                 np.asarray, ts.model_state["spectral"])}))
    noises = [_jax_noise(ts.rng, i, 2, 6, th) for i in range(2 * K)]
    jstep = j_make_train_step(jmodel, donate=False)
    trajectory = []
    for batch in host[:STEPS]:
        ts, scalars = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()})
        trajectory.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
    zs_prior = torch.randn((2, 5, th.nz), generator=torch.Generator().manual_seed(1))

    one = {}
    m = copy.deepcopy(model)
    tstate = TrainState(m, *make_optimizers(m), 0, torch.Generator())
    step = make_train_step(m)
    one["steps"] = []
    for i, (batch, noise) in enumerate(zip(batches[:STEPS], noises)):
        one["steps"].append({k: float(v) for k, v in step(tstate, batch, noise).items()})
        if i == 0:
            one["grads1"] = {k: p.grad.clone() for k, p in m.named_parameters()}
            one["state1"] = copy.deepcopy(m.state_dict())
    m = copy.deepcopy(model)
    tstate = TrainState(m, *make_optimizers(m, K), 0, torch.Generator())
    multi = make_train_step(m, K)
    one["multi"] = []
    for c in range(2):
        multi(tstate, {key: torch.stack([b[key] for b in batches[c * K:(c + 1) * K]]) for key in batches[0]},
              noises[c * K:(c + 1) * K])
        one["multi"].append(multi.scalars_by_step.clone())
    one["multi_state"] = copy.deepcopy(m.state_dict())
    _, metrics = make_eval_step(m)(batches[0], zs_prior=zs_prior)
    one["metrics"] = {k: v for k, v in metrics.items() if v.ndim == 0}
    exact_model = t_get_model_class("savp")(_port_hparams(schedule_sampling_exact=True), image_shape=(32, 32, 3),
                                            action_dim=4)
    exact_model.load_state_dict(model.state_dict())
    job = {"model": model, "exact_model": exact_model, "batches": batches, "noises": noises, "steps": STEPS, "k": K,
           "zs_prior": zs_prior}
    one["exact"] = _exact["exact_runs"](job, None, 0)

    path = tmp_path_factory.mktemp("parallel")
    torch.save(job, path / "job.pt")
    spawn(WORKER, path)
    ranks = [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"trajectory": trajectory, "one": one, "ranks": ranks, "lr": th.lr}


def _assert_steps_close(steps, want):
    assert [sorted(s) for s in steps] == [sorted(s) for s in want]
    for i, (s, w) in enumerate(zip(steps, want)):
        for k in w:
            np.testing.assert_allclose(s[k], w[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=f"step {i}: {k}")


def test_two_rank_steps_equal_the_one_process_steps(runs):
    """Every loss term of 5 steps within 1e-5 (the global means the JAX mesh
    step returns); after the first step the reduced gradient of every leaf
    within 1e-4 of its max plus 1e-5 of the model's largest, and every
    parameter within 2e-5 where Adam's first step is settled (|g| ten times
    above that tolerance and above 1e-6: eps then moves the step by under
    1%); elsewhere, where the gradient is at rounding level, the first step
    (lr g / (|g| + eps)) may go either way, within 2 lr."""
    one, rank0 = runs["one"], runs["ranks"][0]
    _assert_steps_close(rank0["steps"], one["steps"])
    grads, want = rank0["grads1"], one["grads1"]
    gmax = max(float(g.abs().max()) for g in want.values())
    settled_leaves = 0
    for name, g in want.items():
        tol = GRAD_TOL * float(g.abs().max()) + GRAD_FLOOR * gmax
        err = float((grads[name] - g).abs().max())
        assert err <= tol, f"gradient of {name}: max |dg| {err:.3g}, tolerance {tol:.3g}"
        settled = g.abs() > max(10.0 * tol, 1e-6)
        diff = (rank0["state1"][name] - one["state1"][name]).abs()
        assert float(diff.max()) <= 2.0 * runs["lr"] + 1e-6, name
        if settled.any():
            settled_leaves += 1
            assert float(diff[settled].max()) <= PARAM_ATOL, f"{name}: {float(diff[settled].max()):.3g}"
    assert settled_leaves > len(want) // 2


def test_two_rank_steps_match_the_jax_trajectory(runs):
    traj = [(s["g_loss"], s["d_loss"]) for s in runs["ranks"][0]["steps"]]
    np.testing.assert_allclose(np.array(traj), np.array(runs["trajectory"]), rtol=TRAJ_RTOL)


def test_two_rank_multistep_equals_one_process(runs):
    """``MultiStep(3)`` at 2 ranks, two calls: every step's scalars within
    1e-5 of one process's ``MultiStep(3)`` (the same Adams, with a tensor
    learning rate); the parameters within Adam's bound, 2 lr a step."""
    one, rank0 = runs["one"], runs["ranks"][0]
    for got, want in zip(rank0["multi"], one["multi"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOSS_RTOL, atol=1e-7)
    for name, v in one["multi_state"].items():
        assert float((rank0["multi_state"][name] - v).abs().max()) <= 2.0 * runs["lr"] * 2 * K + 1e-6, name


@pytest.mark.parametrize("state", ["state", "multi_state"])
def test_ranks_hold_equal_parameters_and_u(runs, state):
    a, b = (r[state] for r in runs["ranks"])
    assert sorted(a) == sorted(b) and any(k.endswith(".u") for k in a)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
    for i, (s0, s1) in enumerate(zip(*(r["steps"] for r in runs["ranks"]))):
        assert s0 == s1, f"step {i}: the ranks report other scalars"


def test_eval_metrics_are_the_global_means(runs):
    """Each rank's metrics on its rows, reduced: the one-process metrics of
    the global batch, from the same prior z."""
    want = runs["one"]["metrics"]
    for r in runs["ranks"]:
        assert sorted(r["metrics"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(r["metrics"][k]), float(v), rtol=LOSS_RTOL, err_msg=k)


def test_two_rank_exact_schedule_sampling_equals_one_process(runs):
    """``schedule_sampling_exact`` at 2 ranks (one sample each of the global
    2): the ranks' masks side by side are one process's mask, which takes
    round(p * 2) = 1 ground-truth sample a timestep at steps 0 and 1 where a
    rank counting alone takes its own, 2 of 2; every step's loss terms,
    single and ``MultiStep(3)``, within 1e-5 of one process's."""
    one = runs["one"]["exact"]
    ranks = [r["exact"] for r in runs["ranks"]]
    for i, want in enumerate(one["masks"]):
        assert torch.equal(torch.cat([r["masks"][i] for r in ranks], dim=1), want), i
        assert int(want[2:].sum()) == want.shape[0] - 2, i  # one of two after the 2 context frames
    for r in ranks:
        _assert_steps_close(r["steps"], one["steps"])
        np.testing.assert_allclose(r["multi"].numpy(), one["multi"].numpy(), rtol=LOSS_RTOL, atol=1e-7)
