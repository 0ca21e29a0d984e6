"""The training slice against the JAX package, on the CPU: ``compute_losses``
(every g/d loss term), the gradient of every parameter, the advanced spectral
``u`` and a 5-step g_loss/d_loss trajectory of the port's train step, from
converted JAX weights and the JAX step's own noise (reproduced from its key
chain: ``fold_in(rng, step)``, ``split`` into fwd/clip, ``split(fwd, 3)``
into ss/q/p; ``models/base.py:259, 428, 479``). Small shapes: 32 px, ngf=4,
nef=8, ndf=4, nz=4, 6 frames, clip_length 4; ``kl_anneal_steps=(0, 2)`` and
``schedule_sampling_k=2`` so that the KL term and the sampled mask both act
within the 5 steps. Three configurations: the flagship VAE-GAN, the VAE
without discriminators, and SV2P (one z per sequence, l2 and KL, no
adversary)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.train.state import TrainState, make_optimizers, split_params
from video_prediction_torch.train.step import make_train_step as t_make_train_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.train import create_train_state as j_create_train_state
from video_prediction_tpu.train import make_train_step as j_make_train_step

torch.set_num_threads(1)

SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2)
CONFIGS = ["ours_savp", "ours_vae_l1", "sv2p"]
STEPS = 5
LOSS_RTOL = 1e-5  # one fp32 rollout through convs, norms and kernels
# max |g_port - g_jax| over a leaf: 1e-4 of max |g_jax| of the leaf, plus 1e-5
# of the largest gradient of the model, the rounding left where sums cancel
# (the conv biases in front of an instance norm have gradient 0 up to it)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-5
TRAJ_RTOL = 1e-4  # five Adam steps


def _model_name(config):
    return "sv2p" if config == "sv2p" else "savp"


def _hparams(module, config):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / config / "model_hparams.json"
    return module.resolve_model_hparams(get_model_class(_model_name(config)).default_hparams(), str(zoo), extra=SMALL)


def _batches():
    ds = SyntheticVideoDataset(mode="train", seed=0, image_size=32)
    it = ds.make_iterator(2)
    return [{k: v[:, :6] for k, v in next(it).items() if k in ("images", "actions")} for _ in range(STEPS)]


def _noise(rng, step, b, t, hp):
    """The JAX train step's noise at ``step``, as the port takes it."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, step))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    tz = 1 if hp.latent_time_invariant else t - 1  # the posterior's shape: one z per sequence, or per step
    noise = {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (t - 1, b)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (b, tz, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (b, tz, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }
    return noise


class _Run:
    """One config: the JAX train state at step 0 and its 5-step run, and a
    port model loaded with the same weights."""

    def __init__(self, config):
        jh, self.th = _hparams(jhp, config), _hparams(thp, config)
        self.model_name = _model_name(config)
        self.batches = _batches()
        jmodel = j_get_model_class(self.model_name)(jh, mode="train")
        jbatch0 = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        ts = j_create_train_state(jmodel, jax.random.PRNGKey(0), jbatch0)
        rng = np.random.RandomState(0)
        # every leaf off its init value: LN and discriminator biases carry
        # information, and the discriminator logits are well away from 0
        ts = ts.replace(params=jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
                                  + 0.05 * rng.randn(*a.shape).astype(np.float32)),
            ts.params,
        ))
        self.rng = ts.rng
        self.params0 = jax.tree_util.tree_map(np.asarray, ts.params)
        self.spectral0 = jax.tree_util.tree_map(np.asarray, ts.model_state.get("spectral", {}))

        def loss_fn(params, batch):
            total, aux = jmodel.compute_losses(params, ts.model_state, batch, jax.random.fold_in(ts.rng, 0),
                                               jnp.zeros((), jnp.int32), train=True)
            return total, aux

        grads, aux = jax.jit(jax.grad(loss_fn, has_aux=True))(ts.params, jbatch0)
        self.grads0 = jax.tree_util.tree_map(np.asarray, grads)
        self.g_losses0 = {k: float(v) for k, v in aux["g_losses"].items()}
        self.d_losses0 = {k: float(v) for k, v in aux["d_losses"].items()}
        self.new_spectral0 = jax.tree_util.tree_map(np.asarray, aux["new_state"].get("spectral", {}))

        step = j_make_train_step(jmodel, donate=False)
        self.trajectory = []
        for batch in self.batches:
            ts, scalars = step(ts, {k: jnp.asarray(v) for k, v in batch.items()})
            self.trajectory.append((float(scalars["g_loss"]), float(scalars["d_loss"])))

    def port_state(self):
        model = t_get_model_class(self.model_name)(self.th, image_shape=(32, 32, 3), action_dim=4)
        model.load_state_dict(flax_to_state_dict(self.params0, {"discriminator": self.spectral0}))
        opt_g, opt_d = make_optimizers(model)
        return TrainState(model=model, opt_g=opt_g, opt_d=opt_d, step=0, rng=torch.Generator())

    def port_batch(self, i):
        return {k: torch.from_numpy(v) for k, v in self.batches[i].items()}

    def noise(self, step):
        return _noise(self.rng, step, 2, 6, self.th)


@pytest.fixture(scope="module", params=CONFIGS)
def run(request):
    return _Run(request.param)


def test_loss_terms_match_jax(run):
    ts = run.port_state()
    _, aux = ts.model.compute_losses(run.port_batch(0), 0, noise=run.noise(0))
    g = {k: float(v.detach()) for k, v in aux["g_losses"].items()}
    d = {k: float(v.detach()) for k, v in aux["d_losses"].items()}
    assert sorted(g) == sorted(run.g_losses0) and sorted(d) == sorted(run.d_losses0)
    for k in g:
        np.testing.assert_allclose(g[k], run.g_losses0[k], rtol=LOSS_RTOL, err_msg=k)
    for k in d:
        np.testing.assert_allclose(d[k], run.d_losses0[k], rtol=LOSS_RTOL, err_msg=k)


def test_gradients_and_spectral_u_match_jax(run):
    ts = run.port_state()
    total, aux = ts.model.compute_losses(run.port_batch(0), 0, noise=run.noise(0))
    total.backward()
    ref = flax_to_state_dict(run.grads0)
    params = dict(ts.model.named_parameters())
    assert sorted(ref) == sorted(params)
    g_params, d_params = split_params(ts.model)
    assert len(g_params) + len(d_params) == len(params)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    for name, p in params.items():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * scale + floor, f"{name}: max |dg| {err:.3g} vs max |g| {scale:.3g}"
    new_u = flax_to_state_dict({}, {"discriminator": run.new_spectral0})
    port_u = {f"discriminator.{key}.{layer}.u": u for key, layers in aux["new_state"].get("spectral", {}).items()
              for layer, u in layers.items()}
    assert sorted(port_u) == sorted(new_u)
    for k, u in port_u.items():
        np.testing.assert_allclose(u.numpy(), new_u[k].numpy(), atol=1e-5, err_msg=k)


def test_five_step_trajectory_matches_jax(run):
    ts = run.port_state()
    step = t_make_train_step(ts.model)
    traj = []
    for i in range(STEPS):
        scalars = step(ts, run.port_batch(i), noise=run.noise(i))
        traj.append((float(scalars["g_loss"]), float(scalars["d_loss"])))
    assert ts.step == STEPS
    np.testing.assert_allclose(np.array(traj), np.array(run.trajectory), rtol=TRAJ_RTOL)
