"""The rest of the generator against the JAX package, on the CPU: the DNA,
warp and GRU ops and the four up/downsample layers; a rollout of each
transformation (dna, stp, flow, direct) and generator option (the low-dim
state with ``gen_states``, GRU cells, the context-frame backgrounds, learned
initial states, each up/downsample layer); and the train step of the
action-conditioned zoo files (``bair/dna_l2`` as ``dna``, ``bair/sna_l2`` as
``sna``, ``bair/ours_gan``, and ``bair/ours_savp`` with ``use_states``, whose
prior and posterior rollouts run as one doubled batch): every loss term,
with ``state``, and the gradient of every parameter. Weights come across by
``convert.py`` with every leaf moved off its init value, so that the
zero-initialized ``stp_head`` and ``init_state_*`` hold no identity; inputs
are numpy-seeded. Small shapes: 32 px, ngf=4, nef=8, ndf=4, nz=4, 6 frames,
4 action and 3 state dims."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models import input_dims
from video_prediction_torch.models.savp import SAVPGenerator as TGenerator
from video_prediction_torch.ops import cdna as tcdna
from video_prediction_torch.ops import layers as tlayers
from video_prediction_torch.ops import warp as twarp
from video_prediction_torch.ops.rnn import ConvGRUCell
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.models.savp import SAVPGenerator as JGenerator
from video_prediction_tpu.ops import cdna as jcdna
from video_prediction_tpu.ops import layers as jlayers
from video_prediction_tpu.ops import rnn as jrnn
from video_prediction_tpu.ops import warp as jwarp

torch.set_num_threads(1)

OP_ATOL = 1e-5  # one fp32 op or layer; sums in another order
ROLLOUT_ATOL = 1e-4  # 5 recurrent fp32 steps, as tests/test_torch_model.py holds the rollout
LOSS_RTOL = 1e-5  # as tests/test_torch_train.py: one fp32 rollout to each loss term
# Gradients, leaf by leaf: max |g_port - g_jax| within GRAD_TOL of the leaf's
# max |g_jax| plus GRAD_FLOOR of the model's largest gradient (the conv
# biases in front of an instance norm have gradient 0 up to it), and the
# median leaf within GRAD_MEDIAN_TOL. Looser than tests/test_torch_train.py's
# 1e-4, measured: dna_l2 median leaf 2.36e-3, worst dna_head.weight 1.25e-2;
# sna_l2 1.48e-3, worst dec_rnn1.gates_x.weight 6.5e-3; ours_gan 9.9e-5,
# worst down1_norm.bias 9.5e-4; the stochastic config 5.7e-6, worst
# dec_rnn1.gates_x.weight 1.4e-4; the losses within 5e-6 rel. On the l2-only
# dna_l2 and sna_l2 (largest gradient 0.041 and 0.012, 200-700 times below the
# GAN configs') relu inputs near zero, whose sign the two sides round apart,
# keep those leaves apart. Not the norm's variance (the port two-pass, flax
# E[x^2] - E[x]^2): with flax's formula on the port's side the worst leaves
# read the same, 1.25e-2 and 6.4e-3, and the dna_l2 median 1.46e-3 to 2.36e-3
# by the order of the sums. 3 times the readings (7.1e-3, 3.75e-2) are above
# these, which stay.
GRAD_TOL, GRAD_MEDIAN_TOL, GRAD_FLOOR = 3e-2, 5e-3, 1e-5
SMALL = dict(ngf=4, nef=8, ndf=4, sequence_length=6, clip_length=4, batch_size=2)
B, T, H = 2, 6, 32


def _perturbed(params, seed):
    """Every leaf off its init value: scales off 1, biases and the
    zero-initialized ``stp_head`` kernel and ``init_state_*`` off 0."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.05 * rng.randn(*a.shape).astype(np.float32),
        params,
    )


def _hparams(module, model="savp", config=None, **extra):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = str(module.zoo_dir() / "bair" / config / "model_hparams.json") if config else None
    return module.resolve_model_hparams(get_model_class(model).default_hparams(), zoo, extra={**SMALL, **extra})


def _batch(seed=0):
    """Images (float in [0, 1]), 4-D actions and 3-D states of the synthetic
    set, 6 frames."""
    raw = next(SyntheticVideoDataset(mode="train", seed=seed, image_size=H).make_iterator(B))
    batch = {k: raw[k][:, :T] for k in ("images", "actions", "states")}
    batch["images"] = (batch["images"] / np.float32(255.0)).astype(np.float32)
    return batch


# ---------------------------------------------------------------- the ops --- #


@pytest.mark.parametrize("n", [1, 3])
def test_apply_dna_kernels_matches_jax(n):
    rng = np.random.RandomState(n)
    image = rng.rand(2, 9, 11, 3).astype(np.float32)
    logits = rng.randn(2, 9, 11, 5, 5, n).astype(np.float32)
    kernels = np.array(jcdna.normalize_kernels(jnp.asarray(logits), "relu"))
    if n == 1:
        kernels = kernels[..., 0]  # the 5-D form of N = 1
    ref = jcdna.apply_kernels(jnp.asarray(image), jnp.asarray(kernels))
    out = tcdna.apply_kernels(torch.from_numpy(image), torch.from_numpy(kernels))
    assert out.shape == (2, n, 9, 11, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


def test_bilinear_sample_clamps_out_of_range_coordinates():
    rng = np.random.RandomState(0)
    image = rng.rand(2, 7, 9, 3).astype(np.float32)
    qy = rng.uniform(-4.0, 11.0, (2, 5, 6)).astype(np.float32)
    qx = rng.uniform(-4.0, 13.0, (2, 5, 6)).astype(np.float32)
    qy[0, 0, :3] = [-1.0, 6.0, 6.5]  # on and past the edges
    qx[0, 0, :3] = [8.0, -0.5, 8.75]
    ref = jwarp.bilinear_sample(jnp.asarray(image), jnp.asarray(qy), jnp.asarray(qx))
    out = twarp.bilinear_sample(torch.from_numpy(image), torch.from_numpy(qy), torch.from_numpy(qx))
    assert out.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), image[0, 0, 8], atol=OP_ATOL)  # clamped to the corner


def test_image_warp_matches_jax():
    rng = np.random.RandomState(1)
    image = rng.rand(2, 9, 11, 3).astype(np.float32)
    flow = 3.0 * rng.randn(2, 9, 11, 2).astype(np.float32)
    ref = jwarp.image_warp(jnp.asarray(image), jnp.asarray(flow))
    out = twarp.image_warp(torch.from_numpy(image), torch.from_numpy(flow))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    zero = twarp.image_warp(torch.from_numpy(image), torch.zeros(2, 9, 11, 2))
    np.testing.assert_array_equal(zero.numpy(), image)


def test_apply_affine_kernels_matches_jax():
    rng = np.random.RandomState(2)
    image = rng.rand(2, 9, 11, 3).astype(np.float32)
    params = 0.3 * rng.randn(2, 3, 6).astype(np.float32)
    ref = jwarp.apply_affine_kernels(jnp.asarray(image), jnp.asarray(params))
    out = twarp.apply_affine_kernels(torch.from_numpy(image), torch.from_numpy(params))
    assert out.shape == (2, 3, 9, 11, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


def test_conv_gru_cell_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    h0 = rng.randn(2, 6, 6, 8).astype(np.float32)
    cell = jrnn.ConvGRUCell(8, 5)
    params = _perturbed(cell.init(jax.random.PRNGKey(0), jnp.asarray(h0), jnp.asarray(x))["params"], 3)
    h_ref, y_ref = cell.apply({"params": params}, jnp.asarray(h0), jnp.asarray(x))
    tcell = ConvGRUCell(5, 8)
    tcell.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        h1, y = tcell(torch.from_numpy(h0), torch.from_numpy(x))
    np.testing.assert_allclose(h1.numpy(), np.asarray(h_ref), atol=OP_ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=OP_ATOL)
    assert tuple(tcell.gates.weight.shape) == (16, 13, 5, 5) and tuple(tcell.candidate.weight.shape) == (8, 13, 5, 5)


LAYERS = {
    "deconv2d": (jlayers.get_upsample_layer, tlayers.get_upsample_layer, 2),
    "bilinear_conv2d": (jlayers.get_upsample_layer, tlayers.get_upsample_layer, 2),
    "max_pool_conv2d": (jlayers.get_downsample_layer, tlayers.get_downsample_layer, 0.5),
    "conv2d": (jlayers.get_downsample_layer, tlayers.get_downsample_layer, 0.5),
}


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_resample_layer_matches_flax(name, size):
    """Each registry layer from converted weights, at an even and an odd size
    (flax's SAME padding of the transposed conv and of the stride-2 conv, the
    bilinear resize's edges, the VALID max pool's floor)."""
    j_registry, t_registry, scale = LAYERS[name]
    x = np.random.RandomState(size).randn(2, size, size, 5).astype(np.float32)
    jlayer, tlayer = j_registry(name)(6), t_registry(name)(5, 6)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], size)
    ref = jlayer.apply({"params": params}, jnp.asarray(x))
    tlayer.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = tlayer(torch.from_numpy(x))
    want = size * 2 if scale == 2 else (size // 2 if name == "max_pool_conv2d" else -(-size // 2))
    assert out.shape == ref.shape == (2, want, want, 6) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


# ---------------------------------------------------------- the rollouts --- #

ROLLOUTS = {
    "use_states": {},
    "dna": dict(transformation="dna"),
    "stp": dict(transformation="stp", last_frames=2),
    "flow": dict(transformation="flow", num_transformed_images=2),
    "direct": dict(transformation="direct"),
    "gru": dict(conv_rnn="gru"),
    "context_images_background": dict(context_images_background=True),
    "learn_initial_state": dict(learn_initial_state=True),
    "deconv2d": dict(upsample_layer="deconv2d"),
    "bilinear_conv2d": dict(upsample_layer="bilinear_conv2d"),
    "max_pool_conv2d": dict(downsample_layer="max_pool_conv2d"),
    "conv2d": dict(downsample_layer="conv2d"),
}


@pytest.mark.parametrize("variant", sorted(ROLLOUTS))
def test_rollout_matches_jax(variant):
    """The generator under ``use_states`` with actions, states and z, from
    converted weights: the images, ``gen_states`` and the aux outputs
    (masks, CDNA kernels, flows), under a teacher-forcing mask that takes the
    ground truth in the context steps and at random after."""
    extra = dict(use_states=True, nz=4, **ROLLOUTS[variant])
    jh, th = _hparams(jhp, **extra), _hparams(thp, **extra)
    batch = _batch()
    rng = np.random.RandomState(7)
    use_gt = np.concatenate([np.ones((1, B), bool), rng.rand(T - 2, B) < 0.5])
    zs = rng.randn(B, T - 1, 4).astype(np.float32)
    jgen = JGenerator(hparams=jh)
    args = dict(images=jnp.asarray(batch["images"]), use_gt=jnp.asarray(use_gt), zs=jnp.asarray(zs),
                actions=jnp.asarray(batch["actions"]), states=jnp.asarray(batch["states"]))
    params = _perturbed(jgen.init(jax.random.PRNGKey(0), **args)["params"], 1)
    jout = jax.jit(lambda p, a: jgen.apply({"params": p}, **a, output_aux=True))(params, args)

    tgen = TGenerator(th, (H, H, 3), action_dim=4, state_dim=3)
    tgen.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        tout = tgen(**{k: torch.from_numpy(np.asarray(v)) for k, v in args.items()}, output_aux=True)
    assert sorted(tout) == sorted(jout) and tout["gen_states"].shape == (B, T - 1, 3)
    if variant == "flow":
        assert tout["flows"].shape == (B, T - 1, H, H, 2, 2)
    for k in tout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ROLLOUT_ATOL, err_msg=k)


def test_state_rollout_gated_by_scheduled_sampling():
    """As ``tests/test_model_variants.py:111`` holds the JAX package: in the
    eval rollout the ground-truth states of the context steps condition the
    cell and later ones do not (the rolled-out ``gen_states`` carry); with
    the ground truth taken at every step, a later state conditions it too."""
    hp = _hparams(thp, model="dna", config="dna_l2")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model = t_get_model_class("dna")(hp, **input_dims(hp, batch))
    model.init_weights(torch.Generator().manual_seed(0))
    ctx = hp.context_frames

    def gen_states(states, use_gt=None):
        with torch.no_grad():
            if use_gt is None:  # the eval rollout: the ground truth in the context steps only
                return model({**batch, "states": states})["gen_states"]
            return model.generator(batch["images"], use_gt, actions=batch["actions"], states=states)["gen_states"]

    base = gen_states(batch["states"])
    late = batch["states"].clone()
    late[:, ctx:] += 5.0
    torch.testing.assert_close(gen_states(late), base, atol=1e-6, rtol=0)
    for t in (0, ctx - 1):
        moved = batch["states"].clone()
        moved[:, t] += 1.0
        assert not torch.allclose(gen_states(moved), base)
    all_gt = torch.ones(T - 1, B, dtype=torch.bool)
    assert not torch.allclose(gen_states(late, all_gt), gen_states(batch["states"], all_gt))


# --------------------------------------------------------- the train step --- #

TRAIN_CONFIGS = {
    "dna_l2": ("dna", {}),
    "sna_l2": ("sna", {}),
    "ours_gan": ("savp", {}),
    "ours_savp_states": ("savp", dict(nz=4, use_states=True, state_weight=1e-4)),  # the doubled rollout
}


def _noise(rng, b, t, hp):
    """The JAX step's noise at step 0, as the port takes it
    (``tests/test_torch_train.py#_noise``)."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, 0))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    return {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (t - 1, b)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (b, t - 1, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (b, t - 1, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }


def _step_run(config):
    """One config's JAX losses and gradients at step 0 (one jit), and the
    port's from the same weights, batch and noise."""
    model, extra = TRAIN_CONFIGS[config]
    zoo = "ours_savp" if config == "ours_savp_states" else config
    extra = dict(extra, schedule_sampling_k=2.0, kl_anneal_steps=(0, 2))  # the mask samples, the KL acts
    jh, th = _hparams(jhp, model, zoo, **extra), _hparams(thp, model, zoo, **extra)
    batch = _batch(seed=4)
    jmodel = j_get_model_class(model)(jh, mode="train")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, state = jmodel.init_variables(jax.random.PRNGKey(0), jbatch)
    params = _perturbed(params, 2)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jmodel.compute_losses(p, state, jbatch, jax.random.fold_in(rng, 0), jnp.zeros((), jnp.int32))

    grads, aux = jax.jit(jax.grad(loss_fn, has_aux=True))(params)

    tmodel = t_get_model_class(model)(th, **input_dims(th, batch))
    tmodel.load_state_dict(flax_to_state_dict(params, {"discriminator": state.get("spectral", {})}))
    _, taux = tmodel.compute_losses({k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                                    noise=_noise(rng, B, T, th))
    (taux["g_loss"] + taux["d_loss"]).backward()
    return th, aux, flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)), tmodel, taux


@pytest.fixture(scope="module", params=sorted(TRAIN_CONFIGS))
def step_run(request):
    return _step_run(request.param)


def test_train_step_losses_match_jax(step_run):
    th, jaux, _, tmodel, taux = step_run
    for kind in ("g_losses", "d_losses"):
        want = {k: float(v) for k, v in jaux[kind].items()}
        got = {k: float(v.detach()) for k, v in taux[kind].items()}
        assert sorted(got) == sorted(want), kind
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert ("state" in taux["g_losses"]) == bool(th.state_weight)
    assert tmodel.generator.cell.stem.weight.shape[1] == 3 + 4 + 3 + (th.nz if th.nz else 0)


def test_train_step_gradients_match_jax(step_run, request):
    _, _, ref, tmodel, _ = step_run
    params = dict(tmodel.named_parameters())
    assert sorted(ref) == sorted(params)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    rel, names = [], []
    for name, p in params.items():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * scale + floor, f"{name}: max |dg| {err:.3g} vs max |g| {scale:.3g}"
        if scale > floor:
            rel.append(err / scale)
            names.append(name)
    worst = max(zip(rel, names))
    print(f"{request.node.callspec.params['step_run']}: median leaf {sorted(rel)[len(rel) // 2]:.3g}, worst "
          f"{worst[1]} {worst[0]:.3g}")  # the readings in the comment above GRAD_TOL (pytest -s)
    assert sorted(rel)[len(rel) // 2] <= GRAD_MEDIAN_TOL, sorted(rel)
