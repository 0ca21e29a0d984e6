"""The training objectives against the JAX package, on the CPU: the modules
(``SpectralConv2D``, ``Conv3D``, ``Local2D``, ``SeparableLocal2D``,
``ImageSNDiscriminator``, ``ACVideoSNDiscriminator``, ``LearnedPrior``), a
``learn_prior`` eval rollout from the same prior noise (fp32, and bf16 under
``tests/test_torch_bf16.py``'s ratio rule), and the train step's every loss
term and every gradient leaf in five configurations: ``learn_prior`` with
the KL only (the posterior rollout alone), ``learn_prior`` with a video GAN
(the doubled batch, ``use_prior_z``), ``z_l1``, the image and acvideo GANs
with their ``_vae`` twins, and ``vgg_cdist`` on a seeded ``.npz``; then
``convert.py``'s tree of the all-objectives model and of the local layers
loaded strictly, and the train CLI with ``learn_prior`` and the acvideo
discriminator (2 steps, a resume, a generate).

Weights cross through ``convert.py`` with every leaf moved off its init
value; inputs are numpy-seeded. Small shapes: 32 px, ngf=4, nef=8, ndf=4,
nz=4, 6 frames, 4 action dims. The JAX side runs as its own tests run it on
the CPU (``use_pallas()`` is False there, so its plain versions)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from video_prediction_torch import generate
from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models import input_dims
from video_prediction_torch.models import networks as tnet
from video_prediction_torch.ops import layers as tlayers
from video_prediction_torch.ops import spectral as tspectral
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.models import networks as jnet
from video_prediction_tpu.ops import layers as jlayers
from video_prediction_tpu.ops import spectral as jspectral

torch.set_num_threads(1)

OP_ATOL = 1e-5  # one fp32 layer or network; sums in another order
ROLLOUT_ATOL = 1e-4  # 5 recurrent fp32 steps, as tests/test_torch_model.py holds the rollout
LOSS_RTOL = 1e-5  # one fp32 rollout to each loss term, as tests/test_torch_train.py
# gradients, leaf by leaf: max |g_port - g_jax| within GRAD_TOL of the leaf's
# max |g_jax| plus GRAD_FLOOR of the model's largest gradient (the conv
# biases in front of an instance norm have gradient 0 up to it)
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-5
# vgg_cdist's gradients reach the generator through VGG16's 13 relus and 4
# max pools, where an fp32 rounding can take the other side of a kink than an
# exact evaluation: on the VGG loss's input gradient against an fp64 one,
# one input pair moves 2.6% of the port's elements (max 1.19e-2 of the
# gradient's max, mean 2.3e-4 of its mean; JAX exact there, 3.0e-6), another
# 1.3% of JAX's (max 2.01e-2, mean 2.4e-4; the port 9.4e-6): neither side is
# the less exact (test_vgg_cdist_input_gradient_against_fp64). Through the
# train step the leaves read up to 2.3e-3 of their max
# (generator.cell.enc_rnn1.gates_x.weight), median 7.7e-4; hence 3e-3 there
VGG_GRAD_TOL = 3e-3
VGG_FP64_MEAN_TOL = 5e-4  # mean |g - g_fp64| over mean |g_fp64|, either side
BF16_RATIO = 2.0  # max|port bf16 - jax bf16| <= 2 max|jax bf16 - jax fp32| (tests/test_torch_bf16.py)
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, batch_size=2, kl_anneal="none",
             schedule_sampling_k=2.0, scan_unroll=1)
B, T, H, NA = 2, 6, 32, 4


def _seeded(shapes, seed):
    """Values for a tree of ``jax.eval_shape`` leaves, from a numpy seed and
    off every init value: kernels (and the local layers' ``vertical`` and
    ``horizontal``) lecun-scaled over the product of every axis but the
    last, norm scales about 1, biases and everything else about 0, spectral
    ``u`` a unit vector. Cheaper than flax's init on the CPU, which compiles
    each initializer op by op."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name in ("kernel", "vertical", "horizontal"):
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.2 * rng.randn(*s.shape)
        elif name == "u":
            a = rng.randn(*s.shape)
            a /= np.linalg.norm(a)
        else:
            a = 0.05 * rng.randn(*s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _hparams(module, config, **extra):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / config / "model_hparams.json"
    return module.resolve_model_hparams(get_model_class("savp").default_hparams(), str(zoo),
                                        extra={**SMALL, **extra})


def _batch(seed=0):
    """Images (float in [0, 1]) and 4-D actions of the synthetic set, 6 frames."""
    raw = next(SyntheticVideoDataset(mode="train", seed=seed, image_size=H).make_iterator(B))
    batch = {k: raw[k][:, :T] for k in ("images", "actions")}
    batch["images"] = (batch["images"] / np.float32(255.0)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    """Seeded VGG16 weights in the ``.npz`` layout both packages read (He init,
    so that the relu taps stay away from 0 through 13 layers)."""
    rng = np.random.RandomState(0)
    vgg, c_in = {}, 3
    for block, n_convs, ch in [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]:
        for i in range(1, n_convs + 1):
            vgg[f"conv{block}_{i}/kernel"] = (np.sqrt(2.0 / (9 * c_in)) * rng.randn(3, 3, c_in, ch)).astype(np.float32)
            vgg[f"conv{block}_{i}/bias"] = (0.01 * rng.randn(ch)).astype(np.float32)
            c_in = ch
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    np.savez(path, **vgg)
    return path


# ---------------------------------------------------------------- modules --- #


def _flax_module(jmod, *inputs, seed=0):
    """``(perturbed params, spectral state, outputs, advanced spectral state)``
    of a flax module on ``inputs`` (the spectral collection mutable)."""
    jin = [jnp.asarray(x) for x in inputs]
    variables = _seeded(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jin), seed)
    params, spectral = variables["params"], variables.get("spectral", {})
    if spectral:
        out, new = jax.jit(lambda v, *x: jmod.apply(v, *x, mutable=["spectral"]))(variables, *jin)
        return params, spectral, out, jax.tree_util.tree_map(np.asarray, new["spectral"])
    return params, spectral, jax.jit(jmod.apply)({"params": params}, *jin), {}


def _assert_u(port_u, new_spectral):
    want = flax_to_state_dict({}, new_spectral)
    got = {f"{layer}.u": u for layer, u in port_u.items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=OP_ATOL, err_msg=k)


@pytest.mark.parametrize("kernel_size,strides", [(3, 1), (4, 2)])
def test_spectral_conv2d_matches_jax(kernel_size, strides):
    """Output and the advanced ``u`` at an odd size (SAME's asymmetric pads
    at stride 2): the port's matrix for the power iteration is the OIHW
    weight with its output axis last, rows in another order than the JAX
    package's reshape of the HWIO kernel, which moves neither sigma nor u."""
    x = _x((2, 9, 9, 5), 1) - 0.5
    params, spectral, y_ref, new = _flax_module(jspectral.SpectralConv2D(6, kernel_size, strides), x)
    layer = tspectral.SpectralConv2D(5, 6, kernel_size, strides)
    layer.load_state_dict(flax_to_state_dict(params, spectral))
    with torch.no_grad():
        y, u = layer(torch.from_numpy(x))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=OP_ATOL)
    _assert_u({"x": u}, {"x": new})


def test_conv3d_matches_jax():
    x = _x((2, 5, 9, 9, 3), 2) - 0.5
    params, _, y_ref, _ = _flax_module(jlayers.Conv3D(6, (3, 4, 4), (2, 2, 2)), x)
    layer = tlayers.Conv3D(3, 6, (3, 4, 4), (2, 2, 2))
    layer.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        y = layer(torch.from_numpy(x))
    assert y.shape == y_ref.shape == (2, 3, 5, 5, 6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=OP_ATOL)


def _local_pair(kind):
    if kind == "local2d":
        return jlayers.Local2D(features=4, kernel_size=3), tlayers.Local2D(6, 7, 3, 4, 3)
    return jlayers.SeparableLocal2D(kernel_size=3, rank=2), tlayers.SeparableLocal2D(6, 7, 3, 3, 2)


@pytest.mark.parametrize("kind", ["local2d", "separable_local2d"])
def test_local_layers_match_jax(kind):
    """The output and the gradients of the input and of every parameter (the
    JAX layout's rank-6 ``kernel`` and ``vertical``/``horizontal``, kept by
    ``convert.py`` as they are), at a non-square size."""
    jmod, tmod = _local_pair(kind)
    x = _x((2, 6, 7, 3), 3) - 0.5
    params, _, y_ref, _ = _flax_module(jmod, x)
    g = np.random.RandomState(4).randn(*y_ref.shape).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * g), argnums=(0, 1)))(
        params, jnp.asarray(x))
    tmod.load_state_dict(flax_to_state_dict(params))
    xt = torch.from_numpy(x).requires_grad_()
    y = tmod(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=OP_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=OP_ATOL)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    assert sorted(ref) == sorted(n for n, _ in tmod.named_parameters())
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=OP_ATOL, err_msg=name)


def test_image_discriminator_matches_jax():
    clips = _x((2, 3, H, H, 3), 5)
    params, spectral, (logits_ref, feats_ref), new = _flax_module(jnet.ImageSNDiscriminator(ndf=4), clips)
    disc = tnet.ImageSNDiscriminator(3, (H, H), 4)
    disc.load_state_dict(flax_to_state_dict(params, spectral))
    with torch.no_grad():
        logits, feats, new_u = disc(torch.from_numpy(clips))
    assert logits.shape == (6, 1) and len(feats) == len(feats_ref) == 6
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=OP_ATOL)
    for i, (f, fr) in enumerate(zip(feats, feats_ref)):
        np.testing.assert_allclose(f.numpy(), np.asarray(fr), atol=OP_ATOL, err_msg=f"feature {i}")
    _assert_u(new_u, new)


def test_acvideo_discriminator_matches_jax():
    clips, actions = _x((2, 4, H, H, 3), 6), _x((2, 4, NA), 7)
    params, spectral, (logits_ref, feats_ref), new = _flax_module(jnet.ACVideoSNDiscriminator(ndf=4), clips, actions)
    disc = tnet.ACVideoSNDiscriminator(3, NA, (4, H, H), 4)
    disc.load_state_dict(flax_to_state_dict(params, spectral))
    assert disc.sn_conv3d0.weight.shape[1] == 2 * 3 + NA
    with torch.no_grad():
        logits, feats, new_u = disc(torch.from_numpy(clips), torch.from_numpy(actions))
    assert logits.shape == (2, 1) and len(feats) == 6
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=OP_ATOL)
    for i, (f, fr) in enumerate(zip(feats, feats_ref)):
        np.testing.assert_allclose(f.numpy(), np.asarray(fr), atol=OP_ATOL, err_msg=f"feature {i}")
    _assert_u(new_u, new)


def test_learned_prior_matches_jax():
    image = _x((2, H, H, 3), 8)
    params, _, (mu_ref, logvar_ref), _ = _flax_module(jnet.LearnedPrior(nz=4, nef=4), image)
    prior = tnet.LearnedPrior(3, nz=4, nef=4)
    prior.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        mu, logvar = prior(torch.from_numpy(image))
    assert mu.shape == logvar.shape == (2, 4) and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), atol=OP_ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_ref), atol=OP_ATOL)


# ------------------------------------------------------ the prior rollout --- #

PRIOR_KEYS = ("gen_images", "prior_mu", "prior_logvar", "zs_sampled_prior")
ROLLOUT_ZOO = "ours_vae_l1"


def _init_variables(jmodel, jbatch, seed):
    """``(params, state)`` shaped as the JAX model's ``init_variables`` makes
    them, with ``_seeded`` values."""
    return _seeded(jax.eval_shape(lambda b: jmodel.init_variables(jax.random.PRNGKey(0), b), jbatch), seed)


def _jax_eval(jh, params, jbatch, rng):
    jmodel = j_get_model_class("savp")(jh, mode="test")
    return jax.jit(lambda p, b: jmodel.forward(p, b, rng, jnp.zeros((), jnp.int32), train=False))(params, jbatch)


@pytest.fixture(scope="module")
def prior_rollout():
    """The JAX ``learn_prior`` eval rollout at fp32 (``ours_vae_l1``: the
    generator and the posterior, no discriminators), its weights, batch and
    the prior's reparameterization noise, which the JAX model draws from the
    third split of its key (``base.py:259, 297``)."""
    jh = _hparams(jhp, ROLLOUT_ZOO, learn_prior=True)
    batch = _batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, _ = _init_variables(j_get_model_class("savp")(jh, mode="test"), jbatch, 9)
    rng = jax.random.PRNGKey(1)
    eps = np.array(jax.random.normal(jax.random.split(rng, 3)[2], (B, T - 1, jh.nz)))
    return params, batch, jbatch, rng, eps, _jax_eval(jh, params, jbatch, rng)


def _port_eval(th, params, batch, eps):
    model = t_get_model_class("savp")(th, **input_dims(th, batch))
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        return model({k: torch.from_numpy(v) for k, v in batch.items()}, zs_prior=torch.from_numpy(eps))


def test_learn_prior_rollout_matches_jax(prior_rollout):
    params, batch, _, _, eps, jout = prior_rollout
    tout = _port_eval(_hparams(thp, ROLLOUT_ZOO, learn_prior=True), params, batch, eps)
    assert tout["prior_mu"].shape == tout["zs_sampled_prior"].shape == (B, T - 1, 4)
    for k in PRIOR_KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ROLLOUT_ATOL, err_msg=k)


def test_learn_prior_rollout_reads_no_future_frame(prior_rollout):
    """The in-cell prior runs on the frame the cell consumes: in the eval
    rollout a ground-truth frame after the context changes nothing the
    rollout returns but the posterior's statistics (JAX ``networks.py:188-194``)."""
    params, batch, _, _, eps, _ = prior_rollout
    th = _hparams(thp, ROLLOUT_ZOO, learn_prior=True)
    base = _port_eval(th, params, batch, eps)
    future = dict(batch, images=batch["images"].copy())
    future["images"][:, th.context_frames:] = 1.0 - future["images"][:, th.context_frames:]
    moved = _port_eval(th, params, future, eps)
    for k in PRIOR_KEYS:
        torch.testing.assert_close(moved[k], base[k], atol=0, rtol=0, msg=k)
    assert not torch.allclose(moved["zs_mu"], base["zs_mu"])
    past = dict(batch, images=batch["images"].copy())
    past["images"][:, th.context_frames - 1] *= 0.5
    assert not torch.allclose(_port_eval(th, params, past, eps)["prior_mu"], base["prior_mu"])


def test_learn_prior_rollout_bf16_matches_jax(prior_rollout):
    """bf16 compute and gates: the port against the JAX bf16 rollout of the
    same weights under the ratio rule, the JAX fp32 rollout the yardstick."""
    params, batch, jbatch, rng, eps, jout32 = prior_rollout
    dtypes = dict(learn_prior=True, compute_dtype="bfloat16", gate_dtype="bfloat16")
    jout16 = _jax_eval(_hparams(jhp, ROLLOUT_ZOO, **dtypes), params, jbatch, rng)
    tout = _port_eval(_hparams(thp, ROLLOUT_ZOO, **dtypes), params, batch, eps)
    assert tout["gen_images"].dtype == tout["prior_mu"].dtype == torch.float32
    for k in PRIOR_KEYS:
        lhs = float(np.abs(tout[k].numpy() - np.asarray(jout16[k], np.float32)).max())
        rhs = float(np.abs(np.asarray(jout16[k], np.float32) - np.asarray(jout32[k])).max())
        assert rhs > 0.0, f"{k}: the bf16 rollout equals the fp32 one"
        assert lhs <= BF16_RATIO * rhs, f"{k}: {lhs:.3g} > {BF16_RATIO} x {rhs:.3g}"


# --------------------------------------------------------- the train step --- #

TRAIN_CONFIGS = {
    "learn_prior_kl": ("ours_vae_l1", dict(learn_prior=True)),  # the posterior rollout alone
    "learn_prior_video_gan": ("ours_savp", dict(learn_prior=True)),  # the doubled batch, use_prior_z
    "z_l1": ("ours_vae_l1", dict(z_l1_weight=1.0)),  # the doubled batch for the re-encode, no GAN
    "image_acvideo_gan": ("ours_vae_l1", dict(image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1,
                                              acvideo_sn_gan_weight=0.1, acvideo_sn_vae_gan_weight=0.1,
                                              gan_feature_l2_weight=1.0, vae_gan_feature_l2_weight=10.0)),
    "vgg_cdist": ("ours_vae_l1", dict(vgg_cdist_weight=1.0)),
}
EXPECTED_TERMS = {
    "learn_prior_kl": ["kl", "l1"],
    "learn_prior_video_gan": ["kl", "l1", "video_gan", "video_vae_gan", "video_vae_gan_feat"],
    "z_l1": ["kl", "l1", "z_l1"],
    "image_acvideo_gan": ["acvideo_gan", "acvideo_gan_feat", "acvideo_vae_gan", "acvideo_vae_gan_feat", "image_gan",
                          "image_gan_feat", "image_vae_gan", "image_vae_gan_feat", "kl", "l1"],
    "vgg_cdist": ["kl", "l1", "vgg_cdist"],
}


def _noise(rng, hp):
    """The JAX step's noise at step 0, as the port takes it
    (``tests/test_torch_train.py#_noise``); under ``learn_prior`` ``z_p`` is
    the prior's reparameterization noise, drawn from the same key."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, 0))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, T - 1)
    return {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (T - 1, B)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (B, T - 1, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (B, T - 1, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, T - 1 - clip_len + 1)),
    }


@pytest.fixture(scope="module", params=sorted(TRAIN_CONFIGS))
def step_run(request, vgg_path):
    """One configuration's JAX losses and gradients at step 0 (one jit), and
    the port's from the same weights, batch and noise."""
    config = request.param
    zoo, extra = TRAIN_CONFIGS[config]
    if "vgg_cdist_weight" in extra:
        extra = dict(extra, vgg_weights_path=vgg_path)
    jh, th = _hparams(jhp, zoo, **extra), _hparams(thp, zoo, **extra)
    batch = _batch(seed=4)
    jmodel = j_get_model_class("savp")(jh, mode="train")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, state = _init_variables(jmodel, jbatch, 2)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p, st, b):  # the batch and state as arguments: XLA would fold the real clips' convs
        return jmodel.compute_losses(p, st, b, jax.random.fold_in(rng, 0), jnp.zeros((), jnp.int32))

    grads, aux = jax.jit(jax.grad(loss_fn, has_aux=True))(params, state, jbatch)
    tmodel = t_get_model_class("savp")(th, **input_dims(th, batch))
    tmodel.load_state_dict(flax_to_state_dict(params, {"discriminator": state.get("spectral", {})}))
    _, taux = tmodel.compute_losses({k: torch.from_numpy(v) for k, v in batch.items()}, 0, noise=_noise(rng, th))
    (taux["g_loss"] + taux["d_loss"]).backward()
    return config, aux, flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)), tmodel, taux


def test_train_step_losses_match_jax(step_run):
    config, jaux, _, _, taux = step_run
    assert sorted(taux["g_losses"]) == EXPECTED_TERMS[config]
    for kind in ("g_losses", "d_losses"):
        want = {k: float(v) for k, v in jaux[kind].items()}
        got = {k: float(v.detach()) for k, v in taux[kind].items()}
        assert sorted(got) == sorted(want), kind
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    if config.startswith("learn_prior"):  # the KL against the learned prior's statistics
        assert taux["outputs"]["prior_mu"].shape == (B, T - 1, 4)


def test_train_step_gradients_match_jax(step_run):
    config, _, ref, tmodel, _ = step_run
    params = dict(tmodel.named_parameters())
    assert sorted(ref) == sorted(params)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in ref.values())
    tol = VGG_GRAD_TOL if config == "vgg_cdist" else GRAD_TOL
    for name, p in params.items():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= tol * scale + floor, f"{name}: max |dg| {err:.3g} vs max |g| {scale:.3g}"


def test_vgg_cdist_input_gradient_against_fp64(vgg_path):
    """The measurement behind ``VGG_GRAD_TOL``: the gradient of ``mean(1 -
    VGG cosine(a, b))`` with respect to ``a``, the port at fp32 and the JAX
    package's, each against the port at fp64 on the same weights, for two
    input pairs: close on the whole; where one side is far at some elements
    (a kink taken the other way), the other is close at every element."""
    from video_prediction_torch.models.vgg import VGGMetric as TVGG
    from video_prediction_tpu.models.vgg import VGGMetric as JVGG

    jvgg, tvgg = JVGG(vgg_path), TVGG(vgg_path)
    jax_grad = jax.jit(jax.grad(lambda x, y: jnp.mean(1.0 - jvgg._csim(x, y))))
    for seeds in ((12, 13), (0, 1)):
        a, b = _x((B, T - 1, H, H, 3), seeds[0]), _x((B, T - 1, H, H, 3), seeds[1])
        grads = {"jax": np.asarray(jax_grad(jnp.asarray(a), jnp.asarray(b)), np.float64)}
        for dtype in (torch.float32, torch.float64):
            tvgg.module.to(dtype)
            x = torch.from_numpy(a).to(dtype).requires_grad_()
            (1.0 - tvgg(x, torch.from_numpy(b).to(dtype))).mean().backward()
            grads[dtype] = x.grad.double().numpy()
        exact = grads.pop(torch.float64)
        errs = {k: np.abs(g - exact) for k, g in grads.items()}
        for k, e in errs.items():
            assert e.mean() <= VGG_FP64_MEAN_TOL * np.abs(exact).mean(), (seeds, k)
        assert min(float(e.max()) for e in errs.values()) <= 1e-4 * np.abs(exact).max(), seeds


# ----------------------------------------------------------- convert.py --- #

ALL_OBJECTIVES = dict(learn_prior=True, z_l1_weight=1.0, image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1,
                      acvideo_sn_gan_weight=0.1, acvideo_sn_vae_gan_weight=0.1, vgg_cdist_weight=1.0)


def test_convert_all_objectives_tree_loads_strictly(vgg_path):
    """The JAX ``init_variables`` tree of the all-objectives model (the
    prior under ``SAVPCell_0/prior``, six discriminators with their ``u``)
    gives exactly the port's ``state_dict`` keys, with no VGG key: the
    frozen VGG16 is outside both."""
    extra = dict(ALL_OBJECTIVES, vgg_weights_path=vgg_path)
    jh, th = _hparams(jhp, "ours_savp", **extra), _hparams(thp, "ours_savp", **extra)
    batch = _batch()
    jmodel = j_get_model_class("savp")(jh, mode="train")
    params, state = _init_variables(jmodel, {k: jnp.asarray(v) for k, v in batch.items()}, 11)
    sd = flax_to_state_dict(params, {"discriminator": state["spectral"]})
    tmodel = t_get_model_class("savp")(th, **input_dims(th, batch))
    assert sorted(sd) == sorted(tmodel.state_dict())
    tmodel.load_state_dict(sd, strict=True)
    assert sorted(tmodel.discriminator) == ["acvideo", "acvideo_vae", "image", "image_vae", "video", "video_vae"]
    assert any(k.startswith("generator.cell.prior.") for k in sd)
    assert not any("vgg" in k for k in sd) and tmodel.vgg is not None
    assert not any(p is q for p in tmodel.parameters() for q in tmodel.vgg.module.parameters())


class _JLocal(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
        y = jlayers.Local2D(features=3, kernel_size=3, name="local")(x)
        y = jlayers.SeparableLocal2D(kernel_size=3, rank=2, name="separable")(y)
        return jlayers.Conv3D(2, (1, 3, 3), name="conv3d")(y[:, None])


class _TLocal(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.local = tlayers.Local2D(5, 6, 3, 3, 3)
        self.separable = tlayers.SeparableLocal2D(5, 6, 3, 3, 2)
        self.conv3d = tlayers.Conv3D(3, 2, (1, 3, 3))

    def forward(self, x):
        return self.conv3d(self.separable(self.local(x))[:, None])


def test_convert_local_layers_tree_loads_strictly():
    """A tree of ``Local2D``, ``SeparableLocal2D`` and ``Conv3D``: strict
    load, the same output, and ``init_weights``' rules on the JAX-layout
    kernels (flax's fan-in: every axis but the last)."""
    x = _x((2, 5, 6, 3), 10)
    params, _, y_ref, _ = _flax_module(_JLocal(), x)
    tmod = _TLocal()
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(), np.asarray(y_ref), atol=OP_ATOL)
    model = t_get_model_class("savp")(_hparams(thp, "ours_savp"), image_shape=(H, H, 3), action_dim=NA)
    model.local = tlayers.Local2D(8, 8, 16, 32, 3)
    model.init_weights(torch.Generator().manual_seed(0))
    k = model.local.kernel.detach()
    fan_in = 8 * 8 * 3 * 3 * 16
    assert abs(float(k.std()) * np.sqrt(fan_in) - 1.0) < 0.05  # variance 1 / fan_in
    assert float(model.local.bias.detach().abs().max()) == 0.0


# ------------------------------------------------------------ the train CLI --- #

ZOO = thp.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
CLI_SMALL = ("ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4,learn_prior=True,"
             "acvideo_sn_gan_weight=0.1,acvideo_sn_vae_gan_weight=0.1")


def test_train_cli_learn_prior_acvideo_resume_generate(tmp_path):
    """``python -m video_prediction_torch.train`` on ``synthetic`` (which has
    actions) with ``learn_prior`` and the acvideo discriminators: 2 steps,
    ``--resume`` to 3, then ``generate`` from the run directory."""
    run = tmp_path / "run"
    argv = ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO),
            "--model_hparams", CLI_SMALL, "--output_dir", str(run), "--batch_size", "2", "--device", "cpu",
            "--progress_freq", "1", "--save_freq", "100", "--eval_summary_freq", "0",
            "--accum_eval_summary_freq", "0", "--seed", "3"]
    first = train_main(argv + ["--max_steps", "2"])
    resumed = train_main(argv + ["--max_steps", "3", "--resume"])
    assert first["all_finite"] and resumed["all_finite"]
    assert (first["step"], resumed["start_step"], resumed["step"]) == (2, 2, 3)
    assert {"g/kl", "g/acvideo_gan", "g/acvideo_vae_gan", "d/acvideo_gan_real",
            "d/acvideo_vae_gan_fake"} <= set(resumed["scalars"])
    with open(os.path.join(run, "model_hparams.json")) as f:
        assert json.load(f)["learn_prior"] is True
    summary = generate.main(["--checkpoint", str(run), "--results_dir", str(tmp_path / "gen"), "--device", "cpu",
                             "--batch_size", "2", "--num_samples", "2", "--num_stochastic_samples", "2"])
    assert summary["rollouts"] == 2 and summary["gifs"] == 4 and summary["all_finite"]
