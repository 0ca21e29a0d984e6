"""The whole slice: the port's ``VideoPredictionModel.forward(train=False)``
against the JAX package's, from converted weights, the same batch (images
and actions) and the same prior z (taken from the JAX run and passed in), at
a small size: 32 px (2 scales, so the U-Net skips are exercised), ngf=4,
nef=8, nz=4, 6 frames, on the ``ours_savp`` hparams, and on ``sv2p`` (the
time-invariant posterior, one z per sequence)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models import input_dims
from video_prediction_torch.models.base import images_to_float
from video_prediction_torch.models.savp import generator_num_scales as t_num_scales
from video_prediction_torch.train.schedules import sample_use_gt_mask
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.models.savp import generator_num_scales as j_num_scales
from video_prediction_tpu.train import schedules as jsched

torch.set_num_threads(1)

ROLLOUT_ATOL = 1e-4  # 5 recurrent fp32 steps through convs, norms and kernels
LATENT_ATOL = 1e-5  # one fp32 encoder pass
SMALL = dict(ngf=4, nef=8, nz=4, sequence_length=6)


def _hparams(module, config="ours_savp", model="savp", **extra):
    """The zoo file ``config`` over the ``model`` class defaults, as
    ``scripts/train.py`` resolves it, from the JAX (``jhp``) or the port's
    (``thp``) copy."""
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / config / "model_hparams.json"
    return module.resolve_model_hparams(
        get_model_class(model).default_hparams(), str(zoo), extra={**SMALL, **extra}
    )


def _batch():
    ds = SyntheticVideoDataset(mode="test", seed=0, image_size=32)
    raw = next(ds.make_iterator(2))
    return {"images": raw["images"][:, :6], "actions": raw["actions"][:, :6]}


def _rollouts(output_aux=False, config="ours_savp", model="savp", **extra):
    jh, th = _hparams(jhp, config, model, **extra), _hparams(thp, config, model, **extra)
    batch = _batch()
    jmodel = j_get_model_class(model)(jh, mode="test")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, state = jmodel.init_variables(jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    # every leaf off its init value, so LN scales/biases and the mask-head
    # bias carry information through the comparison
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.05 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    forward = jax.jit(
        lambda p, b, r: jmodel.forward(p, b, r, jnp.zeros((), jnp.int32), train=False, output_aux=output_aux)
    )
    jout = forward(params, jbatch, jax.random.PRNGKey(1))

    tmodel = t_get_model_class(model)(th, image_shape=(32, 32, 3), action_dim=4)
    # the discriminators (and their spectral u) are not on this path, but
    # convert with the rest of the tree
    tmodel.load_state_dict(flax_to_state_dict(params, {"discriminator": state.get("spectral", {})}))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    zs = jout.get("zs_sampled_prior")
    with torch.no_grad():
        tout = tmodel(tbatch, train=False, zs_prior=None if zs is None else torch.from_numpy(np.array(zs)),
                      output_aux=output_aux)
    return jout, tout


def test_prior_rollout_matches_jax():
    jout, tout = _rollouts(output_aux=True)
    assert tout["gen_images"].shape == (2, 5, 32, 32, 3)
    np.testing.assert_allclose(tout["gen_images"].numpy(), np.asarray(jout["gen_images"]), atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(tout["zs_mu"].numpy(), np.asarray(jout["zs_mu"]), atol=LATENT_ATOL)
    np.testing.assert_allclose(tout["zs_logvar"].numpy(), np.asarray(jout["zs_logvar"]), atol=LATENT_ATOL)
    # output_aux: the compositing masks (K3's second output) and CDNA kernels
    assert tout["masks"].shape == (2, 5, 32, 32, 7) and tout["kernels"].shape == (2, 5, 5, 5, 4)
    np.testing.assert_allclose(tout["masks"].numpy(), np.asarray(jout["masks"]), atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(tout["kernels"].numpy(), np.asarray(jout["kernels"]), atol=ROLLOUT_ATOL)


def test_sv2p_rollout_matches_jax():
    """One z per sequence: the posterior averages its pooled pair features
    over time (``[B,1,nz]``), and the one prior draw drives every step."""
    jout, tout = _rollouts(config="sv2p", model="sv2p")
    assert tout["zs_mu"].shape == tout["zs_sampled_prior"].shape == (2, 1, 4)
    np.testing.assert_allclose(tout["zs_mu"].numpy(), np.asarray(jout["zs_mu"]), atol=LATENT_ATOL)
    np.testing.assert_allclose(tout["zs_logvar"].numpy(), np.asarray(jout["zs_logvar"]), atol=LATENT_ATOL)
    np.testing.assert_allclose(tout["gen_images"].numpy(), np.asarray(jout["gen_images"]), atol=ROLLOUT_ATOL)


def test_time_invariant_posterior_matches_jax():
    from video_prediction_torch.models.networks import PosteriorEncoder as TPosterior
    from video_prediction_tpu.models.networks import PosteriorEncoder as JPosterior

    images = np.random.RandomState(2).rand(3, 6, 32, 32, 3).astype(np.float32)
    jenc = JPosterior(nz=4, nef=8, time_invariant=True)
    params = jenc.init(jax.random.PRNGKey(3), jnp.asarray(images))["params"]
    mu, logvar = jenc.apply({"params": params}, jnp.asarray(images))
    tenc = TPosterior(3, nz=4, nef=8, time_invariant=True)
    tenc.load_state_dict(flax_to_state_dict(params))  # the same parameters as the per-step encoder's
    with torch.no_grad():
        tmu, tlogvar = tenc(torch.from_numpy(images))
    assert tmu.shape == (3, 1, 4)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=LATENT_ATOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), atol=LATENT_ATOL)


def test_time_invariant_latent_refuses_learn_prior():
    with pytest.raises(ValueError, match="learn_prior"):
        t_get_model_class("sv2p")(_hparams(thp, "sv2p", "sv2p", learn_prior=True), image_shape=(32, 32, 3))
    with pytest.raises(ValueError, match="learn_prior"):
        j_get_model_class("sv2p")(_hparams(jhp, "sv2p", "sv2p", learn_prior=True))


@pytest.mark.parametrize(
    "extra",
    [
        dict(nz=0),  # the deterministic branch
        dict(lstm_gate_conv="merged", conv_rnn_norm=False, dependent_mask=False, where_add="middle"),
    ],
    ids=["deterministic", "merged_nonorm_indepmask_middle"],
)
def test_variant_rollout_matches_jax(extra):
    jout, tout = _rollouts(**extra)
    np.testing.assert_allclose(tout["gen_images"].numpy(), np.asarray(jout["gen_images"]), atol=ROLLOUT_ATOL)


@pytest.mark.parametrize("size", [16, 32, 64, 128, 256])
def test_generator_num_scales(size):
    assert t_num_scales(size, size) == j_num_scales(size, size)


def test_eval_use_gt_mask_matches_jax():
    hp = _hparams(thp)
    ref = jsched.sample_use_gt_mask(jax.random.PRNGKey(0), jnp.zeros((), jnp.int32), 3, 6, _hparams(jhp), False)
    np.testing.assert_array_equal(sample_use_gt_mask(3, 6, hp, False).numpy(), np.asarray(ref))


def test_images_to_float():
    x = torch.tensor([0, 51, 255], dtype=torch.uint8)
    np.testing.assert_allclose(images_to_float(x).numpy(), [0.0, 0.2, 1.0], atol=1e-7)
    f = torch.rand(3)
    assert images_to_float(f) is f


def test_jax_refusals_hold():
    """The only errors left are the JAX package's own, raised by both:
    ``latent_time_invariant`` with ``learn_prior`` (``ValueError``),
    ``vgg_cdist_weight`` without VGG16 weights (``FileNotFoundError``,
    ``tests/test_model_variants.py:293-296``) and the acvideo discriminator
    without actions (``ValueError``, ``tests/test_model_train.py:179-182``);
    the options the port refused before build and roll out, ``learn_prior``
    in every model class and beside the other generator options."""
    with pytest.raises(ValueError, match="learn_prior"):
        t_get_model_class("savp")(_hparams(thp, latent_time_invariant=True, learn_prior=True), image_shape=(32, 32, 3))
    with pytest.raises(ValueError, match="learn_prior"):
        j_get_model_class("savp")(_hparams(jhp, latent_time_invariant=True, learn_prior=True))
    for module, build in ((thp, lambda hp: t_get_model_class("savp")(hp, image_shape=(32, 32, 3))),
                          (jhp, lambda hp: j_get_model_class("savp")(hp))):
        for path in ("", "/nonexistent/vgg16.npz"):
            with pytest.raises(FileNotFoundError):
                build(_hparams(module, vgg_cdist_weight=1.0, vgg_weights_path=path))
    for extra in (dict(acvideo_sn_gan_weight=0.1), dict(acvideo_sn_vae_gan_weight=0.1)):
        with pytest.raises(ValueError, match="action-conditioned"):
            t_get_model_class("savp")(_hparams(thp, **extra), image_shape=(32, 32, 3))
        jmodel = j_get_model_class("savp")(_hparams(jhp, **extra))
        with pytest.raises(ValueError, match="action-conditioned"):
            jmodel.init_variables(jax.random.PRNGKey(0), {"images": jnp.zeros((1, 6, 32, 32, 3))})
    batch = {"images": torch.rand(1, 6, 32, 32, 3), "actions": torch.rand(1, 6, 4)}
    for model, extra in (("savp", {}), ("dna", dict(nz=4)), ("sna", dict(nz=4)),
                         ("savp", dict(use_states=True, conv_rnn="gru", transformation="flow"))):
        hp = _hparams(thp, model=model, learn_prior=True, **extra)
        tmodel = t_get_model_class(model)(hp, image_shape=(32, 32, 3), action_dim=4)
        tmodel.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            out = tmodel(batch, generator=torch.Generator().manual_seed(1))
        assert out["gen_images"].shape == (1, 5, 32, 32, 3) and bool(torch.isfinite(out["gen_images"]).all())
        assert out["prior_mu"].shape == out["zs_sampled_prior"].shape == (1, 5, 4)


ZOO_FILES = sorted(thp.zoo_dir().glob("*/*/model_hparams.json"))
ZOO_MODEL = {"dna_l2": "dna", "sna_l2": "sna", "sv2p": "sv2p"}  # the rest: savp


@pytest.mark.parametrize("path", ZOO_FILES, ids=lambda p: f"{p.parent.parent.name}/{p.parent.name}")
def test_every_zoo_file_builds_and_rolls_out(path):
    """Every ``hparams/*/*/model_hparams.json`` over its model class's
    defaults, at its own widths, builds in the port and rolls out one step at
    32 px from a batch with actions and states (the states reach the model
    under ``use_states``)."""
    name = ZOO_MODEL.get(path.parent.name, "savp")
    hp = thp.resolve_model_hparams(t_get_model_class(name).default_hparams(), str(path))
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.rand(1, 2, 32, 32, 3, generator=g), "actions": torch.rand(1, 2, 4, generator=g),
             "states": torch.rand(1, 2, 3, generator=g)}
    model = t_get_model_class(name)(hp, **input_dims(hp, batch))
    model.init_weights(g)
    with torch.no_grad():
        out = model(batch, generator=g)
    assert out["gen_images"].shape == (1, 1, 32, 32, 3) and bool(torch.isfinite(out["gen_images"]).all())
    assert ("gen_states" in out) == hp.use_states
    assert model.generator.cell.stem.weight.shape[1] == 3 + 4 + 3 * hp.use_states + (
        hp.nz if hp.nz and hp.where_add in ("input", "all") else 0)


def test_clip_start_tensor_equals_int_start():
    """The train step draws the clip start on the device; the clip is the
    slice from it, clamped into range, from a tensor or an int, and routes
    its gradient as the slice does."""
    model = t_get_model_class("savp")(_hparams(thp, clip_length=3), image_shape=(32, 32, 3))
    frames = torch.rand(2, 5, 4, 4, 3, requires_grad=True)
    weights = torch.rand(2, 3, 4, 4, 3)
    for start in range(-1, 5):
        s = min(max(start, 0), 2)
        want = frames[:, s : s + 3]
        g_want, = torch.autograd.grad((want * weights).sum(), frames)
        for given in (start, torch.tensor(start)):
            clip = model._clip(frames, given)
            assert torch.equal(clip, want)
            g, = torch.autograd.grad((clip * weights).sum(), frames)
            assert torch.equal(g, g_want)


def test_init_weights_is_flax_like():
    model = t_get_model_class("savp")(_hparams(thp, ngf=8), image_shape=(32, 32, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.generator.cell.enc_rnn1.gates_x.weight.detach()
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05  # lecun-normal: var 1/fan_in
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert float(model.generator.cell.stem.bias.detach().abs().max()) == 0.0
    ln = model.generator.cell.enc_rnn1.ln
    assert torch.equal(ln[0::2], torch.ones_like(ln[0::2])) and torch.equal(ln[1::2], torch.zeros_like(ln[1::2]))
