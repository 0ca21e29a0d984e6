"""The whole slice: the port's ``VideoPredictionModel.forward(train=False)``
against the JAX package's, from converted weights, the same batch (images
and actions) and the same prior z (taken from the JAX run and passed in), at
a small size: 32 px (2 scales, so the U-Net skips are exercised), ngf=4,
nef=8, nz=4, 6 frames, on the ``ours_savp`` hparams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
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


def _hparams(module, **extra):
    """``ours_savp`` over the savp class defaults, as ``scripts/train.py``
    resolves it, from the JAX (``jhp``) or the port's (``thp``) copy."""
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"
    return module.resolve_model_hparams(
        get_model_class("savp").default_hparams(), str(zoo), extra={**SMALL, **extra}
    )


def _batch():
    ds = SyntheticVideoDataset(mode="test", seed=0, image_size=32)
    raw = next(ds.make_iterator(2))
    return {"images": raw["images"][:, :6], "actions": raw["actions"][:, :6]}


def _rollouts(output_aux=False, **extra):
    jh, th = _hparams(jhp, **extra), _hparams(thp, **extra)
    batch = _batch()
    jmodel = j_get_model_class("savp")(jh, mode="test")
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

    tmodel = t_get_model_class("savp")(th, image_shape=(32, 32, 3), action_dim=4)
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


def test_unported_options_raise():
    for extra in (dict(transformation="dna"), dict(learn_prior=True), dict(conv_rnn="gru"),
                  dict(compute_dtype="bfloat16"), dict(use_states=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_get_model_class("savp")(_hparams(thp, **extra), image_shape=(32, 32, 3))
    # unported loss weights: the model builds and rolls out; its losses raise
    batch = {"images": torch.rand(1, 6, 32, 32, 3)}
    for extra in (dict(image_sn_gan_weight=0.1), dict(acvideo_sn_vae_gan_weight=0.1), dict(z_l1_weight=1.0),
                  dict(vgg_cdist_weight=1.0)):
        model = t_get_model_class("savp")(_hparams(thp, **extra), image_shape=(32, 32, 3))
        with torch.no_grad():
            assert model(batch)["gen_images"].shape == (1, 5, 32, 32, 3)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.compute_losses(batch)


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
