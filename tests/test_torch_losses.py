"""The port's losses (``video_prediction_torch/losses.py``) and training
schedules (``train/schedules.py``) against the JAX package's, on the same
numpy-seeded inputs; the sampled teacher-forcing mask from the same uniforms
``jax.random.bernoulli`` draws from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch import losses as TL
from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.train import schedules as TS
from video_prediction_tpu import losses as JL
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.models.base import total_variation as j_total_variation
from video_prediction_tpu.train import schedules as JS

torch.set_num_threads(1)

RTOL = 1e-6  # fp32 reductions of a few hundred values


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "charbonnier_loss"])
def test_reconstruction_losses(name):
    a, b = _x((2, 3, 8, 8, 3), 0), _x((2, 3, 8, 8, 3), 1)
    np.testing.assert_allclose(float(getattr(TL, name)(_t(a), _t(b))),
                               float(getattr(JL, name)(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)


@pytest.mark.parametrize("kind", ["GAN", "LSGAN", "hinge"])
@pytest.mark.parametrize("labels", [0.0, 1.0, 0.9])
def test_gan_loss(kind, labels):
    logits = 2.0 * _x((4, 1), 2)
    np.testing.assert_allclose(float(TL.gan_loss(_t(logits), labels, kind)),
                               float(JL.gan_loss(jnp.asarray(logits), labels, kind)), rtol=RTOL)


def test_gan_loss_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown gan_loss_type"):
        TL.gan_loss(torch.zeros(2), 1.0, "wgan")


@pytest.mark.parametrize("target", [0.0, 0.9])
def test_sigmoid_kl_with_logits(target):
    logits = 3.0 * _x((5,), 3)
    np.testing.assert_allclose(TL.sigmoid_kl_with_logits(_t(logits), target).numpy(),
                               np.asarray(JL.sigmoid_kl_with_logits(jnp.asarray(logits), target)), atol=1e-6)


@pytest.mark.parametrize("with_prior", [False, True])
def test_kl_loss(with_prior):
    mu1, lv1, mu2, lv2 = (_x((2, 5, 4), s) for s in range(4, 8))
    extra_t = (_t(mu2), _t(lv2)) if with_prior else ()
    extra_j = (jnp.asarray(mu2), jnp.asarray(lv2)) if with_prior else ()
    np.testing.assert_allclose(float(TL.kl_loss(_t(mu1), _t(lv1), *extra_t)),
                               float(JL.kl_loss(jnp.asarray(mu1), jnp.asarray(lv1), *extra_j)), rtol=RTOL)


@pytest.mark.parametrize("norm", ["l2", "l1"])
def test_feature_matching_loss_value_and_gradient(norm):
    real = [_x((2, 3, 4, 4, 2), 8), _x((2, 2, 2, 2, 4), 9)]
    fake = [_x((2, 3, 4, 4, 2), 10), _x((2, 2, 2, 2, 4), 11)]
    jreal, jfake = [jnp.asarray(a) for a in real], [jnp.asarray(a) for a in fake]
    ref, (g_real, g_fake) = jax.value_and_grad(JL.feature_matching_loss, argnums=(0, 1))(jreal, jfake, norm)
    treal = [_t(a).requires_grad_() for a in real]
    tfake = [_t(a).requires_grad_() for a in fake]
    out = TL.feature_matching_loss(treal, tfake, norm)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=RTOL)
    for t, j in zip(tfake, g_fake):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-7)
    assert all(t.grad is None for t in treal) and all(float(jnp.abs(g).max()) == 0.0 for g in g_real)


def test_total_variation():
    x = _x((2, 3, 8, 8, 3), 12)
    np.testing.assert_allclose(float(TL.total_variation(_t(x))), float(j_total_variation(jnp.asarray(x))), rtol=RTOL)


def _hp(module, **kw):
    return module.ModelHparams(**kw)


SCHEDULES = [
    dict(),
    dict(decay_steps=(10, 20), lr=1e-3, end_lr=1e-5),
    dict(kl_anneal="linear", kl_anneal_steps=(5, 25)),
    dict(kl_anneal="sigmoid", kl_anneal_steps=(5, 25)),
    dict(kl_anneal="sigmoid", kl_anneal_k=3.0),
    dict(kl_anneal="none"),
    dict(schedule_sampling="linear", schedule_sampling_steps=(3, 30)),
    dict(schedule_sampling="none"),
    dict(schedule_sampling="always"),
    dict(schedule_sampling_k=4.0, schedule_sampling_steps=(2, 100)),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_jax(kw):
    thp_, jhp_ = _hp(thp, **kw), _hp(jhp, **kw)
    for step in (0, 1, 4, 9, 15, 22, 40, 300):
        s = jnp.asarray(step, jnp.int32)
        for name in ("learning_rate", "kl_weight", "ground_truth_prob"):
            np.testing.assert_allclose(getattr(TS, name)(step, thp_), float(getattr(JS, name)(s, jhp_)),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name} at {step}")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("step", [0, 3, 12])
def test_training_mask_matches_jax(exact, step):
    kw = dict(schedule_sampling_k=4.0, schedule_sampling_exact=exact, context_frames=2)
    key = jax.random.PRNGKey(step)
    b, t = 8, 7
    ref = JS.sample_use_gt_mask(key, jnp.asarray(step, jnp.int32), b, t, _hp(jhp, **kw), True)
    uniforms = torch.from_numpy(np.array(jax.random.uniform(key, (t - 1, b))))
    out = TS.sample_use_gt_mask(b, t, _hp(thp, **kw), True, step=step, uniforms=uniforms)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_training_mask_needs_uniforms():
    with pytest.raises(ValueError, match="uniforms"):
        TS.sample_use_gt_mask(2, 5, _hp(thp), True)
