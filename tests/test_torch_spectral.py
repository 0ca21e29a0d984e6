"""The port's spectral normalization and video SN discriminator against the
JAX package: ``spectral_normalize`` (values, the advanced u and the gradient
through the power iteration), ``SpectralConv3D`` (TF SAME padding, stride 1
and 2) and ``SpectralDense``, and a ``VideoSNDiscriminator`` converted by
``convert.py`` (params and spectral u): logits, features, new u and
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models.networks import VideoSNDiscriminator
from video_prediction_torch.ops import spectral as TS
from video_prediction_tpu.models import networks as jnet
from video_prediction_tpu.ops import spectral as JS

torch.set_num_threads(1)

ATOL = 1e-5  # fp32 convs and a power iteration


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_spectral_normalize_values_and_gradient():
    w, u = _x((12, 5), 0), _x((5,), 1)
    u = u / np.linalg.norm(u)
    probe = _x((12, 5), 2)

    def loss(w_):
        w_bar, _, sigma = JS.spectral_normalize(w_, jnp.asarray(u))
        return jnp.sum(w_bar * probe) + sigma

    (w_bar_ref, u_ref, sigma_ref) = JS.spectral_normalize(jnp.asarray(w), jnp.asarray(u))
    grad_ref = jax.grad(loss)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    w_bar, u_new, sigma = TS.spectral_normalize(wt, torch.from_numpy(u))
    ((w_bar * torch.from_numpy(probe)).sum() + sigma).backward()
    assert not u_new.requires_grad
    np.testing.assert_allclose(w_bar.detach().numpy(), np.asarray(w_bar_ref), atol=1e-6)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(u_ref), atol=1e-6)
    np.testing.assert_allclose(float(sigma.detach()), float(sigma_ref), rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(grad_ref), atol=1e-5)


def _flax_layer(module, x, seed):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * _x(a.shape, seed + 1), variables["params"])
    (y, new_vars) = module.apply({"params": params, "spectral": variables["spectral"]}, jnp.asarray(x),
                                 mutable=["spectral"])
    return params, variables["spectral"], y, new_vars["spectral"]


@pytest.mark.parametrize("k,s,shape", [((1, 3, 3), (1, 1, 1), (2, 4, 8, 8, 3)), ((3, 4, 4), (1, 2, 2), (2, 5, 8, 8, 2)),
                                       ((3, 4, 4), (2, 2, 2), (1, 10, 8, 8, 2)), ((3, 3, 3), (2, 2, 2), (1, 5, 7, 7, 2))])
def test_spectral_conv3d(k, s, shape):
    x = _x(shape, 3)
    params, spectral, y_ref, new_spectral = _flax_layer(JS.SpectralConv3D(4, k, s), x, 4)
    layer = TS.SpectralConv3D(shape[-1], 4, k, s)
    layer.load_state_dict(flax_to_state_dict(params, spectral))
    with torch.no_grad():
        y, u_new = layer(torch.from_numpy(x))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(new_spectral["_SpectralKernel_0"]["u"]), atol=1e-6)


def test_spectral_dense():
    x = _x((3, 7), 5)
    params, spectral, y_ref, new_spectral = _flax_layer(JS.SpectralDense(2), x, 6)
    layer = TS.SpectralDense(7, 2)
    layer.load_state_dict(flax_to_state_dict(params, spectral))
    with torch.no_grad():
        y, u_new = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(new_spectral["_SpectralKernel_0"]["u"]), atol=1e-6)


def test_same_pads_of_the_stride2_time_conv():
    assert TS.same_pads(10, 3, 2) == (0, 1)  # the (3,4,4) stride-2 conv over a 10-frame clip
    assert TS.same_pads(64, 4, 2) == (1, 1)
    assert TS.same_pads(10, 3, 1) == (1, 1)


def test_converted_video_discriminator_matches_jax():
    clips = np.random.RandomState(7).rand(2, 4, 32, 32, 3).astype(np.float32)
    disc = jnet.VideoSNDiscriminator(ndf=4)
    variables = disc.init(jax.random.PRNGKey(1), jnp.asarray(clips))
    rng = np.random.RandomState(8)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                                    variables["params"])
    probe = [rng.randn(1).astype(np.float32)]

    def loss(p, c):
        (logits, feats), new = disc.apply({"params": p, "spectral": variables["spectral"]}, c, mutable=["spectral"])
        return jnp.sum(logits) * probe[0][0] + sum(jnp.mean(f) for f in feats), (logits, feats, new["spectral"])

    (_, (logits_ref, feats_ref, new_ref)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(clips))

    tdisc = VideoSNDiscriminator(3, (4, 32, 32), ndf=4)
    tdisc.load_state_dict(flax_to_state_dict(params, variables["spectral"]))
    tclips = torch.from_numpy(clips).requires_grad_()
    logits, feats, new_u = tdisc(tclips)
    (logits.sum() * float(probe[0][0]) + sum(f.mean() for f in feats)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), atol=ATOL)
    assert len(feats) == len(feats_ref) == 6
    for f, fr in zip(feats, feats_ref):
        assert f.shape == fr.shape
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(fr), atol=ATOL)
    ref_u = flax_to_state_dict({}, new_ref)
    for layer, u in new_u.items():
        np.testing.assert_allclose(u.numpy(), ref_u[f"{layer}.u"].numpy(), atol=1e-5, err_msg=layer)
    np.testing.assert_allclose(tclips.grad.numpy(), np.asarray(grads[1]), atol=ATOL)
    ref_grads = flax_to_state_dict(grads[0])
    for name, p in tdisc.named_parameters():
        scale = float(ref_grads[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), atol=1e-4 * scale + 1e-7, err_msg=name)
