"""The port's layers and posterior encoder against flax, from converted
weights: Conv2D (SAME, stride 1 and 2), ConvPool2D, UpsampleConv2D, the norm
and activation registries, and ``PosteriorEncoder``. Inputs and weight
perturbations are numpy-seeded; both sides get the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models.networks import PosteriorEncoder
from video_prediction_torch.ops import layers as T
from video_prediction_tpu.models import networks as jnet
from video_prediction_tpu.ops import layers as J

torch.set_num_threads(1)

ATOL = 1e-5  # fp32 convolutions and norms, summation order may differ


def _perturbed(params, seed):
    """Flax params with every leaf moved off its init value (scales off 1,
    biases off 0) so that a wrong mapping cannot hide behind a constant."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.randn(*a.shape).astype(np.float32), params
    )


def _flax_vs_torch(flax_module, torch_module, x, seed=0):
    variables = flax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _perturbed(variables["params"], seed)
    ref = flax_module.apply({"params": params}, jnp.asarray(x))
    torch_module.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = torch_module(torch.from_numpy(x))
    return out, ref


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,stride,size", [(3, 1, 8), (5, 1, 8), (4, 2, 8), (3, 2, 8), (3, 2, 7)])
def test_conv2d_same(k, stride, size):
    x = _x((2, size, size, 5))
    out, ref = _flax_vs_torch(J.Conv2D(6, k, stride), T.Conv2D(5, 6, k, stride), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert out.is_contiguous()


def test_conv_pool2d():
    x = _x((2, 8, 8, 4))
    out, ref = _flax_vs_torch(J.ConvPool2D(6), T.ConvPool2D(4, 6), x)
    assert out.shape == (2, 4, 4, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_upsample_conv2d():
    x = _x((2, 4, 4, 6))
    out, ref = _flax_vs_torch(J.UpsampleConv2D(3), T.UpsampleConv2D(6, 3), x)
    assert out.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["instance", "layer", "group"])
def test_norm_registry(name):
    x = 3.0 + 2.0 * _x((2, 6, 6, 16))  # a non-zero mean, so eps and centring matter
    out, ref = _flax_vs_torch(J.get_norm_layer(name)(), T.get_norm_layer(name)(16), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_instance_norm_eps_is_flax_default():
    # a channel variance of ~1e-6: eps 1e-6 and torch's 1e-5 give outputs
    # that differ by a factor of about 2.3
    x = 1e-3 * _x((1, 8, 8, 2))
    out, ref = _flax_vs_torch(J.get_norm_layer("instance")(), T.get_norm_layer("instance")(2), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


# on NORM_SHAPES's integers flax's fp32 E[x^2] - E[x]^2 rounds E[x]^2: it parts from the
# variance's value by 0.4-2.8% of the output's largest entry (measured), the port by rounding
NORM_FLAX_ROUNDING = 3e-2
NORM_EXACT_RTOL = 1e-4  # the port against the float64 value; measured at most 4.8e-5 (F.layer_norm)
NORM_SHAPES = {"instance": (2, 2, 4, 3), "group": (2, 2, 2, 16), "layer": (2, 2, 2, 8)}  # 8 values a statistic


def _exact_norm(name, x, module):
    """The normalization of ``x`` in float64, with ``module``'s scale and bias."""
    shape = x.shape
    groups = {"instance": shape[-1], "group": 8, "layer": None}[name]
    xd = torch.from_numpy(x).double()
    xr, dims = (xd, (-1,)) if groups is None else (xd.reshape(*shape[:3], groups, -1), (1, 2, 4))
    mu = xr.mean(dim=dims, keepdim=True)
    var = (xr - mu).square().mean(dim=dims, keepdim=True)
    y = ((xr - mu) / torch.sqrt(var + T.NORM_EPS)).reshape(shape)
    return (y * module.scale.double() + module.bias.double()).detach().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(NORM_SHAPES))
def test_norm_variance_where_flax_fast_variance_parts(name, seed):
    """flax's norms take max(0, E[x^2] - E[x]^2) in fp32, the port the
    two-pass variance (``ROADMAP.md`` queue 3: flax's formula, in fp32 or
    with fp64 statistics, failed the card's GPU-against-CPU gates). On
    integers 1024 + {-2..2}, a mean 10^3 times the spread, every sum of the 8
    values and their squares is exact and flax's fp32 E[x]^2 (2^20 needs the
    bits the spread sits in) is the only rounding: the port reads the
    variance's float64 value within ``NORM_EXACT_RTOL``, and flax parts from
    it by its own rounding, beyond that and within ``NORM_FLAX_ROUNDING``. With ``test_norm_registry``'s
    mean and spread the two agree to its ``ATOL``, a constant channel
    (variance 0; flax's rounded negative clipped) included."""
    shape = NORM_SHAPES[name]
    x = (1024 + np.random.RandomState(seed).randint(-2, 3, size=shape)).astype(np.float32)
    module = T.get_norm_layer(name)(shape[-1])
    out, ref = _flax_vs_torch(J.get_norm_layer(name)(), module, x, seed=seed)
    out, ref = out.numpy(), np.asarray(ref)
    top = np.abs(ref).max()
    exact = _exact_norm(name, x, module)
    np.testing.assert_allclose(out, exact, rtol=0, atol=NORM_EXACT_RTOL * top)
    apart = np.abs(ref - exact).max()
    assert 10 * NORM_EXACT_RTOL * top < apart <= NORM_FLAX_ROUNDING * top, apart / top
    np.testing.assert_allclose(out, ref, rtol=0, atol=NORM_FLAX_ROUNDING * top)

    x = 3.0 + 2.0 * _x(shape, seed)  # test_norm_registry's spread
    x[..., 0] = 3.0  # a constant channel; for "layer" a constant row too
    x[0, 0, 0] = 3.0
    out, ref = _flax_vs_torch(J.get_norm_layer(name)(), T.get_norm_layer(name)(shape[-1]), x, seed=seed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["relu", "lrelu", "elu", "tanh", "sigmoid", "swish", "none"])
def test_activation_registry(name):
    x = _x((64,))
    out = T.get_activation(name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(J.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_posterior_encoder():
    images = np.random.RandomState(1).rand(2, 4, 32, 32, 3).astype(np.float32)
    flax_enc = jnet.PosteriorEncoder(nz=4, nef=8)
    variables = flax_enc.init(jax.random.PRNGKey(0), jnp.asarray(images))
    params = _perturbed(variables["params"], 1)
    mu_ref, logvar_ref = flax_enc.apply({"params": params}, jnp.asarray(images))
    enc = PosteriorEncoder(3, nz=4, nef=8)
    enc.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        mu, logvar = enc(torch.from_numpy(images))
    assert mu.shape == (2, 3, 4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_ref), atol=ATOL)
