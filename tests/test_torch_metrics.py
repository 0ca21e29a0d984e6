"""The port's evaluation metrics against the JAX package's, on the CPU:
``metrics.py`` (MSE, PSNR, SSIM, cosine), ``models/vgg.py`` (the VGG16 taps
and the VGG cosine similarity) and ``models/lpips.py``, on the same numpy
inputs. The VGG weights are the JAX package's own random init
(``VGG16Features().init(PRNGKey(0))``) carried across through an ``.npz`` in
the layout both packages read."""

import numpy as np
import pytest
import torch

from video_prediction_torch import metrics as TM
from video_prediction_torch.models.lpips import LPIPSMetric as TLPIPS
from video_prediction_torch.models.vgg import VGGMetric as TVGG
from video_prediction_torch.models.vgg import load_params_npz
from video_prediction_tpu import metrics as JM
from video_prediction_tpu.models.lpips import LPIPSMetric as JLPIPS
from video_prediction_tpu.models.vgg import VGGMetric as JVGG

torch.set_num_threads(1)

ATOL = 1e-6  # MSE and cosine: one fp32 reduction
PSNR_RTOL = 1e-6  # PSNR is ~10-40 dB: relative, a few fp32 ulps
SSIM_ATOL = 1e-5  # five 11x11 Gaussian filterings in fp32, other summation orders
VGG_TAP_RTOL = 1e-4  # of each tap's largest value: 13 fp32 convs
PERCEPTUAL_ATOL = 1e-5


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0.0, 1.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 3, 32, 32, 3), (2, 64, 64, 3)])
def test_pixel_metrics_match_jax(shape):
    a, b = _pair(shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    lead = shape[:-3]
    mse = TM.mean_squared_error(ta, tb).numpy()
    assert mse.shape == lead
    np.testing.assert_allclose(mse, np.asarray(JM.mean_squared_error(a, b)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(TM.peak_signal_to_noise_ratio(ta, tb).numpy(),
                               np.asarray(JM.peak_signal_to_noise_ratio(a, b)), rtol=PSNR_RTOL)
    ssim = TM.structural_similarity(ta, tb).numpy()
    assert ssim.shape == lead
    np.testing.assert_allclose(ssim, np.asarray(JM.structural_similarity(a, b)), atol=SSIM_ATOL, rtol=0)
    np.testing.assert_allclose(TM.cosine_similarity(ta, tb).numpy(), np.asarray(JM.cosine_similarity(a, b)),
                               atol=ATOL, rtol=0)


def test_equal_images_give_inf_psnr_and_unit_ssim():
    a, _ = _pair((2, 3, 32, 32, 3))
    ta = torch.from_numpy(a)
    assert torch.isinf(TM.peak_signal_to_noise_ratio(ta, ta)).all()
    np.testing.assert_allclose(TM.structural_similarity(ta, ta).numpy(), 1.0, atol=1e-6)


def test_fspecial_gauss_matches_jax():
    np.testing.assert_allclose(TM._fspecial_gauss(11, 1.5).numpy(), np.asarray(JM._fspecial_gauss(11, 1.5)),
                               rtol=1e-6)


def test_ssim_filter_restores_the_tf32_setting():
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            with TM.fp32_convs():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's random VGG16 init as an ``.npz``, and seeded LPIPS
    linear weights."""
    root = tmp_path_factory.mktemp("perceptual")
    jvgg = JVGG(allow_random=True)
    vgg_path = str(root / "vgg16.npz")
    np.savez(vgg_path, **{f"{layer}/{leaf}": np.asarray(v) for layer, leaves in jvgg.variables["params"].items()
                          for leaf, v in leaves.items()})
    rng = np.random.RandomState(4)
    lin_path = str(root / "lpips_lin.npz")
    # some negative entries, which both packages clip to 0
    np.savez(lin_path, **{f"lin{i}/weight": (rng.rand(c) - 0.2).astype(np.float32)
                          for i, c in enumerate([64, 128, 256, 512, 512])})
    return jvgg, vgg_path, lin_path


def test_vgg_taps_match_jax(weights):
    jvgg, vgg_path, _ = weights
    a, _ = _pair((3, 32, 32, 3), seed=1)
    jtaps = jvgg.module.apply(jvgg.variables, a)
    ttaps = TVGG(vgg_path).module(torch.from_numpy(a))
    assert len(ttaps) == len(jtaps) == 5
    for tt, jt in zip(ttaps, jtaps):
        jt = np.asarray(jt)
        tt = tt.permute(0, 2, 3, 1).numpy()  # NCHW -> NHWC
        assert tt.shape == jt.shape
        np.testing.assert_allclose(tt, jt, atol=VGG_TAP_RTOL * np.abs(jt).max(), rtol=0)


def test_vgg_and_lpips_metrics_match_jax(weights):
    _, vgg_path, lin_path = weights
    a, b = _pair((2, 2, 32, 32, 3), seed=2)
    tvgg = TVGG(vgg_path)
    assert not tvgg.untrained
    out = tvgg(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out, np.asarray(JVGG(vgg_path)(a, b)), atol=PERCEPTUAL_ATOL, rtol=0)
    for lin in (lin_path, None):  # learned weights, and the untrained 1/C default
        tl = TLPIPS(vgg_path, lin, allow_random=lin is None)
        jl = JLPIPS(vgg_path, lin, allow_random=lin is None)
        assert tl.untrained == jl.untrained == (lin is None)
        d = tl(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert d.shape == (2, 2) and (d > 0).all()
        np.testing.assert_allclose(d, np.asarray(jl(a, b)), atol=PERCEPTUAL_ATOL, rtol=0)


@pytest.mark.parametrize("metric", ["vgg", "lpips_learned", "lpips_default"])
def test_split_metrics_match_jax_on_the_expanded_target(weights, metric):
    """``score(prepare(target), pred)`` with 3 samples a target, the path
    ``evaluate.BestOfN`` runs, against the JAX package's metric on the target
    expanded to every sample: VGG, and LPIPS with learned linear weights
    (negative entries clipped) and with the 1/C default."""
    _, vgg_path, lin_path = weights
    g = np.random.RandomState(3)
    target = g.rand(2, 2, 32, 32, 3).astype(np.float32)
    pred = np.clip(target[:, None] + 0.1 * g.randn(2, 3, 2, 32, 32, 3), 0.0, 1.0).astype(np.float32)
    if metric == "vgg":
        tm, jm = TVGG(vgg_path), JVGG(vgg_path)
    else:
        lin = lin_path if metric == "lpips_learned" else None
        tm, jm = TLPIPS(vgg_path, lin, allow_random=lin is None), JLPIPS(vgg_path, lin, allow_random=lin is None)
    got = tm.score(tm.prepare(torch.from_numpy(target)), torch.from_numpy(pred)).numpy()
    assert got.shape == (2, 3, 2)
    want = np.asarray(jm(np.broadcast_to(target[:, None], pred.shape), pred))
    np.testing.assert_allclose(got, want, atol=PERCEPTUAL_ATOL, rtol=0)


def test_npz_kernels_are_transposed_to_oihw(weights):
    jvgg, vgg_path, _ = weights
    state = load_params_npz(vgg_path)
    kernel = np.asarray(jvgg.variables["params"]["conv2_1"]["kernel"])  # HWIO [3,3,64,128]
    assert state["conv2_1.weight"].shape == (128, 64, 3, 3)
    np.testing.assert_array_equal(state["conv2_1.weight"].numpy(), kernel.transpose(3, 2, 0, 1))


def test_refusal_without_weights(tmp_path):
    missing = str(tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError, match="VGG16 weights"):
        TVGG(None)
    with pytest.raises(FileNotFoundError, match="VGG16 weights"):
        TVGG(missing)
    with pytest.raises(FileNotFoundError, match="VGG16 weights"):
        TLPIPS(missing, missing)
    vgg = TVGG(allow_random=True)
    assert vgg.untrained
    a, _ = _pair((1, 32, 32, 3))
    np.testing.assert_allclose(vgg(torch.from_numpy(a), torch.from_numpy(a)).numpy(), 1.0, atol=1e-5)
    assert TLPIPS(allow_random=True).untrained
