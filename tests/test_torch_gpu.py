"""The port's CUDA kernels on the card, forward and backward, against their
plain PyTorch versions (the backward against autograd of the plain
version), also at the evaluate path's shapes (8 examples x 8 samples, and
SV2P's 6 candidates), a small GPU rollout and train step against the CPU
ones (fp32, and the bf16 model with the dtype of every launch), SSIM on
the card against the CPU, ``data.DeviceFeeder`` (pinned uint8 host
buffers, the copy on a side stream), and a train call of two steps captured
and replayed as one CUDA graph against eager steps. Every test needs a CUDA
device and skips without one. This file imports no jax, so that it runs on a
GPU machine without jax:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` pins jax to 8 virtual CPU devices.)
"""

import time

import numpy as np
import pytest
import torch

from video_prediction_torch import kernels as K
from video_prediction_torch.data import DeviceFeeder
from video_prediction_torch import metrics as M
from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
from video_prediction_torch.kernels.composite import MAX_TILE, STAGED, device_plan
from video_prediction_torch.kernels._lib import plain_vjp
from video_prediction_torch.models import get_model_class

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # atol = rtol; bf16: one rounding of the output
# d kernels and d ln_params sum up to H*W*C or R terms in another order than
# autograd: tolerance relative to the largest value of the reference
REDUCTION_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 64, 64, 3, 5, 4), (2, 13, 9, 2, 3, 2), (1, 200, 40, 1, 5, 7)])
def test_cdna(dev, dtype, shape):
    b, h, w, c, k, n = shape
    g = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand(b, h, w, c, device=dev, generator=g).to(dtype)
    kernels = torch.softmax(torch.randn(b, k * k, n, device=dev, generator=g), 1).reshape(b, k, k, n)
    _close(K.apply_cdna_kernels(image, kernels), K.apply_cdna_kernels_reference(image, kernels), dtype)


def _unaligned(x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# K2: the compile-time widths (16-byte chunks, several rows a warp below 128)
# at a ragged last tile and at many tiles; the run-time instantiation at other
# widths and, through ``aligned=False``, at every width
LN_GATE_SHAPES = [(8, 77), (32, 77), (32, 5000), (40, 77), (64, 77), (64, 3001), (128, 77), (256, 77), (256, 517),
                  (300, 77), (512, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("cdim,rows", LN_GATE_SHAPES)
def test_ln_gate(dev, dtype, aligned, cdim, rows):
    g = torch.Generator(device=dev).manual_seed(cdim)
    z = (2.0 * torch.randn(rows, 4 * cdim, device=dev, generator=g)).to(dtype)
    c = torch.randn(rows, cdim, device=dev, generator=g).to(dtype)
    lnp = torch.rand(10, cdim, device=dev, generator=g) + 0.5
    if not aligned:
        z, c = _unaligned(z), _unaligned(c)
    out = K.fused_ln_gate(z, c, lnp, forget_bias=0.5)
    ref = K.fused_ln_gate_reference(z, c, lnp, forget_bias=0.5)
    for a, b in zip(out, ref):
        assert a.dtype == dtype
        _close(a, b, dtype)
    assert all(torch.equal(a, b) for a, b in zip(out, K.fused_ln_gate(z, c, lnp, forget_bias=0.5)))


# K3 forward: the zoo's shapes at the generation batch (K = 7 ours_savp, 6
# sv2p; compile-time instantiations, bulk-staged tiles when aligned), and the
# run-time instantiation at 33x31 (a ragged last tile), K = 1 and 16, C = 1,
# and through ``aligned=False`` at every shape
COMPOSITE_SHAPES = [(8, 7, 64, 64, 3), (8, 6, 64, 64, 3), (2, 1, 33, 31, 3), (2, 7, 33, 31, 3), (2, 16, 33, 31, 3),
                    (3, 5, 17, 19, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", COMPOSITE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_composite(dev, dtype, aligned, shape):
    b, k, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(k)
    cand = torch.rand(b, k, h, w, c, device=dev, generator=g).to(dtype)
    logits = (3.0 * torch.randn(b, h, w, k, device=dev, generator=g)).to(dtype)
    if not aligned:
        cand, logits = _unaligned(cand), _unaligned(logits)
    staged = aligned and (k, c) in STAGED and h * w % MAX_TILE == 0
    assert device_plan(cand, logits).staged == (k if staged else 0)
    out, masks = K.composite(cand, logits, with_masks=True)
    ref, ref_masks = K.composite_reference(cand, logits, with_masks=True)
    assert out.dtype == dtype and masks.dtype == torch.float32
    _close(out, ref, dtype)
    _close(masks, ref_masks, torch.float32)
    alone, no_masks = K.composite(cand, logits)
    again = K.composite(cand, logits, with_masks=True)
    assert no_masks is None and torch.equal(alone, out)
    assert torch.equal(again[0], out) and torch.equal(again[1], masks)


EVAL_BATCH = 64  # evaluate's defaults: batch 8 x 8 stochastic samples in one rollout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_at_the_eval_shapes(dev, dtype):
    """K1 ``[64,64,64,3] x [64,5,5,4]``; K2 at the six widths of a generator
    step (up to 262144 rows at C=32); K3 with 7 candidates (``ours_savp``) and
    6 (``sv2p``: 4 CDNA, prev, scratch)."""
    b = EVAL_BATCH
    g = torch.Generator(device=dev).manual_seed(64)
    image = torch.rand(b, 64, 64, 3, device=dev, generator=g).to(dtype)
    kernels = torch.softmax(torch.randn(b, 25, 4, device=dev, generator=g), 1).reshape(b, 5, 5, 4)
    _close(K.apply_cdna_kernels(image, kernels), K.apply_cdna_kernels_reference(image, kernels), dtype)
    for cdim, px in [(32, 64), (64, 32), (128, 16), (256, 8)]:
        rows = b * px * px
        z = (2.0 * torch.randn(rows, 4 * cdim, device=dev, generator=g)).to(dtype)
        c = torch.randn(rows, cdim, device=dev, generator=g).to(dtype)
        lnp = torch.rand(10, cdim, device=dev, generator=g) + 0.5
        for out, ref in zip(K.fused_ln_gate(z, c, lnp), K.fused_ln_gate_reference(z, c, lnp)):
            _close(out, ref, dtype)
    for k in (7, 6):
        cand = torch.rand(b, k, 64, 64, 3, device=dev, generator=g).to(dtype)
        logits = (3.0 * torch.randn(b, 64, 64, k, device=dev, generator=g)).to(dtype)
        out, masks = K.composite(cand, logits, with_masks=True)
        ref, ref_masks = K.composite_reference(cand, logits, with_masks=True)
        _close(out, ref, dtype)
        _close(masks, ref_masks, torch.float32)


def test_ssim_on_the_card_is_fp32_with_tf32_on(dev):
    """cuDNN's TF32 left at its default (on): SSIM's Gaussian filter still
    runs in fp32 and matches the CPU, and the setting is restored."""
    g = torch.Generator().manual_seed(8)
    target = torch.rand(8, 10, 64, 64, 3, generator=g)
    pred = (target + 0.1 * torch.randn(target.shape, generator=g)).clamp(0, 1)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        ssim = M.structural_similarity(target.to(dev), pred.to(dev)).cpu()
        psnr = M.peak_signal_to_noise_ratio(target.to(dev), pred.to(dev)).cpu()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    torch.testing.assert_close(ssim, M.structural_similarity(target, pred), atol=1e-5, rtol=0)
    torch.testing.assert_close(psnr, M.peak_signal_to_noise_ratio(target, pred), atol=1e-4, rtol=0)


def _plain_grads(reference, inputs, grads):
    """Autograd of the plain version, in fp32 on the inputs' values, rounded
    once to the inputs' dtypes: for bf16 the plain version's own autograd
    rounds every tap's or gate's gradient to bf16 at its ``.float()`` casts
    before summing, while the kernels sum in fp32."""
    f32 = [x.float() for x in inputs]
    out = plain_vjp(reference, f32, [g.float() for g in grads])
    return [o.to(x.dtype) for o, x in zip(out, inputs)]


def _close_reduction(out, ref):
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, atol=REDUCTION_RTOL * scale, rtol=REDUCTION_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 64, 64, 3, 5, 4), (2, 13, 9, 2, 3, 2), (1, 200, 40, 1, 5, 7)])
def test_cdna_backward(dev, dtype, shape):
    b, h, w, c, k, n = shape
    g = torch.Generator(device=dev).manual_seed(1)
    image = torch.rand(b, h, w, c, device=dev, generator=g).to(dtype)
    kernels = torch.softmax(torch.randn(b, k * k, n, device=dev, generator=g), 1).reshape(b, k, k, n)
    grad = torch.randn(b, n, h, w, c, device=dev, generator=g).to(dtype)
    d_image, d_kernels = K.apply_cdna_kernels_backward(image, kernels, grad)
    ref_image, ref_kernels = _plain_grads(K.apply_cdna_kernels_reference, (image, kernels), (grad,))
    assert d_image.dtype == dtype and d_kernels.dtype == torch.float32
    _close(d_image, ref_image, dtype)
    _close_reduction(d_kernels, ref_kernels)


# K1's dispatch: the flagship instantiation (C=3, 5x5, N=4; 4 x positions a
# thread) at one sample (tiles of few rows), at ragged H and W (a partial last
# tile and a partial last run of 4 x), at the train step's batch; and the
# run-time instantiation at another N, C and kernel size
CDNA_BRANCHES = [(1, 64, 64, 3, 5, 4), (5, 37, 30, 3, 5, 4), (32, 64, 64, 3, 5, 4), (2, 64, 64, 3, 5, 3),
                 (2, 16, 16, 4, 5, 4), (2, 9, 11, 3, 3, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CDNA_BRANCHES)
def test_cdna_dispatch_branches(dev, dtype, shape):
    b, h, w, c, k, n = shape
    g = torch.Generator(device=dev).manual_seed(b * h)
    image = torch.rand(b, h, w, c, device=dev, generator=g).to(dtype)
    kernels = torch.softmax(torch.randn(b, k * k, n, device=dev, generator=g), 1).reshape(b, k, k, n)
    grad = torch.randn(b, n, h, w, c, device=dev, generator=g).to(dtype)
    _close(K.apply_cdna_kernels(image, kernels), K.apply_cdna_kernels_reference(image, kernels), dtype)
    d_image, d_kernels = K.apply_cdna_kernels_backward(image, kernels, grad)
    ref_image, ref_kernels = _plain_grads(K.apply_cdna_kernels_reference, (image, kernels), (grad,))
    _close(d_image, ref_image, dtype)
    _close_reduction(d_kernels, ref_kernels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cdna_unaligned_image(dev, dtype):
    """A contiguous image that starts 1 element past a 16-byte boundary, and a
    gradient likewise: both directions still match."""
    b, h, w, c = 3, 64, 64, 3
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.rand(b * h * w * c + 1, device=dev, generator=g).to(dtype)
    image = big[1:].view(b, h, w, c)
    big_grad = torch.randn(b * 4 * h * w * c + 1, device=dev, generator=g).to(dtype)
    grad = big_grad[1:].view(b, 4, h, w, c)
    assert image.is_contiguous() and image.data_ptr() % 16 != 0
    kernels = torch.softmax(torch.randn(b, 25, 4, device=dev, generator=g), 1).reshape(b, 5, 5, 4)
    _close(K.apply_cdna_kernels(image, kernels), K.apply_cdna_kernels_reference(image, kernels), dtype)
    d_image, d_kernels = K.apply_cdna_kernels_backward(image, kernels, grad)
    ref_image, ref_kernels = _plain_grads(K.apply_cdna_kernels_reference, (image, kernels), (grad,))
    _close(d_image, ref_image, dtype)
    _close_reduction(d_kernels, ref_kernels)


def test_cdna_backward_is_bitwise_deterministic(dev):
    """d kernels is a two-pass reduction in a fixed order: two runs at the
    train step's shapes give the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    image = torch.rand(32, 64, 64, 3, device=dev, generator=g)
    kernels = torch.softmax(torch.randn(32, 25, 4, device=dev, generator=g), 1).reshape(32, 5, 5, 4)
    grad = torch.randn(32, 4, 64, 64, 3, device=dev, generator=g)
    first = K.apply_cdna_kernels_backward(image, kernels, grad)
    second = K.apply_cdna_kernels_backward(image, kernels, grad)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("cdim,rows", LN_GATE_SHAPES + [(128, 2048)])
def test_ln_gate_backward(dev, dtype, aligned, cdim, rows):
    g = torch.Generator(device=dev).manual_seed(cdim)
    z = (2.0 * torch.randn(rows, 4 * cdim, device=dev, generator=g)).to(dtype)
    c = torch.randn(rows, cdim, device=dev, generator=g).to(dtype)
    lnp = torch.rand(10, cdim, device=dev, generator=g) + 0.5
    dcn = torch.randn(rows, cdim, device=dev, generator=g).to(dtype)
    dhn = torch.randn(rows, cdim, device=dev, generator=g).to(dtype)
    if not aligned:
        z, c, dcn, dhn = map(_unaligned, (z, c, dcn, dhn))
    dz, dc, dln = K.fused_ln_gate_backward(z, c, lnp, dcn, dhn, forget_bias=0.5)
    ref = _plain_grads(lambda a, b_, p: K.fused_ln_gate_reference(a, b_, p, 0.5), (z, c, lnp), (dcn, dhn))
    assert dz.dtype == dtype and dc.dtype == dtype and dln.dtype == torch.float32
    _close(dz, ref[0], dtype)
    _close(dc, ref[1], dtype)
    _close_reduction(dln, ref[2])
    again = K.fused_ln_gate_backward(z, c, lnp, dcn, dhn, forget_bias=0.5)
    assert all(torch.equal(a, b) for a, b in zip((dz, dc, dln), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_composite_backward(dev, dtype, k):
    g = torch.Generator(device=dev).manual_seed(k)
    cand = torch.rand(2, k, 33, 31, 3, device=dev, generator=g).to(dtype)
    logits = (3.0 * torch.randn(2, 33, 31, k, device=dev, generator=g)).to(dtype)
    grad = torch.randn(2, 33, 31, 3, device=dev, generator=g).to(dtype)
    d_cand, d_logits = K.composite_backward(cand, logits, grad)
    ref = _plain_grads(lambda a, m: K.composite_reference(a, m)[0], (cand, logits), (grad,))
    _close(d_cand, ref[0], dtype)
    _close(d_logits, ref[1], dtype)


def test_backward_through_each_wrapper_reaches_its_inputs(dev):
    """``loss.backward()`` through a wrapper on CUDA tensors gives every input
    the plain version's gradient (not silence), and launches the backward
    kernel once."""
    g = torch.Generator(device=dev).manual_seed(3)
    cases = {
        "apply_cdna_kernels": (K.apply_cdna_kernels_reference, (
            torch.rand(2, 16, 16, 3, device=dev, generator=g),
            torch.softmax(torch.randn(2, 25, 4, device=dev, generator=g), 1).reshape(2, 5, 5, 4))),
        "fused_ln_gate": (K.fused_ln_gate_reference, (
            torch.randn(50, 128, device=dev, generator=g), torch.randn(50, 32, device=dev, generator=g),
            torch.rand(10, 32, device=dev, generator=g) + 0.5)),
        "composite": (lambda a, m: K.composite_reference(a, m)[0], (
            torch.rand(2, 7, 8, 8, 3, device=dev, generator=g), torch.randn(2, 8, 8, 7, device=dev, generator=g))),
    }
    for name, (reference, inputs) in cases.items():
        leaves = [x.clone().requires_grad_() for x in inputs]
        K.reset_launch_counts()
        out = K.WRAPPERS[name](*leaves)
        out = out[0] if name == "composite" else torch.cat(out, dim=-1) if name == "fused_ln_gate" else out
        weights = torch.randn(out.shape, device=dev, generator=g)
        (out * weights).sum().backward()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        assert counts[name] == 1 and counts[name + "_backward"] == 1, counts
        ref_leaves = [x.clone().requires_grad_() for x in inputs]
        ref_out = reference(*ref_leaves)
        ref_out = torch.cat(ref_out, dim=-1) if name == "fused_ln_gate" else ref_out
        (ref_out * weights).sum().backward()
        for leaf, ref_leaf in zip(leaves, ref_leaves):
            assert leaf.grad is not None, name
            torch.testing.assert_close(leaf.grad, ref_leaf.grad, atol=1e-4, rtol=1e-4)


def test_inputs_the_kernels_do_not_take_raise(dev):
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_ln_gate(torch.zeros(8, 128, device=dev), torch.zeros(8, 64, device=dev)[:, :32],
                        torch.ones(10, 32, device=dev))
    with pytest.raises(ValueError, match="outside"):
        K.fused_ln_gate(torch.zeros(8, 4 * 513, device=dev), torch.zeros(8, 513, device=dev),
                        torch.ones(10, 513, device=dev))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.composite(torch.zeros(1, 3, 4, 4, 1, device=dev, dtype=torch.float16),
                    torch.zeros(1, 4, 4, 3, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="several devices"):
        K.apply_cdna_kernels(torch.zeros(1, 4, 4, 3, device=dev), torch.zeros(1, 3, 3, 2))


def test_launch_counter_counts_kernel_launches(dev):
    K.reset_launch_counts()
    for _ in range(3):
        K.composite(torch.rand(1, 3, 4, 4, 1, device=dev), torch.zeros(1, 4, 4, 3, device=dev))
    assert K.launch_counts() == {"apply_cdna_kernels": 0, "fused_ln_gate": 0, "composite": 3,
                                 "apply_cdna_kernels_backward": 0, "fused_ln_gate_backward": 0,
                                 "composite_backward": 0}


def test_small_rollout_gpu_matches_cpu(dev, no_tf32):
    """64 px (3 scales, 6 ConvLSTM cells), ngf=8, 6 frames: the GPU rollout
    (kernels) equals the CPU rollout (plain versions) of the same weights,
    batch and z, and each step launches 1 K1, 6 K2 and 1 K3."""
    cls = get_model_class("savp")
    hp = resolve_model_hparams(
        cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
        extra=dict(ngf=8, nef=8, sequence_length=6),
    )
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.rand(2, 6, 64, 64, 3, generator=g), "actions": torch.randn(2, 6, 4, generator=g)}
    z = torch.randn(2, 5, 8, generator=g)
    with torch.inference_mode():
        ref = model(batch, zs_prior=z)["gen_images"]
        gpu = model.to(dev)
        K.reset_launch_counts()
        out = gpu({k: v.to(dev) for k, v in batch.items()}, zs_prior=z.to(dev))["gen_images"]
        torch.cuda.synchronize()
    assert K.launch_counts() == {"apply_cdna_kernels": 5, "fused_ln_gate": 30, "composite": 5,
                                 "apply_cdna_kernels_backward": 0, "fused_ln_gate_backward": 0,
                                 "composite_backward": 0}
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


def test_small_bf16_model_gpu_matches_cpu(dev, no_tf32):
    """The bf16 model (``ours_savp_tpu``: bf16 compute and gates) at ngf=8, 64
    px, 6 frames: a rollout and a loss backward on the card launch K1 and K3
    on fp32 tensors and K2 on bf16 ones, and the GPU rollout stays within
    twice the CPU bf16 rollout's distance from the CPU fp32 one (same weights,
    batch and z)."""
    cls = get_model_class("savp")
    hp = resolve_model_hparams(
        cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "ours_savp_tpu" / "model_hparams.json"),
        extra=dict(ngf=8, nef=8, ndf=8, sequence_length=6),
    )
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    fp32 = cls(hp.replace(compute_dtype="float32", gate_dtype="float32"), image_shape=(64, 64, 3), action_dim=4)
    fp32.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.rand(2, 6, 64, 64, 3, generator=g), "actions": torch.randn(2, 6, 4, generator=g)}
    z = torch.randn(2, 5, 8, generator=g)
    with torch.inference_mode():
        ref16, ref32 = model(batch, zs_prior=z)["gen_images"], fp32(batch, zs_prior=z)["gen_images"]
    gpu = model.to(dev)
    gbatch = {k: v.to(dev) for k, v in batch.items()}
    K.reset_launch_counts()
    with torch.inference_mode():
        out = gpu(gbatch, zs_prior=z.to(dev))["gen_images"].cpu()
    total, _ = gpu.compute_losses(gbatch, 0, generator=torch.Generator(device=dev).manual_seed(2))
    total.backward()
    torch.cuda.synchronize()
    assert K.launch_dtypes() == {"apply_cdna_kernels": {"float32": 10}, "fused_ln_gate": {"bfloat16": 60},
                                 "composite": {"float32": 10}, "apply_cdna_kernels_backward": {"float32": 5},
                                 "fused_ln_gate_backward": {"bfloat16": 30}, "composite_backward": {"float32": 5}}
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    rhs = float((ref16 - ref32).abs().max())
    assert rhs > 0.0 and float((out - ref16).abs().max()) <= 2.0 * rhs


def _small_train_runs(dev, steps_per_call, batches):
    """4 train steps of the small flagship (ngf=8, 64 px, 6 frames, batch 2)
    on the card, ``steps_per_call`` a call, from the same weights, noise
    seed and Adams (those of 2 steps a call): every step's scalars, the
    parameters after, and the launches of the last call."""
    import copy

    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    cls = get_model_class("savp")
    hp = resolve_model_hparams(
        cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
        extra=dict(ngf=8, nef=8, ndf=8, sequence_length=6, batch_size=2),
    )
    model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    model = copy.deepcopy(model).to(dev)
    ts = TrainState(model, *make_optimizers(model, 2), 0, torch.Generator(device=dev).manual_seed(3))
    step = make_train_step(model, steps_per_call)
    rows = []
    for c in range(len(batches) // steps_per_call):
        K.reset_launch_counts()
        chunk = batches[c * steps_per_call:(c + 1) * steps_per_call]
        if steps_per_call == 1:
            rows.append(torch.stack(list(step(ts, chunk[0]).values()))[None])
        else:
            step(ts, {k: torch.stack([b[k] for b in chunk]) for k in chunk[0]})
            rows.append(step.scalars_by_step)
        torch.cuda.synchronize()
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return torch.cat(rows).cpu(), params, init, K.launch_dtypes(), ts.step


@pytest.fixture
def deterministic_cudnn():
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


def test_steps_per_call_graph_replays_the_eager_steps(dev, no_tf32, deterministic_cudnn):
    """Two calls of 2 steps (the first eager, the second captured as one CUDA
    graph and replayed) against 4 eager steps, with cuDNN's deterministic
    algorithms: every step's loss terms and each parameter leaf within twice
    the spread of two eager runs plus 1e-3 (chip_smoke.py phase 24's rule);
    the replayed call counts each kernel's launches once, as 2 eager steps
    do (K1 5, K2 30, K3 5 a step backward, and twice that forward: the
    flagship's ``remat`` recomputes the cell in the backward pass)."""
    g = torch.Generator().manual_seed(1)
    batches = [{"images": torch.randint(0, 256, (2, 6, 64, 64, 3), generator=g, dtype=torch.uint8).to(dev),
                "actions": torch.randn(2, 6, 4, generator=g).to(dev)} for _ in range(4)]
    eager, again, graph = (_small_train_runs(dev, k, batches) for k in (1, 1, 2))
    assert graph[4] == eager[4] == 4
    per_step = {"apply_cdna_kernels": 5, "fused_ln_gate": 30, "composite": 5}
    per_step.update({f"{k}_backward": n for k, n in per_step.items()})
    per_step.update({k: 2 * n for k, n in per_step.items() if not k.endswith("_backward")})
    assert graph[3] == {k: {"float32": 2 * n} for k, n in per_step.items()}
    assert eager[3] == {k: {"float32": n} for k, n in per_step.items()}

    def rel(a, b):
        return ((a[0] - b[0]).abs() / a[0].abs().clamp_min(1e-12)).amax(dim=0)

    assert bool((rel(eager, graph) <= 2.0 * rel(eager, again) + 1e-3).all())
    init = eager[2]
    for name, p in eager[1].items():
        change = float((p - init[name]).norm().clamp_min(1e-30))
        spread = float((again[1][name] - p).norm()) / change
        assert float((graph[1][name] - p).norm()) / change <= 2.0 * spread + 1e-3, name


def test_remat_draws_no_random_numbers_on_the_card(dev):
    """The small flagship's loss and backward with ``remat`` ``full`` and
    ``names`` (the cell recomputed in the backward pass) leave the CUDA
    generator's state as it was: the checkpoint keeps no RNG state, and the
    cell draws none (its noise comes from the step's own generator)."""
    cls = get_model_class("savp")
    for policy in ("full", "names"):
        hp = resolve_model_hparams(
            cls.default_hparams(), str(zoo_dir() / "bair_action_free" / "ours_savp" / "model_hparams.json"),
            extra=dict(ngf=8, nef=8, ndf=8, sequence_length=6, batch_size=2, learn_prior=True, remat_policy=policy),
        )
        model = cls(hp, image_shape=(64, 64, 3), action_dim=4)
        model.init_weights(torch.Generator().manual_seed(0))
        model = model.to(dev)
        g = torch.Generator().manual_seed(1)
        batch = {"images": torch.rand(2, 6, 64, 64, 3, generator=g).to(dev),
                 "actions": torch.randn(2, 6, 4, generator=g).to(dev)}
        before = torch.cuda.get_rng_state(dev)
        K.reset_launch_counts()
        total, _ = model.compute_losses(batch, 0, generator=torch.Generator(device=dev).manual_seed(2))
        total.backward()
        torch.cuda.synchronize()
        assert torch.equal(torch.cuda.get_rng_state(dev), before), policy
        assert K.launch_counts()["composite"] == 10 and K.launch_counts()["composite_backward"] == 5, policy


def test_device_feeder_batches_equal_the_host_batches(dev):
    """20 batches: on the card byte for byte as on the host, uint8 images;
    the host side in pinned buffers; the stream's end ends the feeder."""
    rng = np.random.RandomState(0)
    host = [{"images": rng.randint(0, 256, (4, 12, 64, 64, 3), np.uint8),
             "actions": rng.rand(4, 12, 4).astype(np.float32)} for _ in range(20)]
    feeder = DeviceFeeder(iter(host), dev)
    try:
        for h in host:
            b = next(feeder)
            assert sorted(b) == sorted(h) and b["images"].dtype == torch.uint8
            for k in h:
                assert b[k].device == dev and b[k].cpu().numpy().tobytes() == h[k].tobytes(), k
        with pytest.raises(StopIteration):
            next(feeder)
        slots = [s for s in feeder._slots if s is not None]
        assert slots and all(t.is_pinned() for s in slots for t in s.values())
        assert all(s["images"].dtype == torch.uint8 for s in slots)
    finally:
        feeder.close()
    assert not feeder._thread.is_alive()


def test_device_feeder_consumer_never_sees_the_next_batch(dev):
    """The consumer writes into each batch behind a sleep kernel on its own
    stream and drops it: without the wait on the copy's event it could read
    before the copy lands, and without ``record_stream`` the allocator could
    hand the memory to the next copy, which would then land first."""
    host = [{"images": np.full((8, 12, 64, 64, 3), i, np.uint8)} for i in range(20)]
    feeder = DeviceFeeder(iter(host), dev)
    seen = []
    try:
        for _ in host:
            b = next(feeder)
            torch.cuda._sleep(2_000_000)  # about 1 ms of the consumer's stream before it reads
            x = b["images"]
            x.add_(1)
            seen.append(torch.stack([x.amin(), x.amax()]))
            del b, x
            time.sleep(0.002)  # the feeder allocates and copies the next batches meanwhile
        torch.cuda.synchronize()
    finally:
        feeder.close()
    assert [s.tolist() for s in seen] == [[i + 1, i + 1] for i in range(20)]
