"""The port's CUDA kernels on the card, against their plain PyTorch versions,
and a small GPU rollout against the CPU rollout. Every test needs a CUDA
device and skips without one. This file imports no jax, so that it runs on a
GPU machine without jax:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` pins jax to 8 virtual CPU devices.)
"""

import pytest
import torch

from video_prediction_torch import kernels as K
from video_prediction_torch.configs.hparams import resolve_model_hparams, zoo_dir
from video_prediction_torch.models import get_model_class

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # atol = rtol; bf16: one rounding of the output


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdim", [8, 32, 40, 64, 128, 256, 300, 512])
def test_ln_gate(dev, dtype, cdim):
    g = torch.Generator(device=dev).manual_seed(cdim)
    z = (2.0 * torch.randn(77, 4 * cdim, device=dev, generator=g)).to(dtype)
    c = torch.randn(77, cdim, device=dev, generator=g).to(dtype)
    lnp = torch.rand(10, cdim, device=dev, generator=g) + 0.5
    out = K.fused_ln_gate(z, c, lnp, forget_bias=0.5)
    ref = K.fused_ln_gate_reference(z, c, lnp, forget_bias=0.5)
    for a, b in zip(out, ref):
        assert a.dtype == dtype
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_composite(dev, dtype, k):
    g = torch.Generator(device=dev).manual_seed(k)
    cand = torch.rand(2, k, 33, 31, 3, device=dev, generator=g).to(dtype)
    logits = (3.0 * torch.randn(2, 33, 31, k, device=dev, generator=g)).to(dtype)
    out, masks = K.composite(cand, logits, with_masks=True)
    ref, ref_masks = K.composite_reference(cand, logits, with_masks=True)
    _close(out, ref, dtype)
    _close(masks, ref_masks, torch.float32)


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
    assert K.launch_counts() == {"apply_cdna_kernels": 0, "fused_ln_gate": 0, "composite": 3}


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
    assert K.launch_counts() == {"apply_cdna_kernels": 5, "fused_ln_gate": 30, "composite": 5}
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)
