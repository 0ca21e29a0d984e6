"""K3: softmax mask compositing (``csrc/composite.cu``), forward and backward.

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#composite_fused``
(the maths of ``models/savp.py:381-390``): candidates ``[B,K,H,W,C]`` and
mask logits ``[B,H,W,K]`` -> softmax over K, then the mask-weighted sum of
the candidates ``[B,H,W,C]`` in the candidates' dtype; optionally also the
fp32 masks ``[B,H,W,K]``, which carry no gradient.

The Pallas kernel is forward only; JAX training differentiates the XLA
form. Here the wrapper is a ``torch.autograd.Function`` whose backward is a
CUDA kernel too (``composite_backward``). The CUDA kernels are memory-bound
(one thread per pixel; designs noted in the source). On CPU tensors the
wrappers run the plain version below (and autograd differentiates it); on
CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from video_prediction_torch.kernels import _lib

MAX_CANDIDATES = 16
MAX_BACKWARD_CHANNELS = 4  # the backward keeps a pixel's C gradient values in registers


def composite_reference(
    candidates: torch.Tensor, mask_logits: torch.Tensor, with_masks: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel."""
    masks = torch.softmax(mask_logits.float(), dim=-1)
    out = torch.einsum("bkhwc,bhwk->bhwc", candidates.float(), masks).to(candidates.dtype)
    return out, (masks if with_masks else None)


def _check(candidates: torch.Tensor, mask_logits: torch.Tensor) -> None:
    _lib.require(candidates.dim() == 5, "want candidates [B,K,H,W,C]")
    b, k, h, w, c = candidates.shape
    _lib.require(
        tuple(mask_logits.shape) == (b, h, w, k),
        f"mask_logits {tuple(mask_logits.shape)} does not match candidates {tuple(candidates.shape)}",
    )
    _lib.require(mask_logits.dtype == candidates.dtype, "candidates and mask_logits must share a dtype")
    _lib.require(0 < k <= MAX_CANDIDATES, f"K={k} outside 1..{MAX_CANDIDATES}")
    _lib.require(candidates.numel() > 0, "empty input")
    _lib.require(
        candidates.is_contiguous() and mask_logits.is_contiguous(),
        "candidates and mask_logits must be contiguous",
    )


def _forward_kernel(candidates, mask_logits, with_masks):
    _check(candidates, mask_logits)
    b, k, h, w, c = candidates.shape
    out = torch.empty((b, h, w, c), dtype=candidates.dtype, device=candidates.device)
    masks = torch.empty((b, h, w, k), dtype=torch.float32, device=candidates.device) if with_masks else None
    _lib.launch(
        "vp_composite_forward", candidates.data_ptr(), mask_logits.data_ptr(), out.data_ptr(),
        masks.data_ptr() if masks is not None else None, b, h * w, k, c, _lib.dtype_code(candidates),
        device=candidates.device,
    )
    composite.launches += 1
    return out, masks


def composite_backward(
    candidates: torch.Tensor, mask_logits: torch.Tensor, grad: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d candidates [B,K,H,W,C], d mask_logits [B,H,W,K])`` of
    ``composite``'s image output for the upstream gradient ``grad
    [B,H,W,C]``; the CUDA kernel on CUDA tensors, autograd of the plain
    version on CPU tensors."""
    if _lib.on_cpu(candidates, mask_logits, grad):
        return _lib.plain_vjp(lambda a, m: composite_reference(a, m)[0], (candidates, mask_logits), grad)
    _check(candidates, mask_logits)
    b, k, h, w, c = candidates.shape
    _lib.require(0 < c <= MAX_BACKWARD_CHANNELS, f"C={c} outside 1..{MAX_BACKWARD_CHANNELS}")
    _lib.require(tuple(grad.shape) == (b, h, w, c), f"grad {tuple(grad.shape)} is not [B,H,W,C]")
    _lib.require(grad.dtype == candidates.dtype and grad.is_contiguous(),
                 f"grad must be contiguous {candidates.dtype}, got {grad.dtype}")
    d_cand = torch.empty_like(candidates)
    d_logits = torch.empty_like(mask_logits)
    _lib.launch(
        "vp_composite_backward", candidates.data_ptr(), mask_logits.data_ptr(), grad.data_ptr(),
        d_cand.data_ptr(), d_logits.data_ptr(), b, h * w, k, c, _lib.dtype_code(candidates),
        device=candidates.device,
    )
    composite_backward.launches += 1
    return d_cand, d_logits


class _CompositeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, candidates, mask_logits, with_masks):
        ctx.save_for_backward(candidates, mask_logits)
        out, masks = _forward_kernel(candidates, mask_logits, with_masks)
        if masks is None:
            return out
        ctx.mark_non_differentiable(masks)
        return out, masks

    @staticmethod
    def backward(ctx, grad, *unused_masks_grad):
        candidates, mask_logits = ctx.saved_tensors
        d_cand, d_logits = composite_backward(candidates, mask_logits, grad.contiguous())
        need = ctx.needs_input_grad
        return (d_cand if need[0] else None, d_logits if need[1] else None, None)


def composite(
    candidates: torch.Tensor, mask_logits: torch.Tensor, with_masks: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``([B,K,H,W,C], [B,H,W,K]) -> ([B,H,W,C], masks [B,H,W,K] or None)``;
    the CUDA kernels (forward and backward) on CUDA tensors."""
    if _lib.on_cpu(candidates, mask_logits):
        return composite_reference(candidates, mask_logits, with_masks)
    if with_masks:
        return _CompositeFunction.apply(candidates, mask_logits, True)
    return _CompositeFunction.apply(candidates, mask_logits, False), None


composite.launches = 0
composite_backward.launches = 0
