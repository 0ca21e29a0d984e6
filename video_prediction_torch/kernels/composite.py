"""K3: softmax mask compositing (``csrc/composite.cu``).

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#composite_fused``
(the maths of ``models/savp.py:381-390``): candidates ``[B,K,H,W,C]`` and
mask logits ``[B,H,W,K]`` -> softmax over K, then the mask-weighted sum of
the candidates ``[B,H,W,C]`` in the candidates' dtype; optionally also the
fp32 masks ``[B,H,W,K]``.

The CUDA kernel is memory-bound (one thread per pixel; design noted in the
source). On CPU tensors the wrapper runs the plain version below; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from video_prediction_torch.kernels import _lib

MAX_CANDIDATES = 16


def composite_reference(
    candidates: torch.Tensor, mask_logits: torch.Tensor, with_masks: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel."""
    masks = torch.softmax(mask_logits.float(), dim=-1)
    out = torch.einsum("bkhwc,bhwk->bhwc", candidates.float(), masks).to(candidates.dtype)
    return out, (masks if with_masks else None)


def composite(
    candidates: torch.Tensor, mask_logits: torch.Tensor, with_masks: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``([B,K,H,W,C], [B,H,W,K]) -> ([B,H,W,C], masks [B,H,W,K] or None)``;
    the CUDA kernel on CUDA tensors."""
    if _lib.on_cpu(candidates, mask_logits):
        return composite_reference(candidates, mask_logits, with_masks)
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
    out = torch.empty((b, h, w, c), dtype=candidates.dtype, device=candidates.device)
    masks = torch.empty((b, h, w, k), dtype=torch.float32, device=candidates.device) if with_masks else None
    _lib.launch(
        "vp_composite_forward", candidates.data_ptr(), mask_logits.data_ptr(), out.data_ptr(),
        masks.data_ptr() if masks is not None else None, b, h * w, k, c, _lib.dtype_code(candidates),
        device=candidates.device,
    )
    composite.launches += 1
    return out, masks


composite.launches = 0
