"""CDNA transformation-kernel application.

Port of ``video_prediction_tpu/ops/cdna.py`` (reference
``video_prediction/models/savp_model.py#apply_cdna_kernels``; Finn et al.
2016): warp the previous frame by predicted, normalized convolution kernels.

``apply_cdna_kernels`` is kernel K1's wrapper (``kernels/cdna.py``): its plain
version, run for CPU tensors, is the JAX package's shifted multiply-add
formulation; CUDA tensors go through the hand-written kernel.
"""

from __future__ import annotations

import torch

from video_prediction_torch.kernels.cdna import apply_cdna_kernels  # noqa: F401

RELU_SHIFT = 1e-12


def normalize_kernels(kernels: torch.Tensor, method: str = "softmax") -> torch.Tensor:
    """Normalize ``[..., kh, kw, N]`` kernels over the kh*kw tap axis:
    ``softmax`` (SAVP) or ``relu`` (Finn et al. CDNA: relu then divide by the
    sum, with a shift for stability)."""
    kh, kw, n = kernels.shape[-3:]
    flat = kernels.reshape(kernels.shape[:-3] + (kh * kw, n))
    if method == "softmax":
        flat = torch.softmax(flat, dim=-2)
    elif method == "relu":
        flat = torch.relu(flat - RELU_SHIFT) + RELU_SHIFT
        flat = flat / flat.sum(dim=-2, keepdim=True)
    else:
        raise ValueError(f"unknown kernel normalization {method!r}")
    return flat.reshape(kernels.shape)
