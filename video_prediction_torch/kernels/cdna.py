"""K1: CDNA kernel application (``csrc/cdna.cu``).

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#apply_cdna_kernels_fused``.
Contract as in ``video_prediction_tpu/ops/cdna.py#apply_cdna_kernels``:
image ``[B,H,W,C]`` x normalized kernels ``[B,kh,kw,N]`` -> ``[B,N,H,W,C]``,
cross-correlation with zero SAME padding ``(k-1)//2``, one bank of N kernels
per sample shared over channels, fp32 accumulation, output in the image dtype.

The CUDA kernel is memory-bound at the slice's shapes; its design is noted in
the source. On CPU tensors the wrapper runs the plain version below; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_prediction_torch.kernels import _lib


def apply_cdna_kernels_reference(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: kh*kw shifted multiply-adds over the padded image."""
    b, h, w, c = image.shape
    _, kh, kw, n = kernels.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    padded = F.pad(image, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    kernels = kernels.float()
    acc = torch.zeros((b, n, h, w, c), dtype=torch.float32, device=image.device)
    for i in range(kh):
        for j in range(kw):
            tap = padded[:, i : i + h, j : j + w, :].float()
            acc = acc + tap[:, None] * kernels[:, i, j, :, None, None, None]
    return acc.to(image.dtype)


def apply_cdna_kernels(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``[B,H,W,C] x [B,kh,kw,N] -> [B,N,H,W,C]``; the CUDA kernel on CUDA tensors."""
    if _lib.on_cpu(image, kernels):
        return apply_cdna_kernels_reference(image, kernels)
    _lib.require(image.dim() == 4 and kernels.dim() == 4, "want image [B,H,W,C] and kernels [B,kh,kw,N]")
    b, h, w, c = image.shape
    kb, kh, kw, n = kernels.shape
    _lib.require(kb == b, f"batch mismatch: image {tuple(image.shape)}, kernels {tuple(kernels.shape)}")
    _lib.require(kernels.dtype == torch.float32, f"kernels must be float32, got {kernels.dtype}")
    _lib.require(image.is_contiguous() and kernels.is_contiguous(), "image and kernels must be contiguous")
    _lib.require(image.numel() > 0 and kernels.numel() > 0, "empty input")
    out = torch.empty((b, n, h, w, c), dtype=image.dtype, device=image.device)
    _lib.launch(
        "vp_cdna_forward", image.data_ptr(), kernels.data_ptr(), out.data_ptr(),
        b, h, w, c, kh, kw, n, _lib.dtype_code(image), device=image.device,
    )
    apply_cdna_kernels.launches += 1
    return out


apply_cdna_kernels.launches = 0
