"""CDNA and DNA transformation-kernel application.

Port of ``video_prediction_tpu/ops/cdna.py`` (reference
``video_prediction/models/savp_model.py#apply_cdna_kernels`` and
``#apply_dna_kernels``; Finn et al. 2016): warp a frame by predicted,
normalized convolution kernels, one bank per sample (CDNA) or one per pixel
(DNA).

``apply_cdna_kernels`` is kernel K1's wrapper (``kernels/cdna.py``): its plain
version, run for CPU tensors, is the JAX package's shifted multiply-add
formulation; CUDA tensors go through the hand-written kernel.

``apply_dna_kernels`` has no Pallas kernel in the JAX package (XLA fuses its
25 shifted multiply-adds), so it stays torch ops here: one ``F.unfold`` of
the padded frame, one product with the per-pixel kernels and one sum over
the taps. Eager, the JAX package's form is 50 small kernels forward and
slice gradients backward; on the card the unfold form takes less device
time forward and backward together (the train step), the shifted form less
forward alone at large batch (``PERF.md`` §6, ``chip_smoke.py`` phase 20).

Under spatial partitioning (``parallel/mesh.py#spatial_context``) both read
the rows of a halo (``parallel/spatial.py#halo``, zeros at the global
borders): K1's wrapper runs the kernel on the shard extended by (k-1)//2
rows above and below and cuts its output to the shard's rows
(``kernels/cdna.py``); the DNA op's unfold pads W alone and reads the rows
of H from the halo.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_prediction_torch.kernels.cdna import apply_cdna_kernels  # noqa: F401
from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial

RELU_SHIFT = 1e-12


def identity_kernel(kernel_size: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Delta kernel ``[k, k]``: applying it reproduces the input image exactly."""
    k = torch.zeros((kernel_size, kernel_size), dtype=dtype)
    k[kernel_size // 2, kernel_size // 2] = 1.0
    return k


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


def apply_dna_kernels(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Apply per-pixel (dynamic neural advection) kernels: image ``[B,H,W,C]``
    and normalized kernels ``[B,H,W,kh,kw,N]`` (or ``[B,H,W,kh,kw]`` for
    N = 1) -> ``[B,N,H,W,C]``: cross-correlation of each pixel's
    neighbourhood (zero SAME padding ``(k-1)//2`` before) with its own
    kernels, shared over channels, in fp32, cast to the image dtype."""
    if kernels.dim() == 5:
        kernels = kernels[..., None]
    b, h, w, kh, kw, n = kernels.shape
    c = image.shape[-1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    mesh = current_spatial()
    if mesh is None:
        padded = F.pad(image.float().permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    else:
        padded = F.pad(SP.halo(image, mesh, ph, kh - 1 - ph).float().permute(0, 3, 1, 2), (pw, kw - 1 - pw))
    patches = F.unfold(padded, (kh, kw)).view(b, 1, c, kh * kw, h, w)  # tap (i, j) at i * kw + j
    taps = kernels.float().reshape(b, h, w, kh * kw, n).permute(0, 4, 3, 1, 2)[:, :, None]  # [B,N,1,K,H,W]
    out = (patches * taps).sum(dim=3)  # [B,N,C,H,W]
    return out.permute(0, 1, 3, 4, 2).to(image.dtype)


def apply_kernels(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Dispatch on kernel rank: 4-D -> CDNA, 5- or 6-D -> DNA (reference
    ``savp_model.py#apply_kernels``)."""
    if kernels.dim() == 4:
        return apply_cdna_kernels(image, kernels)
    return apply_dna_kernels(image, kernels)
