"""K1: CDNA kernel application (``csrc/cdna.cu``), forward and backward.

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#apply_cdna_kernels_fused``.
Contract as in ``video_prediction_tpu/ops/cdna.py#apply_cdna_kernels``:
image ``[B,H,W,C]`` x normalized kernels ``[B,kh,kw,N]`` -> ``[B,N,H,W,C]``,
cross-correlation with zero SAME padding ``(k-1)//2``, one bank of N kernels
per sample shared over channels, fp32 accumulation, output in the image dtype.

The Pallas kernel is forward only; JAX training differentiates the XLA form.
Here the wrapper is a ``torch.autograd.Function`` whose backward is a CUDA
kernel too (``apply_cdna_kernels_backward``). The CUDA kernels are
memory-bound at the slice's shapes; their designs are noted in the source.
On CPU tensors the wrappers run the plain version below (and autograd
differentiates it); on CUDA tensors they launch the kernels or raise.

On a spatial shard (``parallel/mesh.py#spatial_context``: the image holds
this rank's rows of the height) ``apply_cdna_kernels`` runs on the shard
extended by a (k-1)//2-row halo above and below (``parallel/spatial.py#halo``,
zeros at the global borders) and cuts the output to the shard's rows; the
backward kernel's gradient of the halo rows goes back through the halo's
adjoint.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from video_prediction_torch.kernels import _lib
from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial


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


def _check(image: torch.Tensor, kernels: torch.Tensor) -> None:
    _lib.require(image.dim() == 4 and kernels.dim() == 4, "want image [B,H,W,C] and kernels [B,kh,kw,N]")
    _lib.require(kernels.shape[0] == image.shape[0],
                 f"batch mismatch: image {tuple(image.shape)}, kernels {tuple(kernels.shape)}")
    _lib.require(kernels.dtype == torch.float32, f"kernels must be float32, got {kernels.dtype}")
    _lib.require(image.is_contiguous() and kernels.is_contiguous(), "image and kernels must be contiguous")
    _lib.require(image.numel() > 0 and kernels.numel() > 0, "empty input")


def _forward_kernel(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    _check(image, kernels)
    b, h, w, c = image.shape
    _, kh, kw, n = kernels.shape
    out = torch.empty((b, n, h, w, c), dtype=image.dtype, device=image.device)
    _lib.launch(
        "vp_cdna_forward", image.data_ptr(), kernels.data_ptr(), out.data_ptr(),
        b, h, w, c, kh, kw, n, _lib.dtype_code(image), device=image.device,
    )
    _lib.count_launch(apply_cdna_kernels, image.dtype)
    return out


def apply_cdna_kernels_backward(
    image: torch.Tensor, kernels: torch.Tensor, grad: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d image [B,H,W,C], d kernels [B,kh,kw,N])`` of ``apply_cdna_kernels``
    for the upstream gradient ``grad [B,N,H,W,C]``; the CUDA kernel on CUDA
    tensors, autograd of the plain version on CPU tensors."""
    if _lib.on_cpu(image, kernels, grad):
        return _lib.plain_vjp(apply_cdna_kernels_reference, (image, kernels), grad)
    _check(image, kernels)
    b, h, w, c = image.shape
    _, kh, kw, n = kernels.shape
    _lib.require(tuple(grad.shape) == (b, n, h, w, c), f"grad {tuple(grad.shape)} is not [B,N,H,W,C]")
    _lib.require(grad.dtype == image.dtype, f"grad ({grad.dtype}) and image ({image.dtype}) must share a dtype")
    _lib.require(grad.is_contiguous(), "grad must be contiguous")
    tiles = _lib.query("vp_cdna_backward_tiles", b, h, w, c, kh, kw, n, image.device.index)
    _lib.require(tiles > 0, f"one image row of [{h},{w},{c}] with N={n} does not fit the kernel's shared memory")
    d_image = torch.empty_like(image)
    d_kernels = torch.empty_like(kernels)
    partial = torch.empty((b, tiles, kh * kw * n), dtype=torch.float32, device=image.device)
    _lib.launch(
        "vp_cdna_backward", image.data_ptr(), kernels.data_ptr(), grad.data_ptr(), d_image.data_ptr(),
        d_kernels.data_ptr(), partial.data_ptr(), b, h, w, c, kh, kw, n, tiles, _lib.dtype_code(image),
        device=image.device,
    )
    _lib.count_launch(apply_cdna_kernels_backward, image.dtype)
    return d_image, d_kernels


class _CDNAFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, kernels):
        ctx.save_for_backward(image, kernels)
        return _forward_kernel(image, kernels)

    @staticmethod
    def backward(ctx, grad):
        image, kernels = ctx.saved_tensors
        d_image, d_kernels = apply_cdna_kernels_backward(image, kernels, grad.contiguous())
        return (d_image if ctx.needs_input_grad[0] else None, d_kernels if ctx.needs_input_grad[1] else None)


def apply_cdna_kernels(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``[B,H,W,C] x [B,kh,kw,N] -> [B,N,H,W,C]``; the CUDA kernels (forward
    and backward) on CUDA tensors; on a spatial shard, on the halo-extended
    shard, cut to its rows."""
    mesh = current_spatial()
    if mesh is None:
        return _apply(image, kernels)
    kh, h = kernels.shape[1], image.shape[1]
    ph = (kh - 1) // 2
    return _apply(SP.halo(image, mesh, ph, kh - 1 - ph), kernels).narrow(2, ph, h)


def _apply(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    if _lib.on_cpu(image, kernels):
        return apply_cdna_kernels_reference(image, kernels)
    return _CDNAFunction.apply(image, kernels)


apply_cdna_kernels.launches = {}
apply_cdna_kernels_backward.launches = {}
