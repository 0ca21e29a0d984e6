"""K3: softmax mask compositing (``csrc/composite.cu``), forward and backward.

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#composite_fused``
(the maths of ``models/savp.py:381-390``): candidates ``[B,K,H,W,C]`` and
mask logits ``[B,H,W,K]`` -> softmax over K, then the mask-weighted sum of
the candidates ``[B,H,W,C]`` in the candidates' dtype; optionally also the
fp32 masks ``[B,H,W,K]``, which carry no gradient.

The Pallas kernel is forward only; JAX training differentiates the XLA
form. Here the wrapper is a ``torch.autograd.Function`` whose backward is a
CUDA kernel too (``composite_backward``). The CUDA kernels are memory-bound
(designs noted in the source). On CPU tensors the wrappers run the plain
version below (and autograd differentiates it); on CUDA tensors they launch
the kernels or raise.

The forward's launch geometry comes from ``plan``, a pure function of the
shapes, the dtype, the alignment of the tensors and the SM count, so that
the CPU tests reach it; the C launcher checks it against the instantiation
it selects.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from video_prediction_torch.kernels import _lib

MAX_CANDIDATES = 16
MAX_BACKWARD_CHANNELS = 4  # the backward keeps a pixel's C gradient values in registers
# (K, C) of the forward's compile-time instantiations, which stage a tile by
# bulk copies: the zoo's 7 candidates (ours_*) and 6 (sv2p), RGB
STAGED = ((7, 3), (6, 3))
MAX_TILE, MIN_TILE = 64, 32  # pixels a tile (and threads a block) of the forward


def composite_reference(
    candidates: torch.Tensor, mask_logits: torch.Tensor, with_masks: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel."""
    masks = torch.softmax(mask_logits.float(), dim=-1)
    out = torch.einsum("bkhwc,bhwk->bhwc", candidates.float(), masks).to(candidates.dtype)
    return out, (masks if with_masks else None)


@dataclass(frozen=True)
class Plan:
    """Geometry of one K3 forward launch (``csrc/composite.cu``)."""

    staged: int  # K of the compile-time instantiation (C = 3, bulk-staged tiles); 0: the run-time one
    tile: int  # pixels a tile, and threads a block
    tiles: int  # tiles a sample, ceil(P / tile)
    blocks: int  # B * tiles
    smem: int  # dynamic shared memory of a block, bytes


def smem_bytes(staged: bool, tile: int, k: int, cdim: int, itemsize: int) -> int:
    """A forward block's shared memory, as ``csrc/composite.cu#forward_smem_bytes``:
    staged, two mbarriers, the K candidate slices and the logits in the dtype
    and the fp32 weights; at run time the weights only."""
    return 16 + (k * tile * cdim + tile * k) * itemsize + tile * k * 4 if staged else tile * k * 4


def plan(batch: int, pixels: int, k: int, cdim: int, itemsize: int, aligned: bool, sms: int) -> Plan:
    """The launch geometry of K3 forward for ``batch`` samples of ``pixels``
    (H*W) pixels, ``k`` candidates of ``cdim`` channels in a dtype of
    ``itemsize`` bytes; ``aligned``: every tensor the kernel reads or writes
    starts on a 16-byte boundary.

    The zoo's shapes (``STAGED``) with aligned tensors and H*W a multiple of
    ``MAX_TILE`` take their compile-time instantiation; every other case the
    run-time one. A tile is ``MAX_TILE`` pixels of one sample, halved (down
    to ``MIN_TILE``) while the tiles would not give each SM a block."""
    staged = (k, cdim) in STAGED and aligned and pixels % MAX_TILE == 0
    tile = MAX_TILE
    while tile > MIN_TILE and batch * -(-pixels // tile) < sms:
        tile //= 2
    tiles = -(-pixels // tile)
    return Plan(k if staged else 0, tile, tiles, batch * tiles, smem_bytes(staged, tile, k, cdim, itemsize))


def tile_pixels(p: Plan, pixels: int, block: int) -> Tuple[int, List[int]]:
    """(sample, its pixels) that block ``block`` takes, as the kernel maps them."""
    b, t = divmod(block, p.tiles)
    return b, list(range(t * p.tile, min((t + 1) * p.tile, pixels)))


def thread_outputs(p: Plan, n: int, cdim: int, itemsize: int, thread: int) -> List[int]:
    """Flat outputs (pixel * C + channel, within a tile of ``n`` pixels) that
    thread ``thread`` writes: staged, 16-byte chunks of 16 // itemsize
    outputs, chunk ``thread``, + ``tile``, ...; at run time output
    ``thread``, + ``tile``, ..."""
    if p.staged:
        vec = 16 // itemsize
        return [j for v in range(thread, n * cdim // vec, p.tile) for j in range(v * vec, (v + 1) * vec)]
    return list(range(thread, n * cdim, p.tile))


@functools.lru_cache(maxsize=None)
def _cached_plan(batch: int, pixels: int, k: int, cdim: int, itemsize: int, aligned: bool, device: int) -> Plan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(batch, pixels, k, cdim, itemsize, aligned, sms)


def device_plan(candidates: torch.Tensor, mask_logits: torch.Tensor) -> Plan:
    """``plan`` for CUDA tensors: alignment read from their addresses (the
    outputs are fresh allocations, on a 16-byte boundary), the SM count from
    the device; cached."""
    b, k, h, w, c = candidates.shape
    aligned = candidates.data_ptr() % 16 == 0 and mask_logits.data_ptr() % 16 == 0
    return _cached_plan(b, h * w, k, c, candidates.element_size(), aligned, candidates.device.index)


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
    p = device_plan(candidates, mask_logits)
    _lib.launch(
        "vp_composite_forward", candidates.data_ptr(), mask_logits.data_ptr(), out.data_ptr(),
        masks.data_ptr() if masks is not None else None, b, h * w, k, c, p.staged, p.tile, p.smem,
        _lib.dtype_code(candidates), device=candidates.device,
    )
    _lib.count_launch(composite, candidates.dtype)
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
    _lib.count_launch(composite_backward, candidates.dtype)
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


composite.launches = {}
composite_backward.launches = {}
