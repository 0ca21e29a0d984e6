"""Least device times of the port's six kernels, and of the DNA op that the
JAX package leaves to XLA (``ops/cdna.py#apply_dna_kernels``), from their
shapes.

Pure Python (no torch): every function takes shapes and returns counts, so
the CPU tests reach all of it. The counting rule: each input is read once
and each output written once, in the dtype given (fp32 by default), what a
kernel re-reads is not counted. The small fp32 parameter tensors are
counted like any other input or output: K1's kernels and d kernels, K2's
``ln_params`` and ``d ln_params``. Operations are the fp32 arithmetic the
function needs (multiply-adds count two), against the card's fp32 rate
outside the tensor cores: every kernel here is far below the card's
operations-per-byte line, so bytes set the bound.

    bound_ms(bytes, ops) = max(bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3

The peaks are the published ones of one H100 SXM (80 GB HBM3), at its full
700 W power limit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# K2 widths of one generator step of the flagship (ngf=32, 64x64): encoder
# 64, 128, 256 at 32, 16, 8 px; decoder 128, 64, 32 at 16, 32, 64 px
LN_GATE_STEP = ((64, 32), (128, 16), (256, 8), (128, 16), (64, 32), (32, 64))
# fp32 operations per channel of a row (five LayerNorms of two passes, the
# gate maths; the backward about twice that), a coarse count
LN_GATE_FORWARD_OPS_PER_VALUE = 50
LN_GATE_BACKWARD_OPS_PER_VALUE = 100


def bound_ms(nbytes: int, ops: int = 0) -> float:
    """Least time in ms to move ``nbytes`` and do ``ops`` fp32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def bound_by(nbytes: int, ops: int = 0) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"


def cdna_forward(b: int, h: int, w: int, c: int, k: int = 5, n: int = 4, itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of K1 forward: image [B,H,W,C] and fp32 kernels [B,k,k,N]
    in, [B,N,H,W,C] out."""
    nbytes = b * h * w * c * itemsize + b * k * k * n * 4 + b * n * h * w * c * itemsize
    return nbytes, 2 * k * k * n * b * h * w * c


def cdna_backward(b: int, h: int, w: int, c: int, k: int = 5, n: int = 4, itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of K1 backward: image, kernels and grad [B,N,H,W,C] in;
    d image and fp32 d kernels out."""
    image, kern = b * h * w * c * itemsize, b * k * k * n * 4
    grad = b * n * h * w * c * itemsize
    return 2 * image + 2 * kern + grad, 2 * 2 * k * k * n * b * h * w * c


def ln_gate_forward(rows_and_widths: Iterable[Tuple[int, int]], itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of K2 forward over calls of ``(R, C)``: z [R,4C] and c in,
    c' and h out (28 C bytes a row in fp32), plus fp32 ln_params [10,C] in."""
    nbytes = ops = 0
    for r, c in rows_and_widths:
        nbytes += 7 * r * c * itemsize + 10 * c * 4
        ops += LN_GATE_FORWARD_OPS_PER_VALUE * r * c
    return nbytes, ops


def ln_gate_backward(rows_and_widths: Iterable[Tuple[int, int]], itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of K2 backward over calls of ``(R, C)``: z, c, dc', dh in
    and dz, dc out (48 C bytes a row in fp32), plus fp32 ln_params in and d
    ln_params out."""
    nbytes = ops = 0
    for r, c in rows_and_widths:
        nbytes += 12 * r * c * itemsize + 2 * 10 * c * 4
        ops += LN_GATE_BACKWARD_OPS_PER_VALUE * r * c
    return nbytes, ops


def ln_gate_step(batch: int) -> Tuple[Tuple[int, int], ...]:
    """The six ``(R, C)`` K2 calls of one generator step at ``batch``."""
    return tuple((batch * px * px, c) for c, px in LN_GATE_STEP)


def composite_forward(b: int, k: int, h: int = 64, w: int = 64, c: int = 3, itemsize: int = 4,
                      with_masks: bool = False) -> Tuple[int, int]:
    """(bytes, ops) of K3 forward: candidates [B,K,H,W,C] and logits
    [B,H,W,K] in, the composite [B,H,W,C] out (and the fp32 masks if asked)."""
    p = b * h * w
    nbytes = p * k * c * itemsize + p * k * itemsize + p * c * itemsize + (p * k * 4 if with_masks else 0)
    return nbytes, p * k * (4 + 2 * c)


def composite_backward(b: int, k: int, h: int = 64, w: int = 64, c: int = 3, itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of K3 backward: candidates, logits and grad [B,H,W,C] in;
    d candidates and d logits out."""
    p = b * h * w
    nbytes = 2 * (p * k * c * itemsize + p * k * itemsize) + p * c * itemsize
    return nbytes, p * k * (6 + 4 * c)


def dna_forward(b: int, h: int, w: int, c: int, k: int = 5, n: int = 1, itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of ``apply_dna_kernels``: image [B,H,W,C] and fp32
    per-pixel kernels [B,H,W,k,k,N] in, [B,N,H,W,C] out."""
    nbytes = b * h * w * c * itemsize + b * h * w * k * k * n * 4 + b * n * h * w * c * itemsize
    return nbytes, 2 * k * k * n * b * h * w * c


def dna_backward(b: int, h: int, w: int, c: int, k: int = 5, n: int = 1, itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, ops) of its backward: image, kernels and grad [B,N,H,W,C] in;
    d image and fp32 d kernels out."""
    image, kern = b * h * w * c * itemsize, b * h * w * k * k * n * 4
    return 2 * image + 2 * kern + b * n * h * w * c * itemsize, 2 * 2 * k * k * n * b * h * w * c
