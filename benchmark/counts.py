"""The work of a unit, counted from the configuration's hparams and shapes:
model FLOPs for the ``mfu.*`` metrics and the bytes of the hand-written
kernels K1-K3 for ``hand_kernels_roofline.*``. What every model shares is
here; each model's own counts (its layers, the kernels a generator step
launches) are in ``benchmark/models/<model>.py``.

FLOPs: every conv, 3-D conv and dense layer, two per multiply-add, nothing
else (no norms, gates, softmaxes or the K1-K3 bodies). The count is of the
work the unit asks for, whatever implements it: a training step is its
forward and backward, with no recompute counted; a generation request is
its prior rollout; an evaluation batch is the rollouts of the samples it
keeps and the metrics of those samples (``metrics_flops``: VGG16 on each
predicted frame and once on each target frame, the SSIM filter).

Bytes: a frozen copy of the formulas of the port's ``kernels/roofline.py``:
each input read once, each output written once, each tensor in the dtype
the kernel runs in (``k2_itemsize``): K2's rows in bf16 where the
configuration computes or gates in bf16, its LayerNorm parameters and all
of K1 and K3 in fp32 (they take fp32 images, kernels and logits under bf16
compute too); the bound is the bytes over the H100 SXM's 3.35e12 B/s (every
one of these kernels lies far below the card's operations-per-byte line).
"""

from __future__ import annotations

from typing import Dict, Iterable

HBM_BYTES_PER_S = 3.35e12
VGG16 = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]


def conv(out_positions: int, c_in: int, c_out: int, taps: int) -> int:
    return 2 * out_positions * c_in * c_out * taps


def dense(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def vgg_flops(frames: int, h: int, w: int) -> int:
    total, c_in, hh, ww = 0, 3, h, w
    for _, n, ch in VGG16:
        for _ in range(n):
            total += conv(hh * ww, c_in, ch, 9)
            c_in = ch
        hh, ww = hh // 2, ww // 2
    return frames * total


def ssim_flops(frames: int, h: int, w: int, c: int, size: int = 11) -> int:
    return frames * conv((h - size + 1) * (w - size + 1), 1, 5 * c, size * size)


def metrics_flops(clips: int, samples: int, frames: int, h: int, w: int, c: int, metrics: Iterable[str]) -> int:
    """The metrics of ``samples`` predictions of ``frames`` frames for each
    of ``clips`` clips: SSIM's filter on each predicted frame, VGG16 on each
    predicted frame and once on each target frame."""
    pred = clips * samples * frames
    total = 0
    if "ssim" in metrics:
        total += ssim_flops(pred, h, w, c)
    if "vgg_csim" in metrics:
        total += vgg_flops(pred + clips * frames, h, w)
    return total


# ---------------------------------------------------- K1-K3 bytes (frozen) --
def cdna_forward(b, h, w, c, k=5, n=4, itemsize=4) -> int:
    return b * h * w * c * itemsize + b * k * k * n * 4 + b * n * h * w * c * itemsize


def cdna_backward(b, h, w, c, k=5, n=4, itemsize=4) -> int:
    image, kern, grad = b * h * w * c * itemsize, b * k * k * n * 4, b * n * h * w * c * itemsize
    return 2 * image + 2 * kern + grad


def ln_gate_forward(rows_and_widths, itemsize=4) -> int:
    return sum(7 * r * c * itemsize + 10 * c * 4 for r, c in rows_and_widths)


def ln_gate_backward(rows_and_widths, itemsize=4) -> int:
    return sum(12 * r * c * itemsize + 2 * 10 * c * 4 for r, c in rows_and_widths)


def composite_forward(b, k, h, w, c, itemsize=4) -> int:
    p = b * h * w
    return p * k * c * itemsize + p * k * itemsize + p * c * itemsize


def composite_backward(b, k, h, w, c, itemsize=4) -> int:
    p = b * h * w
    return 2 * (p * k * c * itemsize + p * k * itemsize) + p * c * itemsize


def k2_itemsize(hp: Dict) -> int:
    """Bytes of an element of K2's rows (z, c and their outputs): bf16 gates
    take bf16; fp32 gates take the dtype that holds the gate conv's output
    and the cell state, bf16 under bf16 compute."""
    return 2 if "bfloat16" in (hp["gate_dtype"], hp["compute_dtype"]) else 4


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
