"""The work of a unit, counted from the configuration's hparams and shapes:
model FLOPs for the ``mfu.*`` metrics and the bytes of the hand-written
kernels K1-K3 for ``hand_kernels_roofline.*``.

FLOPs: every conv, 3-D conv and dense layer, two per multiply-add, nothing
else (no norms, gates, softmaxes or the K1-K3 bodies). The count is of the
work the unit asks for, whatever implements it: a training step is three
times its forward (the doubled rollout of the prior and the posterior, the
posterior encoder, both discriminators on their update path of real and fake
clips and their generator path of fake clips), with no recompute counted;
a generation request is its prior rollout; an evaluation batch is the
rollouts of the samples it keeps and the metrics of those samples (VGG16 on
each predicted frame and once on each target frame, the SSIM filter).

Bytes: a frozen copy of the formulas of the port's ``kernels/roofline.py``:
each input read once, each output written once, each tensor in the dtype
the kernel runs in (``k2_itemsize``): K2's rows in bf16 where the
configuration computes or gates in bf16, its LayerNorm parameters and all
of K1 and K3 in fp32 (they take fp32 images, kernels and logits under bf16
compute too); the bound is the bytes over the H100 SXM's 3.35e12 B/s (every
one of these kernels lies far below the card's operations-per-byte line).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
VGG16 = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
VIDEO_DISC = [
    (1, (1, 3, 3), (1, 1, 1)),
    (1, (3, 4, 4), (1, 2, 2)),
    (2, (3, 3, 3), (1, 1, 1)),
    (2, (3, 4, 4), (2, 2, 2)),
    (4, (3, 3, 3), (1, 1, 1)),
    (4, (3, 4, 4), (2, 2, 2)),
]
LSTM_KERNEL = 5


def conv(out_positions: int, c_in: int, c_out: int, taps: int) -> int:
    return 2 * out_positions * c_in * c_out * taps


def dense(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def num_scales(h: int, w: int) -> int:
    return max(1, min(4, int(math.log2(min(h, w))) - 3))


def n_candidates(hp: Dict) -> int:
    return hp["num_transformed_images"] + 3  # the transformed frames, the previous, the first, the scratch image


def lstm_widths(hp: Dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    """The ConvLSTMs of one generator step: ``(rows a sample, C, input
    channels)``, encoder then decoder."""
    ngf, nz, s_n = hp["ngf"], hp["nz"], num_scales(h, w)
    cells = []
    for s in range(1, s_n + 1):
        f = ngf << s
        cells.append(((h >> s) * (w >> s), f, f + nz))
    for s in range(s_n - 1, -1, -1):
        f = ngf << s
        cells.append(((h >> s) * (w >> s), f, 2 * f + nz))
    return cells


def generator_step_flops(hp: Dict, h: int, w: int, c: int) -> int:
    """One generator step of one sample."""
    ngf, nz, s_n = hp["ngf"], hp["nz"], num_scales(h, w)
    kh, kw = hp["kernel_size"]
    p = h * w
    total = conv(p, c + nz, ngf, 9)  # stem
    for s in range(1, s_n + 1):  # conv before the pool, at the finer scale
        total += conv((h >> (s - 1)) * (w >> (s - 1)), ngf << (s - 1), ngf << s, 9)
    for s in range(s_n - 1, -1, -1):  # conv after the upsample
        total += conv((h >> s) * (w >> s), ngf << (s + 1), ngf << s, 9)
    for rows, f, f_in in lstm_widths(hp, h, w):
        total += conv(rows, f_in, 4 * f, LSTM_KERNEL**2) + conv(rows, f, 4 * f, LSTM_KERNEL**2)
    total += dense(1, ngf << s_n, kh * kw * hp["num_transformed_images"])  # CDNA head
    total += conv(p, ngf, c, 9)  # scratch image
    k = n_candidates(hp)
    total += conv(p, ngf + k * c, k, 9)  # mask head
    return total


def posterior_flops(hp: Dict, pairs: int, h: int, w: int, c: int) -> int:
    nef, total, f_in, hh, ww = hp["nef"], 0, 2 * c, h, w
    for i in range(3):
        f = nef * min(2**i, 4)
        hh, ww = -(-hh // 2), -(-ww // 2)
        total += conv(hh * ww, f_in, f, 16)
        f_in = f
    return pairs * (total + 2 * dense(1, f_in, hp["nz"]))


def video_disc_flops(hp: Dict, clips: int, t: int, h: int, w: int, c: int) -> int:
    ndf, shape, f_in, total = hp["ndf"], [t, h, w], c, 0
    for mult, k, s in VIDEO_DISC:
        shape = [-(-n // st) for n, st in zip(shape, s)]
        total += conv(math.prod(shape), f_in, ndf * mult, math.prod(k))
        f_in = ndf * mult
    return clips * (total + dense(1, f_in * math.prod(shape), 1))


def train_step_flops(hp: Dict, b: int, t: int, h: int, w: int, c: int) -> int:
    clip = min(hp["clip_length"], t - 1)
    forward = 2 * b * (t - 1) * generator_step_flops(hp, h, w, c) + posterior_flops(hp, b * (t - 1), h, w, c)
    discs = sum(1 for key in ("video_sn_gan_weight", "video_sn_vae_gan_weight") if hp[key])
    forward += discs * video_disc_flops(hp, 3 * b, clip, h, w, c)  # update path 2B clips, generator path B
    return 3 * forward


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


def rollout_flops(hp: Dict, samples: int, t: int, h: int, w: int, c: int) -> int:
    return samples * (t - 1) * generator_step_flops(hp, h, w, c)


def eval_batch_flops(hp: Dict, clips: int, samples: int, t: int, h: int, w: int, c: int, metrics: Iterable[str]) -> int:
    """The kept samples' rollouts and metrics of a batch of ``clips``."""
    tp = t - hp["context_frames"]
    pred = clips * samples * tp
    total = rollout_flops(hp, clips * samples, t, h, w, c)
    if "ssim" in metrics:
        total += ssim_flops(pred, h, w, c)
    if "vgg_csim" in metrics:
        total += vgg_flops(pred + clips * tp, h, w)
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


def kernel_bytes(hp: Dict, batch: int, h: int, w: int, c: int, backward: bool) -> Dict[str, int]:
    """Bytes of one generator step's K1, K2 and K3 launches at ``batch``
    samples, forward (or backward)."""
    kh = hp["kernel_size"][0]
    n, k = hp["num_transformed_images"], n_candidates(hp)
    rows = [(batch * r, f) for r, f, _ in lstm_widths(hp, h, w)]
    k2 = k2_itemsize(hp)
    if backward:
        return {"K1": cdna_backward(batch, h, w, c, kh, n), "K2": ln_gate_backward(rows, k2),
                "K3": composite_backward(batch, k, h, w, c)}
    return {"K1": cdna_forward(batch, h, w, c, kh, n), "K2": ln_gate_forward(rows, k2),
            "K3": composite_forward(batch, k, h, w, c)}


def kernel_events(hp: Dict, h: int, w: int, backward: bool) -> Dict[str, int]:
    """Device events of one generator step's launches: one K1, one per
    ConvLSTM K2 and one K3; the K1 and K2 backward each add a reduce kernel."""
    cells = len(lstm_widths(hp, h, w))
    return {"K1": 2 if backward else 1, "K2": (2 if backward else 1) * cells, "K3": 1}


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
