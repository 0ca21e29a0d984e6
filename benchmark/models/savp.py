"""SAVP (Lee et al. 2018, arXiv:1804.01523; the published ``ours_savp``
configurations) in the benchmark: its plain reference
(``benchmark/reference/savp.py``) as the kinds call it, and the work of its
units, counted from the configuration's hparams and shapes (how FLOPs and
bytes are counted: ``benchmark/counts.py``).

FLOPs: the generator's convs (stem, a conv before each pool and after each
upsample, each ConvLSTM's input and hidden gate convs), its CDNA dense head,
scratch and mask heads; the posterior's convs and dense heads; the video
discriminator's 3-D convs and dense layer. A training step is three times
its forward (the doubled rollout of the prior and the posterior, the
posterior encoder, both discriminators on their update path of real and fake
clips and their generator path of fake clips), with no recompute counted; a
rollout is its generator steps.

Bytes: one generator step launches one K1 (CDNA), one K2 a ConvLSTM and one
K3 (the composite) at the step's batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import counts
from benchmark.counts import conv, dense
from benchmark.reference import savp as reference

VIDEO_DISC = [
    (1, (1, 3, 3), (1, 1, 1)),
    (1, (3, 4, 4), (1, 2, 2)),
    (2, (3, 3, 3), (1, 1, 1)),
    (2, (3, 4, 4), (2, 2, 2)),
    (4, (3, 3, 3), (1, 1, 1)),
    (4, (3, 4, 4), (2, 2, 2)),
]
LSTM_KERNEL = 5


# ------------------------------------------------------------- reference --
def train_steps(weights: Dict[str, torch.Tensor], hp: Dict, batches: List[Dict[str, torch.Tensor]],
                noises: List[Dict]) -> Dict:
    """The reference's steps (``reference.train_steps``): the weights split
    into parameters and spectral ``u`` vectors; each step's images."""
    params = {k: v for k, v in weights.items() if not k.endswith(".u")}
    us = {k: v for k, v in weights.items() if k.endswith(".u")}
    return reference.train_steps(params, us, hp, [b["images"] for b in batches], noises)


def eval_rollout(weights: Dict[str, torch.Tensor], hp: Dict, batch: Dict[str, torch.Tensor],
                 zs: torch.Tensor) -> torch.Tensor:
    return reference.eval_rollout(weights, hp, batch["images"], zs)


# ----------------------------------------------------------------- FLOPs --
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


def rollout_flops(hp: Dict, samples: int, t: int, h: int, w: int, c: int) -> int:
    return samples * (t - 1) * generator_step_flops(hp, h, w, c)


# ------------------------------------------------------------ K1-K3 bytes --
def kernel_bytes(hp: Dict, batch: int, h: int, w: int, c: int, backward: bool) -> Dict[str, int]:
    """Bytes of one generator step's K1, K2 and K3 launches at ``batch``
    samples, forward (or backward)."""
    kh = hp["kernel_size"][0]
    n, k = hp["num_transformed_images"], n_candidates(hp)
    rows = [(batch * r, f) for r, f, _ in lstm_widths(hp, h, w)]
    k2 = counts.k2_itemsize(hp)
    if backward:
        return {"K1": counts.cdna_backward(batch, h, w, c, kh, n), "K2": counts.ln_gate_backward(rows, k2),
                "K3": counts.composite_backward(batch, k, h, w, c)}
    return {"K1": counts.cdna_forward(batch, h, w, c, kh, n), "K2": counts.ln_gate_forward(rows, k2),
            "K3": counts.composite_forward(batch, k, h, w, c)}


def kernel_events(hp: Dict, h: int, w: int, backward: bool) -> Dict[str, int]:
    """Device events of one generator step's launches: one K1, one per
    ConvLSTM K2 and one K3; the K1 and K2 backward each add a reduce kernel."""
    cells = len(lstm_widths(hp, h, w))
    return {"K1": 2 if backward else 1, "K2": (2 if backward else 1) * cells, "K3": 1}
