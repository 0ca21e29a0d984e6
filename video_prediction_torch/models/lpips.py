"""LPIPS learned perceptual metric (Zhang et al. 2018), VGG variant.

Port of ``video_prediction_tpu/models/lpips.py``: unit-normalize the channel
activations of the 5 VGG16 relu taps of both images (eps 1e-10 inside the
rsqrt), take the squared difference, weight the channels by the learned
linear layer clipped at 0 (a 1x1 conv), average over the positions and sum
over the taps.

Weights: VGG16 conv weights (``models/vgg.py``) and the LPIPS linear weights
as an ``.npz`` with keys ``lin{0..4}/weight`` (shape ``[C_l]``). Neither ships
with the repository, so ``LPIPSMetric`` is gated as ``VGGMetric`` is: paths to
the files, or ``allow_random=True`` (values tagged ``untrained``). Without
linear weights, and with untrained features, each tap weighs its channels
by ``1/C``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from video_prediction_torch.models.vgg import build_features

_TAP_CHANNELS = [64, 128, 256, 512, 512]


def _unit_normalize(x: torch.Tensor, dim: int = 1, eps: float = 1e-10) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + eps)


class LPIPSMetric:
    """``__call__(a, b)`` on ``[..., H, W, C]`` gives the LPIPS distance
    ``[...]`` (lower is closer). Runs on ``device``; inputs must lie there."""

    def __init__(self, vgg_weights_path: Optional[str] = None, lin_weights_path: Optional[str] = None,
                 allow_random: bool = False, device: torch.device | str = "cpu"):
        self.module, self.untrained = build_features(vgg_weights_path, allow_random, device, "LPIPSMetric")
        if lin_weights_path and os.path.exists(lin_weights_path):
            data = np.load(lin_weights_path)
            lins = [torch.from_numpy(np.asarray(data[f"lin{i}/weight"], np.float32)) for i in range(5)]
        elif allow_random or self.untrained:
            lins = [torch.full((c,), 1.0 / c) for c in _TAP_CHANNELS]
            self.untrained = True
        else:
            raise FileNotFoundError("LPIPS linear weights (.npz with lin{i}/weight) not found.")
        # clipped at 0 once here; [C] -> [1, C, 1, 1] against NCHW taps
        self.lins = [lin.clamp(min=0.0).reshape(1, -1, 1, 1).to(device) for lin in lins]

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        lead = a.shape[:-3]
        h, w, c = a.shape[-3:]
        fa = self.module(a.reshape(-1, h, w, c))
        fb = self.module(b.reshape(-1, h, w, c))
        total = 0.0
        for ta, tb, lin in zip(fa, fb, self.lins):
            diff = (_unit_normalize(ta) - _unit_normalize(tb)).square()  # [N, C, h, w]
            total = total + (diff * lin).sum(dim=1).mean(dim=(-2, -1))
        return total.reshape(lead)
