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
from typing import List, Optional

import numpy as np
import torch

from video_prediction_torch.metrics import unit_normalize
from video_prediction_torch.models.vgg import build_features, prepare_taps

_TAP_CHANNELS = [64, 128, 256, 512, 512]
_EPS = 1e-10


class LPIPSMetric:
    """``__call__(a, b)`` on ``[..., H, W, C]`` gives the LPIPS distance
    ``[...]`` (lower is closer). Runs on ``device``; inputs must lie there.

    Split as ``VGGMetric`` is, for one target against many samples:
    ``prepare(target)`` keeps the target's unit-normalised taps,
    ``score(prepared, pred [B, k, ...])`` featurises the predictions only
    and gives ``[B, k, ...]``; ``evaluate.BestOfN`` prepares a batch's
    target once, and ``__call__`` is the split at one target and one
    sample."""

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
        # clipped at 0 once here; [C] -> [C, 1, 1] against [..., C, h, w] taps
        self.lins = [lin.clamp(min=0.0).reshape(-1, 1, 1).to(device) for lin in lins]

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.score(self.prepare(a[None]), b[None, None])[0, 0]

    def prepare(self, target: torch.Tensor) -> List[torch.Tensor]:
        """``target [B, ..., H, W, C]`` -> its 5 unit-normalised taps, each ``[B, ..., C, h, w]``."""
        return prepare_taps(self.module, target, _EPS)

    def score(self, prepared: List[torch.Tensor], pred: torch.Tensor) -> torch.Tensor:
        """``pred [B, k, ..., H, W, C]``, ``k`` samples of the target that
        ``prepared`` holds -> the distance ``[B, k, ...]``."""
        total = 0.0
        for tt, tp, lin in zip(prepared, prepare_taps(self.module, pred, _EPS), self.lins):
            diff = (tt.unsqueeze(1) - tp).square()  # [B, k, ..., C, h, w]
            total = total + (diff * lin).sum(dim=-3).mean(dim=(-2, -1))
        return total
