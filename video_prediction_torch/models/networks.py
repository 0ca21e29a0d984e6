"""Latent encoders.

Port of ``video_prediction_tpu/models/networks.py#PosteriorEncoder``
(reference ``savp_model.py#create_encoder``). ``LearnedPrior`` and the SN-GAN
discriminators are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from video_prediction_torch.ops.layers import Conv2D, InstanceNorm, lrelu


class PosteriorEncoder(nn.Module):
    """Frame-pair latent posterior q(z_t | x_t, x_{t+1}).

    ``images [B,T,H,W,C] -> (mu, logvar)``, each ``[B,T-1,nz]`` fp32. All T-1
    adjacent pairs run as one folded batch: 4x4 stride-2 SAME convs (64 and
    32 px inputs pad (1, 1)), instance norm (eps 1e-6) after every conv but
    the first, leaky ReLU 0.2, global average pool, dense mu / logvar heads.
    """

    n_layers = 3

    def __init__(self, in_channels: int, nz: int = 8, nef: int = 64):
        super().__init__()
        self.nz = nz
        # submodule names follow the flax tree (conv0.., norm1..) for convert.py
        f_in = 2 * in_channels
        for i in range(self.n_layers):
            f = nef * min(2**i, 4)
            self.add_module(f"conv{i}", Conv2D(f_in, f, 4, strides=2))
            if i > 0:
                self.add_module(f"norm{i}", InstanceNorm(f))
            f_in = f
        self.mu = nn.Linear(f_in, nz)
        self.logvar = nn.Linear(f_in, nz)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, h, w, c = images.shape
        pairs = torch.cat([images[:, :-1], images[:, 1:]], dim=-1)  # [B,T-1,H,W,2C]
        x = pairs.reshape(b * (t - 1), h, w, 2 * c)
        x = lrelu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers):
            x = lrelu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)), 0.2)
        x = x.mean(dim=(1, 2))
        mu = self.mu(x).reshape(b, t - 1, self.nz)
        logvar = self.logvar(x).reshape(b, t - 1, self.nz)
        return mu, logvar
