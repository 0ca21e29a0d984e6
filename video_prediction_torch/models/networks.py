"""Latent encoder and video discriminator.

Port of ``video_prediction_tpu/models/networks.py#PosteriorEncoder``
(reference ``savp_model.py#create_encoder``; per step, or time-invariant
for SV2P) and ``#VideoSNDiscriminator``
(reference ``networks.py#video_sn_discriminator``). ``LearnedPrior`` and the
image and action-conditioned discriminators are still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from video_prediction_torch.ops.layers import Conv2D, Dense, Dtype, InstanceNorm, lrelu
from video_prediction_torch.ops.spectral import SpectralConv3D, SpectralDense


class PosteriorEncoder(nn.Module):
    """Frame-pair latent posterior q(z_t | x_t, x_{t+1}), or with
    ``time_invariant`` one latent per sequence (SV2P).

    ``images [B,T,H,W,C] -> (mu, logvar)``, each ``[B,T-1,nz]`` fp32 (``[B,1,nz]``
    when ``time_invariant``). All T-1 adjacent pairs run as one folded batch:
    4x4 stride-2 SAME convs (64 and 32 px inputs pad (1, 1)), instance norm
    (eps 1e-6) after every conv but the first, leaky ReLU 0.2, global average
    pool, dense mu / logvar heads. ``time_invariant`` averages the pooled pair
    features over time before the heads, so both forms have the same
    parameters. With ``dtype`` bf16 the convs run in bf16; the norms and the
    heads have no dtype, as in the JAX package, so they promote to fp32.
    """

    n_layers = 3

    def __init__(self, in_channels: int, nz: int = 8, nef: int = 64, time_invariant: bool = False,
                 dtype: Dtype = None):
        super().__init__()
        self.nz = nz
        self.time_invariant = time_invariant
        # submodule names follow the flax tree (conv0.., norm1..) for convert.py
        f_in = 2 * in_channels
        for i in range(self.n_layers):
            f = nef * min(2**i, 4)
            self.add_module(f"conv{i}", Conv2D(f_in, f, 4, strides=2, dtype=dtype))
            if i > 0:
                self.add_module(f"norm{i}", InstanceNorm(f))
            f_in = f
        self.mu = Dense(f_in, nz)
        self.logvar = Dense(f_in, nz)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, h, w, c = images.shape
        pairs = torch.cat([images[:, :-1], images[:, 1:]], dim=-1)  # [B,T-1,H,W,2C]
        x = pairs.reshape(b * (t - 1), h, w, 2 * c)
        x = lrelu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers):
            x = lrelu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)), 0.2)
        x = x.mean(dim=(1, 2))
        tz = t - 1
        if self.time_invariant:
            x = x.reshape(b, t - 1, -1).mean(dim=1)  # whole-clip features
            tz = 1
        mu = self.mu(x).reshape(b, tz, self.nz)
        logvar = self.logvar(x).reshape(b, tz, self.nz)
        return mu, logvar


class VideoSNDiscriminator(nn.Module):
    """Clip-level SN-GAN discriminator with 3-D convs.

    ``clips [B,T,H,W,C] -> (logits [B,1], features, new_u)``: six
    spectrally normalized conv3ds, each followed by leaky ReLU 0.1 and kept
    as a feature map (``NTHWC``) for the feature-matching loss, then a
    spectrally normalized dense layer on the ``NTHWC``-flattened last map.
    ``new_u`` maps each layer's name to its advanced power-iteration vector
    (the caller stores it or drops it). ``clip_shape`` (T, H, W) fixes the
    dense layer's input width, as the first clip does for flax's lazy init.
    Every layer computes in ``dtype`` (that of the clips when None).
    """

    # (features as a multiple of ndf, kernel (T, H, W), strides), as in the JAX package
    SPEC = [
        (1, (1, 3, 3), (1, 1, 1)),
        (1, (3, 4, 4), (1, 2, 2)),
        (2, (3, 3, 3), (1, 1, 1)),
        (2, (3, 4, 4), (2, 2, 2)),
        (4, (3, 3, 3), (1, 1, 1)),
        (4, (3, 4, 4), (2, 2, 2)),
    ]

    def __init__(self, in_channels: int, clip_shape: Tuple[int, int, int], ndf: int = 64, dtype: Dtype = None):
        super().__init__()
        f_in, shape = in_channels, list(clip_shape)
        for i, (mult, k, s) in enumerate(self.SPEC):
            self.add_module(f"sn_conv3d{i}", SpectralConv3D(f_in, ndf * mult, k, s, dtype=dtype))
            f_in = ndf * mult
            shape = [-(-n // st) for n, st in zip(shape, s)]  # SAME: ceil(n / stride)
        self.sn_fc = SpectralDense(f_in * shape[0] * shape[1] * shape[2], 1, dtype=dtype)

    def forward(self, clips: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, torch.Tensor]]:
        x, feats, new_u = clips, [], {}
        for i in range(len(self.SPEC)):
            name = f"sn_conv3d{i}"
            x, new_u[name] = getattr(self, name)(x)
            x = lrelu(x, 0.1)
            feats.append(x)
        logits, new_u["sn_fc"] = self.sn_fc(x.reshape(x.shape[0], -1))
        return logits, feats, new_u
