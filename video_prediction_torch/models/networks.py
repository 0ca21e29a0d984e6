"""Latent encoders and SN-GAN discriminators.

Port of ``video_prediction_tpu/models/networks.py``: ``PosteriorEncoder``
(reference ``savp_model.py#create_encoder``; per step, or time-invariant
for SV2P), ``LearnedPrior`` (the ``learn_prior`` prior, run inside the
generator cell, ``models/savp.py``), and the three discriminators:
``ImageSNDiscriminator`` (reference ``networks.py#image_sn_discriminator``),
``VideoSNDiscriminator`` (``#video_sn_discriminator``) and
``ACVideoSNDiscriminator`` (``savp_model.py#create_acvideo_discriminator``).
Each discriminator returns ``(logits, features, new_u)``: the features feed
the feature-matching loss, ``new_u`` the advanced power-iteration vectors
(``ops/spectral.py``). With ``dtype`` bf16 every conv and the
discriminators' dense layers compute in bf16; the encoders' ``mu`` and
``logvar`` heads have no dtype, as in the JAX package, so they promote to
fp32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from video_prediction_torch.ops.layers import Conv2D, Dense, Dtype, InstanceNorm, cast, lrelu
from video_prediction_torch.ops.spectral import SpectralConv2D, SpectralConv3D, SpectralDense


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


class LearnedPrior(nn.Module):
    """Learned conditional prior p(z_t | x_t) of ``learn_prior``: one frame
    ``[B,H,W,C] -> (mu, logvar)``, each ``[B,nz]`` fp32. ``n_layers`` 4x4
    stride-2 SAME convs of ``nef * min(2^i, 4)`` features, each followed by
    leaky ReLU 0.2, a global average pool, dense ``mu`` / ``logvar`` heads.
    It runs inside the generator cell on the frame the cell consumes (ground
    truth in the context and teacher-forced steps, the model's own
    prediction otherwise), so a rollout never conditions z_t on a future
    ground-truth frame (JAX ``networks.py:184-212``)."""

    n_layers = 3

    def __init__(self, in_channels: int, nz: int = 8, nef: int = 32, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        f_in = in_channels
        for i in range(self.n_layers):
            f = nef * min(2**i, 4)
            self.add_module(f"conv{i}", Conv2D(f_in, f, 4, strides=2, dtype=dtype))
            f_in = f
        self.mu = Dense(f_in, nz)
        self.logvar = Dense(f_in, nz)

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = cast(image, self.dtype or image.dtype)
        for i in range(self.n_layers):
            x = lrelu(getattr(self, f"conv{i}")(x), 0.2)
        x = x.mean(dim=(1, 2))
        return cast(self.mu(x), torch.float32), cast(self.logvar(x), torch.float32)


def _same_out(shape: Sequence[int], strides: Sequence[int]) -> List[int]:
    """The spatial shape after a SAME layer: ceil(n / stride) along each axis."""
    return [-(-n // st) for n, st in zip(shape, strides)]


class ImageSNDiscriminator(nn.Module):
    """Per-frame SN-GAN discriminator (reference
    ``networks.py#image_sn_discriminator``): ``clips [B,T,H,W,C] -> (logits
    [B*T,1], features, new_u)`` with time folded into the batch: six
    spectrally normalized 2-D convs (3x3 stride 1 and 4x4 stride 2 in turn,
    ``ndf``, ``ndf``, ``2 ndf``, ``2 ndf``, ``4 ndf``, ``4 ndf`` features),
    each followed by leaky ReLU 0.1 and kept as a feature map, then a
    spectrally normalized dense layer on the flattened last map (``ndf*4 *
    H/8 * W/8``). ``image_hw`` (H, W) fixes that width."""

    SPEC = [(1, 3, 1), (1, 4, 2), (2, 3, 1), (2, 4, 2), (4, 3, 1), (4, 4, 2)]

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], ndf: int = 64, dtype: Dtype = None):
        super().__init__()
        f_in, shape = in_channels, list(image_hw)
        for i, (mult, k, s) in enumerate(self.SPEC):
            self.add_module(f"sn_conv{i}", SpectralConv2D(f_in, ndf * mult, k, s, dtype=dtype))
            f_in = ndf * mult
            shape = _same_out(shape, (s, s))
        self.sn_fc = SpectralDense(f_in * shape[0] * shape[1], 1, dtype=dtype)

    def forward(self, clips: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, torch.Tensor]]:
        b, t, h, w, c = clips.shape
        x, feats, new_u = clips.reshape(b * t, h, w, c), [], {}
        for i in range(len(self.SPEC)):
            name = f"sn_conv{i}"
            x, new_u[name] = getattr(self, name)(x)
            x = lrelu(x, 0.1)
            feats.append(x)
        logits, new_u["sn_fc"] = self.sn_fc(x.reshape(b * t, -1))
        return logits, feats, new_u


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
            shape = _same_out(shape, s)
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


class ACVideoSNDiscriminator(VideoSNDiscriminator):
    """Action-conditioned clip discriminator (reference
    ``savp_model.py#create_acvideo_discriminator``): ``(clips [B,T,H,W,C],
    actions [B,T,na]) -> (logits [B,1], features, new_u)``. Consecutive
    frames are concatenated on channels (``clips[:, :-1]``, ``clips[:, 1:]``)
    and the action between them (``actions[:, 1:]``) is tiled over H and W
    onto each pair, so the ``VideoSNDiscriminator`` trunk sees a clip of
    ``T - 1`` transitions of ``2C + na`` channels; ``clip_shape`` (T, H, W)
    is that of the frames."""

    def __init__(self, in_channels: int, action_dim: int, clip_shape: Tuple[int, int, int], ndf: int = 64,
                 dtype: Dtype = None):
        t, h, w = clip_shape
        super().__init__(2 * in_channels + action_dim, (t - 1, h, w), ndf, dtype)

    def forward(self, clips: torch.Tensor, actions: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, torch.Tensor]]:
        b, t, h, w, _ = clips.shape
        tiled = cast(actions[:, 1:, None, None, :], clips.dtype).expand(b, t - 1, h, w, actions.shape[-1])
        return super().forward(torch.cat([clips[:, :-1], clips[:, 1:], tiled], dim=-1))
