"""Loss zoo.

Port of ``video_prediction_tpu/losses.py`` (reference
``video_prediction/losses.py``): ``l1_loss``, ``l2_loss``,
``charbonnier_loss``, ``gan_loss`` (sigmoid-CE "GAN", least-squares "LSGAN",
hinge), ``sigmoid_kl_with_logits``, ``kl_loss`` between two diagonal
Gaussians and ``feature_matching_loss``. Each returns an fp32 scalar (the
reductions stay fp32 whatever the network's dtype).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import SpatialMesh


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return (pred.float() - target.float()).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return (pred.float() - target.float()).square().mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    """Generalized Charbonnier (robust L1)."""
    return torch.sqrt((pred.float() - target.float()).square() + epsilon**2).mean()


def _sigmoid_ce(logits: torch.Tensor, labels: float) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy with logits, elementwise."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def gan_loss(logits: torch.Tensor, labels: float, gan_loss_type: str = "LSGAN") -> torch.Tensor:
    """GAN objective on discriminator logits; ``labels`` 1.0 for "real", 0.0
    for "fake" (soft labels take ``sigmoid_kl_with_logits`` for "GAN")."""
    logits = logits.float()
    if gan_loss_type == "GAN":
        if labels not in (0.0, 1.0):
            return sigmoid_kl_with_logits(logits, float(labels)).mean()
        return _sigmoid_ce(logits, labels).mean()
    if gan_loss_type == "LSGAN":
        return (logits - labels).square().mean()
    if gan_loss_type == "hinge":
        if labels == 1.0:
            return F.relu(1.0 - logits).mean()
        if labels == 0.0:
            return F.relu(1.0 + logits).mean()
        return -logits.mean()
    raise ValueError(f"unknown gan_loss_type {gan_loss_type!r}")


def sigmoid_kl_with_logits(logits: torch.Tensor, targets: float) -> torch.Tensor:
    """Elementwise KL(targets || sigmoid(logits)) for a scalar soft label:
    sigmoid cross-entropy minus the target's own entropy."""
    if not isinstance(targets, float):
        raise TypeError(f"targets must be a python float, got {type(targets)}")
    if targets in (0.0, 1.0):
        entropy = 0.0
    else:
        entropy = -targets * math.log(targets) - (1.0 - targets) * math.log(1.0 - targets)
    return _sigmoid_ce(logits.float(), targets) - entropy


def kl_loss(mu1: torch.Tensor, logvar1: torch.Tensor, mu2: Optional[torch.Tensor] = None,
            logvar2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL( N(mu1, exp(logvar1)) || N(mu2, exp(logvar2)) ), summed over the
    latent axis and averaged over the rest; the unit Gaussian when ``mu2`` is
    omitted."""
    mu1, logvar1 = mu1.float(), logvar1.float()
    if mu2 is None:
        kl = 0.5 * (mu1.square() + logvar1.exp() - 1.0 - logvar1)
    else:
        mu2, logvar2 = mu2.float(), logvar2.float()
        kl = 0.5 * (logvar2 - logvar1 + (logvar1.exp() + (mu1 - mu2).square()) / logvar2.exp() - 1.0)
    return kl.sum(-1).mean()


def feature_matching_loss(feats_real: Sequence[torch.Tensor], feats_fake: Sequence[torch.Tensor],
                          norm: str = "l2") -> torch.Tensor:
    """Mean over layers of the mean L2 (or L1) distance between
    discriminator features; the real features are the target and carry no
    gradient."""
    if len(feats_real) != len(feats_fake):
        raise ValueError(f"{len(feats_real)} real and {len(feats_fake)} fake feature maps")
    diffs = [fr.detach().float() - ff.float() for fr, ff in zip(feats_real, feats_fake)]
    return torch.stack([d.square().mean() if norm == "l2" else d.abs().mean() for d in diffs]).mean()


def total_variation(images: torch.Tensor) -> torch.Tensor:
    """Mean total variation over ``[..., H, W, C]`` (``models/base.py``'s
    ``tv_weight`` term)."""
    dh = (images[..., 1:, :, :] - images[..., :-1, :, :]).abs()
    dw = (images[..., :, 1:, :] - images[..., :, :-1, :]).abs()
    return dh.mean() + dw.mean()


def total_variation_share(images: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """This rank's share of ``total_variation`` of the whole images, of which
    ``images [..., H/k, W, C]`` are the rows of spatial coordinate
    ``mesh.coord``: its row differences (with the row above it, from a 1-row
    halo, but at the global top) over the global H-1 rows' count, plus its
    column differences' mean over k. The spatial group's shares sum to the
    whole term."""
    ext = SP.halo(images, mesh, 1, 0, dim=-3)
    dh = (ext[..., 1:, :, :] - ext[..., :-1, :, :]).abs()
    if mesh.coord == 0:
        dh = dh[..., 1:, :, :]
    h = images.shape[-3]
    dw = (images[..., :, 1:, :] - images[..., :, :-1, :]).abs()
    return dh.sum() / (images[..., :1, :, :].numel() * (h * mesh.k - 1)) + dw.mean() / mesh.k
