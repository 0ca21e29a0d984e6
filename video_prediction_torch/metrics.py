"""Per-frame evaluation metrics: MSE, PSNR, SSIM (as ``tf.image.ssim``), cosine similarity.

Port of ``video_prediction_tpu/metrics.py`` (reference ``video_prediction/
metrics.py``). SSIM follows ``tf.image.ssim``: an 11x11 Gaussian window
(sigma 1.5), k1=0.01, k2=0.03, VALID padding, the mean over the map and the
channels. Every function takes ``[..., H, W, C]`` and reduces over the
trailing image dims only, keeping the leading (batch, time) dims for the
per-frame curves of ``evaluate``. They run on the device of their inputs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def mean_squared_error(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over (H, W, C)."""
    return (true.float() - pred.float()).square().mean(dim=(-3, -2, -1))


def peak_signal_to_noise_ratio(true: torch.Tensor, pred: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB; ``inf`` where the images are equal."""
    mse = mean_squared_error(true, pred)
    return 10.0 * (torch.log(max_val**2 / mse) / math.log(10.0))


def _fspecial_gauss(size: int, sigma: float, device=None) -> torch.Tensor:
    """2-D Gaussian the way ``tf.image.ssim`` builds it (outer product of 1-D)."""
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1.0) / 2.0
    g = torch.exp(-coords.square() / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


@contextlib.contextmanager
def fp32_convs():
    """Convolutions in true fp32 inside the block: cuDNN's TF32 off, and the
    process's setting restored after (the JAX package asks XLA for
    ``Precision.HIGHEST`` on the SSIM filter for the same reason)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def structural_similarity(
    true: torch.Tensor,
    pred: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-image SSIM as ``tf.image.ssim`` computes it: ``[..., H, W, C]`` in,
    ``[...]`` out. The five Gaussian filterings (x, y, x², y², xy) run as one
    depthwise convolution over their stacked channels, in true fp32."""
    x, y = true.float(), pred.float()
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = y.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=1)  # [N, 5C, H, W]
    kern = _fspecial_gauss(filter_size, filter_sigma, x.device)
    weight = kern.expand(5 * c, 1, filter_size, filter_size).contiguous()
    with fp32_convs():
        filt = F.conv2d(stacked, weight, groups=5 * c)  # VALID
    mu_x, mu_y, e_xx, e_yy, e_xy = filt.split(c, dim=1)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx, sigma_yy, sigma_xy = e_xx - mu_xx, e_yy - mu_yy, e_xy - mu_xy
    lum = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return (lum * cs).mean(dim=(1, 2, 3)).reshape(lead)


def unit_normalize(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """``x`` scaled by ``rsqrt(sum of squares along dim + eps)``."""
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + eps)


COSINE_EPS = 1e-12


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, dim: int = -1, eps: float = COSINE_EPS) -> torch.Tensor:
    """Cosine similarity along ``dim`` (the VGG feature similarity): each side
    scaled by ``rsqrt(sum of squares + eps)``."""
    return (unit_normalize(x.float(), dim, eps) * unit_normalize(y.float(), dim, eps)).sum(dim=dim)


METRIC_FNS = {
    "mse": mean_squared_error,
    "psnr": peak_signal_to_noise_ratio,
    "ssim": structural_similarity,
}
