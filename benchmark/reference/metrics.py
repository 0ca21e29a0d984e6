"""Plain PyTorch reference of the evaluation metrics and their best-of-N
reductions: PSNR, SSIM as ``tf.image.ssim`` computes it (11x11 Gaussian
window, sigma 1.5, k1 0.01, k2 0.03, VALID), and the VGG16 cosine
similarity (the five ReLU taps relu1_2 ... relu5_3 of the ImageNet-normalized
frame, the channel cosine at each position averaged over the positions,
then over the taps). Each takes ``[..., H, W, C]`` in [0, 1] and returns
``[...]``. Frozen with the benchmark; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

# (block, convs, channels) of VGG16's conv trunk
VGG16 = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def vgg_names() -> List[str]:
    return [f"conv{b}_{i}" for b, n, _ in VGG16 for i in range(1, n + 1)]


def psnr(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    mse = (true.float() - pred.float()).square().mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(1.0 / mse)


def ssim(true: torch.Tensor, pred: torch.Tensor, size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    lead, (h, w, c) = true.shape[:-3], true.shape[-3:]
    x = true.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = pred.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    coords = torch.arange(size, dtype=torch.float32, device=x.device) - (size - 1) / 2.0
    g = torch.exp(-coords.square() / (2.0 * sigma**2))
    g = g / g.sum()
    window = torch.outer(g, g).expand(c, 1, size, size)

    def filt(v):
        return F.conv2d(v, window, groups=c)

    mu_x, mu_y = filt(x), filt(y)
    sxx, syy, sxy = filt(x * x) - mu_x * mu_x, filt(y * y) - mu_y * mu_y, filt(x * y) - mu_x * mu_y
    c1, c2 = k1**2, k2**2
    lum = (2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    return (lum * cs).mean(dim=(1, 2, 3)).reshape(lead)


def vgg_taps(W: Dict[str, torch.Tensor], frames: torch.Tensor) -> List[torch.Tensor]:
    """``frames [N,H,W,3]`` -> the five ReLU taps, NCHW. ``W``: ``<conv>.weight``
    (OIHW) and ``<conv>.bias`` for each conv of ``vgg_names``."""
    mean = torch.tensor(MEAN, device=frames.device).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=frames.device).reshape(1, 3, 1, 1)
    x = (frames.float().permute(0, 3, 1, 2) - mean) / std
    taps = []
    for block, n, _ in VGG16:
        for i in range(1, n + 1):
            x = F.relu(F.conv2d(x, W[f"conv{block}_{i}.weight"], W[f"conv{block}_{i}.bias"], padding=1))
        taps.append(x)
        x = F.max_pool2d(x, 2)
    return taps


def vgg_cosine(W: Dict[str, torch.Tensor], a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    lead, (h, w, c) = a.shape[:-3], a.shape[-3:]
    ta, tb = vgg_taps(W, a.reshape(-1, h, w, c)), vgg_taps(W, b.reshape(-1, h, w, c))
    sims = []
    for x, y in zip(ta, tb):
        x, y = x.float(), y.float()
        xn = x * torch.rsqrt(x.square().sum(1, keepdim=True) + eps)
        yn = y * torch.rsqrt(y.square().sum(1, keepdim=True) + eps)
        sims.append((xn * yn).sum(1).mean(dim=(-2, -1)))
    return torch.stack(sims).mean(0).reshape(lead)


def chunk_metrics(W: Dict[str, torch.Tensor], target: torch.Tensor, pred: torch.Tensor, names) -> Dict[str, torch.Tensor]:
    """``target [B,Tp,H,W,C]``, ``pred [B,S,Tp,H,W,C]`` -> each metric of
    ``names`` ``[B,S,Tp]``."""
    t = target[:, None].expand_as(pred)
    fns = {"psnr": psnr, "ssim": ssim, "vgg_csim": lambda a, b: vgg_cosine(W, a, b)}
    return {m: fns[m](t, pred) for m in names}


def best_and_mean(chunks: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Best of N (max) and mean over the samples of every chunk, each
    ``[B,Tp]``, as ``<metric>_max`` and ``<metric>_avg``."""
    out = {}
    for m in chunks[0]:
        allv = torch.cat([c[m] for c in chunks], dim=1)
        out[m + "_max"], out[m + "_avg"] = allv.max(dim=1).values, allv.mean(dim=1)
    return out

