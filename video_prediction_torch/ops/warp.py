"""Dense-flow and affine bilinear image warping.

Port of ``video_prediction_tpu/ops/warp.py`` (reference
``video_prediction/flow_ops.py#image_warp``, after
``tf.contrib.image.dense_image_warp``): ``output[b, y, x] = image[b, y -
flow[b,y,x,0], x - flow[b,y,x,1]]`` with bilinear interpolation, the sample
coordinates clamped to the image. Four gathers on the flattened spatial axis
and a weighted sum, as the JAX package computes it; not ``F.grid_sample``,
which normalizes, aligns and pads its coordinates its own way. No Pallas
kernel covers these ops in the JAX package (XLA fuses them), so they stay
torch ops.

Under spatial partitioning (``parallel/mesh.py#spatial_context``) a sample
may come from any row, so both warps sample a gathered, whole-height source
image (``parallel/spatial.py#gather_rows``) at this rank's output rows only,
their grid offset to the global rows.
"""

from __future__ import annotations

import torch

from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial


def flow_to_warp_grid(flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """A flow field ``[B,H,W,2]`` (dy, dx) -> absolute sample coordinates
    ``[B,H,W,2]`` (y, x): the pixel grid (its rows from ``row0``) minus the flow."""
    b, h, w, _ = flow.shape
    gy = torch.arange(row0, row0 + h, dtype=torch.float32, device=flow.device)[None, :, None].expand(b, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :].expand(b, h, w)
    return torch.stack([gy - flow[..., 0], gx - flow[..., 1]], dim=-1)


def bilinear_sample(image: torch.Tensor, qy: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """Sample ``image [B,H,W,C]`` at pixel coordinates ``qy``/``qx`` ``[B,
    ...]``, clamped to ``[0, H-1]`` and ``[0, W-1]``, bilinearly; returns
    ``[B, ..., C]``. The weights are cast to the image dtype before the blend."""
    b, h, w, c = image.shape
    out_shape = qy.shape[1:]
    qy = qy.float().clamp(0.0, h - 1.0).reshape(b, -1)
    qx = qx.float().clamp(0.0, w - 1.0).reshape(b, -1)
    y0, x0 = torch.floor(qy), torch.floor(qx)
    y1, x1 = (y0 + 1.0).clamp(max=h - 1.0), (x0 + 1.0).clamp(max=w - 1.0)
    wy, wx = qy - y0, qx - x0
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    flat = image.reshape(b, h * w, c)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1, c))  # [B, M, C]

    v00, v01, v10, v11 = gather(y0i, x0i), gather(y0i, x1i), gather(y1i, x0i), gather(y1i, x1i)
    wy, wx = wy[..., None].to(image.dtype), wx[..., None].to(image.dtype)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape((b,) + tuple(out_shape) + (c,))


def image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear-warp ``image [B,H,W,C]`` by ``flow [B,H,W,2]`` (dy, dx)."""
    coords = flow_to_warp_grid(flow.float(), SP.row_offset(image.shape[1], current_spatial()))
    return bilinear_sample(SP.gathered(image), coords[..., 0], coords[..., 1])


def apply_affine_kernels(image: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """STP: warp ``image [B,H,W,C]`` by N per-sample affine transforms
    ``params [B,N,6]``, the rows of a 2x3 matrix in the spatial-transformer
    convention (normalized [-1, 1] coordinates, output grid -> source) given
    as deltas from the identity, so that a zero head starts at the identity
    warp. Returns ``[B,N,H,W,C]``."""
    mesh = current_spatial()
    rows = image.shape[1]
    image = SP.gathered(image)
    b, h, w, c = image.shape
    n = params.shape[1]
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=image.device)
    theta = (params.float() + identity).reshape(b, n, 2, 3)
    ys = torch.linspace(-1.0, 1.0, h, device=image.device).narrow(0, SP.row_offset(rows, mesh), rows)
    xs = torch.linspace(-1.0, 1.0, w, device=image.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W] each
    grid = torch.stack([gx, gy, torch.ones_like(gx)])  # [3, H, W]: rows (x, y, 1)
    src = torch.einsum("bnij,jhw->bnihw", theta, grid)  # [B, N, 2 (x, y), H, W]
    qx = (src[:, :, 0] + 1.0) * (w - 1.0) / 2.0
    qy = (src[:, :, 1] + 1.0) * (h - 1.0) / 2.0
    return bilinear_sample(image, qy, qx)
