"""Spectral normalization (SN-GAN, Miyato et al. 2018).

Port of ``video_prediction_tpu/ops/spectral.py`` (``spectral_normalize``,
``SpectralConv2D``, ``SpectralConv3D``, ``SpectralDense``). Written here rather than taken from
``torch.nn.utils.spectral_norm``, which runs its power iteration under
``no_grad``: as in the JAX package the gradient flows through the power
iteration and only the stored ``u`` is cut.

The persistent left-singular estimate ``u`` is a module buffer. A forward
never writes it: it returns the advanced ``u`` beside its output, and the
train step stores it after the optimizer update, as the JAX package threads
its ``"spectral"`` collection through the step. The discriminator's
generator-side call reads the same old ``u`` and drops the advanced one.

The power iteration runs in fp32 on the fp32 weight; the normalized weight
is cast to the layer's ``dtype`` (that of the input when None) at the conv
or the product, with the input, and the bias to the output's dtype
(``video_prediction_tpu/ops/spectral.py:30-52, 80-130``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_prediction_torch.ops.layers import add_bias, cast, conv2d_nhwc, conv3d_nthwc, split_bias
from video_prediction_torch.ops.layers import _same_pads as same_pads  # noqa: F401 (TF SAME padding, kernels/bench.py)

SN_EPS = 1e-12


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(v.square().sum() + SN_EPS)


def spectral_normalize(w_mat: torch.Tensor, u: torch.Tensor, n_iters: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power iteration(s) on ``w_mat [prod(leading), out]`` from ``u [out]``.

    Returns ``(w_mat / sigma, new_u, sigma)``; ``new_u`` is detached. The
    rows of the matrix may come in any order: sigma and ``new_u`` do not
    depend on it.
    """
    w32 = w_mat.float()
    u32 = u.detach().float()
    for _ in range(n_iters):
        v = l2_normalize(w32 @ u32)
        u32 = l2_normalize(w32.t() @ v)
    sigma = torch.einsum("i,ij,j->", v, w32, u32)
    return w_mat / sigma.to(w_mat.dtype), u32.detach().to(u.dtype), sigma


class SpectralLayer(nn.Module):
    """A weight ``[out, ...]`` (PyTorch layout), a bias and the buffer ``u [out]``."""

    def __init__(self, weight_shape: Sequence[int], use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(tuple(weight_shape)))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0])) if use_bias else None
        self.register_buffer("u", l2_normalize(torch.randn(weight_shape[0])))

    def normalized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(weight / sigma, advanced u)``; the matrix is ``weight`` with its
        output axis last (rows in PyTorch's order of the other axes)."""
        _, u_new, sigma = spectral_normalize(self.weight.reshape(self.weight.shape[0], -1).t(), self.u)
        return self.weight / sigma, u_new

    def operands(self, x: torch.Tensor, w: torch.Tensor):
        """``x`` and the normalized ``w`` in the layer's compute dtype, and the
        bias split by ``layers.split_bias``: ``(x, w, fused, after)``."""
        dt = self.dtype or x.dtype
        return (cast(x, dt), cast(w, dt), *split_bias(self.bias, dt))


class SpectralDense(SpectralLayer):
    """Dense layer with a spectrally normalized ``[out, in]`` weight."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__((features, in_features), use_bias, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w, u_new = self.normalized_weight()
        x, w, fused, after = self.operands(x, w)
        return add_bias(F.linear(x, w, fused), after), u_new


class SpectralConv2D(SpectralLayer):
    """2-D convolution over NHWC with a spectrally normalized ``[O, I, k, k]``
    weight, TF ``SAME`` padding and a square ``strides`` (reference
    ``conv2d(..., use_spectral_norm=True)``; the image discriminator's). The
    power iteration's matrix is the weight with its output axis last, as in
    ``SpectralConv3D``: its rows come in another order than the JAX
    package's ``[-1, out]`` reshape of the HWIO kernel, which moves neither
    sigma nor the advanced ``u``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, strides: int = 1,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__((features, in_features, kernel_size, kernel_size), use_bias, dtype)
        self.strides = strides

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w, u_new = self.normalized_weight()
        x, w, fused, after = self.operands(x, w)
        return add_bias(conv2d_nhwc(x, w, fused, self.strides), after), u_new


class SpectralConv3D(SpectralLayer):
    """3-D convolution over ``NTHWC`` clips with a spectrally normalized
    ``[O, I, T, H, W]`` weight, TF ``SAME`` padding (``layers.conv3d_nthwc``),
    output ``NTHWC``. The JAX package's ``use_taps`` (``disc_conv3d_taps``)
    computes the same convolution as time-shifted 2-D convolutions, a choice
    of XLA lowering that does not change the result: the port accepts the
    hparam and runs the direct convolution."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int] = (3, 3, 3),
                 strides: Sequence[int] = (1, 1, 1), use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__((features, in_features, *kernel_size), use_bias, dtype)
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w, u_new = self.normalized_weight()
        x, w, fused, after = self.operands(x, w)
        return add_bias(conv3d_nthwc(x, w, fused, self.strides), after), u_new
