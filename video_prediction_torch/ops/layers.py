"""Layer primitives with string-registry variants.

Port of ``video_prediction_tpu/ops/layers.py`` (reference
``video_prediction/ops.py``). Public tensors are NHWC, as in the JAX package.
A convolution runs on the NCHW view of an NHWC tensor (``permute``), which
PyTorch reads as ``channels_last``; its output comes back as a contiguous NHWC
tensor, so the 4C gate channels of a pixel stay adjacent for the ConvLSTM
kernel (``kernels/ln_gate.py``).

Parameter layouts are PyTorch's: conv weights OIHW (flax keeps HWIO), dense
weights ``[out, in]`` (flax ``[in, out]``); ``convert.py`` maps between them.
The model's ordinary convolutions were XLA's in the JAX package, not Pallas,
and stay ``F.conv2d`` here.

Mixed precision follows flax's ``dtype`` rule. Parameters are fp32. A layer
built with ``dtype=torch.bfloat16`` casts its input and its parameters to
bf16 and returns bf16; a layer built with ``dtype=None`` computes in the
promotion of its input's and its parameters' dtypes (a bf16 input to fp32
parameters gives fp32). The norms take their statistics and normalize in
fp32 and return their ``dtype`` (or the promotion, when None).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-6  # flax LayerNorm / GroupNorm default (torch's is 1e-5)
Dtype = Optional[torch.dtype]


def layer_dtype(dtype: Dtype, x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    """The dtype a layer built with ``dtype`` computes in on ``x``: ``dtype``,
    or the promotion of the input's and the parameters' dtypes when None."""
    return dtype or torch.promote_types(x.dtype, param.dtype)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: ``x`` itself where it already is, with no call
    (the fp32 path makes none)."""
    return x if x.dtype == dtype else x.to(dtype)


def split_bias(bias: Optional[torch.Tensor], dtype: torch.dtype):
    """``(fused, after)``: the bias the product adds itself, and the one
    ``add_bias`` adds after it. In fp32 nothing is rounded between the two,
    so the product takes it in its own call; in bf16 it is added after the
    product is rounded, as flax adds it."""
    return (bias, None) if dtype == torch.float32 else (None, bias)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA/TF ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, stride: int = 1
) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with an OIHW ``weight``; NHWC, contiguous out."""
    _, h, w, _ = x.shape
    kh, kw = weight.shape[-2:]
    (pt, pb), (pl, pr) = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, weight, bias, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), weight, bias, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """Leaky ReLU (reference default slope 0.2: ``ops.py#lrelu``)."""
    return F.leaky_relu(x, negative_slope=alpha)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling over NHWC, stride 2, VALID (reference ``ops.py#pool2d``)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def tile_concat(x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Tile a ``[B, D]`` vector over H, W and concat it to NHWC ``x``."""
    b, h, w, _ = x.shape
    tiled = cast(vec[:, None, None, :], x.dtype).expand(b, h, w, vec.shape[-1])
    return torch.cat([x, tiled], dim=-1)


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` plus ``bias`` in ``y``'s dtype: after the product is rounded to
    it, as flax adds its bias."""
    return y if bias is None else y + cast(bias, y.dtype)


class Conv2D(nn.Module):
    """2-D convolution, NHWC, SAME padding (reference ``ops.py#conv2d``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, strides: int = 1,
                 use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = layer_dtype(self.dtype, x, self.weight)
        fused, after = split_bias(self.bias, dt)
        return add_bias(conv2d_nhwc(cast(x, dt), cast(self.weight, dt), fused, self.strides), after)


class Dense(nn.Module):
    """Fully connected layer (reference ``ops.py#dense``), weight ``[out, in]``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = layer_dtype(self.dtype, x, self.weight)
        fused, after = split_bias(self.bias, dt)
        return add_bias(F.linear(cast(x, dt), cast(self.weight, dt), fused), after)


class ConvPool2D(nn.Module):
    """Conv-then-pool downsampling (reference ``ops.py#conv_pool2d``): 3x3
    SAME conv, then 2x2 average pool, VALID."""

    def __init__(self, in_features: int, features: int, dtype: Dtype = None):
        super().__init__()
        self.conv = Conv2D(in_features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2x2(self.conv(x))


class UpsampleConv2D(nn.Module):
    """Resize-then-conv upsampling (reference ``ops.py#upsample_conv2d``):
    nearest x2, then 3x3 SAME conv."""

    def __init__(self, in_features: int, features: int, dtype: Dtype = None):
        super().__init__()
        self.conv = Conv2D(in_features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x(x))


class GroupNorm(nn.Module):
    """flax ``GroupNorm`` over NHWC: ``num_groups`` groups of adjacent
    channels, statistics over H, W and the group's channels, learned scale
    and bias, eps 1e-6; statistics and normalization in fp32."""

    def __init__(self, features: int, num_groups: int, dtype: Dtype = None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{features} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        out_dtype = layer_dtype(self.dtype, x, self.scale)
        xg = cast(x, torch.float32).reshape(b, h, w, self.num_groups, c // self.num_groups)
        mu = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg - mu).square().mean(dim=(1, 2, 4), keepdim=True)
        y = ((xg - mu) * torch.rsqrt(var + NORM_EPS)).reshape(b, h, w, c) * self.scale + self.bias
        return cast(y, out_dtype)


def InstanceNorm(features: int, dtype: Dtype = None) -> GroupNorm:
    """The JAX package's "instance" norm: ``GroupNorm`` with one channel per
    group (each channel of each sample normalized over H, W), learned scale
    and bias, eps 1e-6. Not ``nn.InstanceNorm2d``, which defaults to no
    affine parameters and eps 1e-5."""
    return GroupNorm(features, features, dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: over the last (channel) axis, eps 1e-6, in fp32."""

    def __init__(self, features: int, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = layer_dtype(self.dtype, x, self.scale)
        return cast(F.layer_norm(cast(x, torch.float32), x.shape[-1:], self.scale, self.bias, eps=NORM_EPS), out_dtype)


def get_norm_layer(name: str) -> Callable[..., nn.Module]:
    """Normalization registry (reference ``ops.py#get_norm_layer``); returns a
    constructor taking the channel count and the ``dtype``."""
    if name in ("none", None, ""):
        return lambda features, dtype=None: nn.Identity()
    if name == "instance":
        return InstanceNorm
    if name == "layer":
        return LayerNorm
    if name == "group":
        return lambda features, dtype=None: GroupNorm(features, 8, dtype)
    raise ValueError(f"unknown norm layer {name!r}")


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("none", None, ""):
        return lambda x: x
    table = {
        "relu": F.relu,
        "lrelu": lrelu,
        "leaky_relu": lrelu,
        "elu": F.elu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "swish": F.silu,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def get_upsample_layer(name: str) -> Callable[..., nn.Module]:
    """Upsample registry (reference ``ops.py#get_upsample_layer``)."""
    if name == "upsample_conv2d":
        return UpsampleConv2D
    raise NotImplementedError(f"upsample layer {name!r} is not ported yet (ROADMAP.md, queue 1)")


def get_downsample_layer(name: str) -> Callable[..., nn.Module]:
    """Downsample registry (reference ``ops.py#get_downsample_layer``)."""
    if name == "conv_pool2d":
        return ConvPool2D
    raise NotImplementedError(f"downsample layer {name!r} is not ported yet (ROADMAP.md, queue 1)")
