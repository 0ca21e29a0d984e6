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
and stay ``F.conv2d`` (``F.conv_transpose2d``, ``deconv2d``; ``F.conv3d``,
``Conv3D``) here. The locally connected layers, which no model uses
(``Local2D``, ``SeparableLocal2D``), keep the JAX layout of their per-pixel
kernels and run as one ``F.unfold`` and one product, accumulated in fp32.

Under spatial partitioning (a ``parallel/mesh.py#spatial_context``) each
tensor holds this rank's rows of the image height, and the layers that
read across rows take them from the neighbouring shards
(``parallel/spatial.py``): a conv pads with a halo of the **global**
height's SAME pads, the transposed conv and the bilinear resize with the
rows they read (the edge row repeated at the global borders for the
resize), and the group norm all-reduces its statistics over the global
H x W. Pooling (VALID 2x2 on even shard heights), nearest upsampling and
``LayerNorm`` read no other rows. ``Conv3D``, ``Local2D`` and
``SeparableLocal2D``, which no generator uses, raise there. Outside a
spatial context every layer computes as before, bit for bit.

Mixed precision follows flax's ``dtype`` rule. Parameters are fp32. A layer
built with ``dtype=torch.bfloat16`` casts its input and its parameters to
bf16 and returns bf16; a layer built with ``dtype=None`` computes in the
promotion of its input's and its parameters' dtypes (a bf16 input to fp32
parameters gives fp32). The norms take their statistics and normalize in
fp32 and return their ``dtype`` (or the promotion, when None).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial

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
    """SAME convolution of NHWC ``x`` with an OIHW ``weight``; NHWC, contiguous
    out. Under a spatial context the rows of the global height's SAME pads
    come from the neighbouring shards (zeros at the global borders), so
    that a stride-s conv of a shard whose rows start at a multiple of s is
    the shard of the whole conv."""
    _, h, w, _ = x.shape
    kh, kw = weight.shape[-2:]
    mesh = current_spatial()
    (pt, pb), (pl, pr) = _same_pads(SP.global_rows(h, mesh), kh, stride), _same_pads(w, kw, stride)
    if mesh is not None:
        if h % stride:
            raise ValueError(f"a stride-{stride} conv of a {h}-row shard: the shards' rows must start on multiples "
                             f"of the stride")
        x, pt, pb = SP.halo(x, mesh, pt, pb), 0, 0
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, weight, bias, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), weight, bias, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3d_nthwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                 strides: Tuple[int, int, int] = (1, 1, 1)) -> torch.Tensor:
    """SAME 3-D convolution of NTHWC ``x`` with an OITHW ``weight`` (padding
    asymmetric where the stride asks for it, so ``F.pad`` and no
    ``padding=``); NTHWC out."""
    pads = []
    for size, k, s in reversed(list(zip(x.shape[1:4], weight.shape[2:], strides))):
        pads.extend(_same_pads(size, k, s))  # F.pad wants the last axis (W) first
    xc = x.permute(0, 4, 1, 2, 3)
    if xc.dtype == torch.bfloat16:
        # cuDNN's bf16 conv3d backward takes a direct kernel for a
        # channels-last input at some shapes: sn_conv3d2 (32 -> 64, 3x3x3)
        # on 128 clips ran 295 ms forward and backward, 3.2 ms from a
        # contiguous NCDHW copy; the other five move by under 1.7 ms
        # either way with the copy (H100, kernels/bench.py#conv3d_layouts)
        xc = xc.contiguous()
    y = F.conv3d(F.pad(xc, pads), weight, bias, stride=tuple(strides))
    return y.permute(0, 2, 3, 4, 1)


def local2d_apply(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Locally connected 2-D convolution (reference ``ops.py#local2d``): each
    output pixel has its own ``kh x kw x Cin x Cout`` kernel, SAME padding.
    ``x [B,H,W,Cin]``, ``kernel [H,W,kh,kw,Cin,Cout]`` (the JAX layout),
    ``bias [Cout]``; accumulated in fp32 and returned in ``x``'s dtype, as
    ``video_prediction_tpu/ops/layers.py#local2d_apply``. One ``F.unfold``
    of the padded input and one product over the patch axis, batched over
    the pixels."""
    b, h, w, cin = x.shape
    hh, ww, kh, kw, cin2, cout = kernel.shape
    if (hh, ww, cin2) != (h, w, cin):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit input {tuple(x.shape)}")
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(cast(x, torch.float32).permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    patches = F.unfold(xp, (kh, kw))  # [B, Cin*kh*kw, H*W], (c, i, j) order
    k = cast(kernel, torch.float32).permute(0, 1, 4, 2, 3, 5).reshape(h * w, cin * kh * kw, cout)
    acc = torch.einsum("bqp,pqd->bpd", patches, k).reshape(b, h, w, cout)
    if bias is not None:
        acc = acc + cast(bias, torch.float32)
    return cast(acc, x.dtype)


def separable_local2d_apply(x: torch.Tensor, vertical: torch.Tensor, horizontal: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable locally connected 2-D convolution, depthwise (reference
    ``ops.py#separable_local2d``): each output pixel's ``kh x kw`` kernel of
    channel c is ``K[i, j] = sum_r vertical[i, r] horizontal[j, r]``.
    ``x [B,H,W,C]``, ``vertical [H,W,kh,R,C]``, ``horizontal [H,W,kw,R,C]``
    (the JAX layout), ``bias [C]``; fp32 accumulation, ``x``'s dtype out, as
    ``video_prediction_tpu/ops/layers.py#separable_local2d_apply``. The
    factorization is per output pixel, so the composed kernel is applied to
    the patches (two 1-D passes would read untied weights at shifted
    pixels)."""
    b, h, w, c = x.shape
    hh, ww, kh, r, c2 = vertical.shape
    hh2, ww2, kw, r2, c3 = horizontal.shape
    if (hh, ww, c2) != (h, w, c) or (hh2, ww2, r2, c3) != (h, w, r, c):
        raise ValueError(f"vertical {tuple(vertical.shape)} / horizontal {tuple(horizontal.shape)} "
                         f"do not fit input {tuple(x.shape)}")
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    composed = torch.einsum("hwirc,hwjrc->chwij", cast(vertical, torch.float32), cast(horizontal, torch.float32))
    xp = F.pad(cast(x, torch.float32).permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    patches = F.unfold(xp, (kh, kw)).reshape(b, c, kh * kw, h * w)
    acc = torch.einsum("bcqp,cpq->bpc", patches, composed.reshape(c, h * w, kh * kw)).reshape(b, h, w, c)
    if bias is not None:
        acc = acc + cast(bias, torch.float32)
    return cast(acc, x.dtype)


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """Leaky ReLU (reference default slope 0.2: ``ops.py#lrelu``)."""
    return F.leaky_relu(x, negative_slope=alpha)


def pool2d(x: torch.Tensor, pool_size: int = 2, mode: str = "avg") -> torch.Tensor:
    """Pooling over NHWC, window = stride, VALID (reference ``ops.py#pool2d``)."""
    pools = {"avg": F.avg_pool2d, "max": F.max_pool2d}
    if mode not in pools:
        raise ValueError(f"unknown pool mode {mode!r} (want 'avg'|'max')")
    if current_spatial() is not None and x.shape[1] % pool_size:
        raise ValueError(f"a {pool_size}x{pool_size} pool of a {x.shape[1]}-row shard would cross shards")
    return pools[mode](x.permute(0, 3, 1, 2), pool_size).permute(0, 2, 3, 1).contiguous()


def upsample2d(x: torch.Tensor, scale: int = 2, method: str = "nearest") -> torch.Tensor:
    """Spatial upsample of NHWC by an integer ``scale``: ``nearest`` by
    repetition; ``bilinear`` as ``jax.image.resize`` upsamples (half-pixel
    centres, an edge pixel's outer neighbour weighted out, which for an
    integer upsample is ``align_corners=False`` clamping)."""
    b, h, w, c = x.shape
    if method == "nearest":
        return x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c).reshape(b, h * scale, w * scale, c)
    if method == "bilinear":
        mesh = current_spatial()
        if mesh is not None:  # a row of each neighbour; clamped at the global borders
            x = SP.halo(x, mesh, 1, 1, edge=True)
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(x.shape[1] * scale, w * scale), mode="bilinear",
                          align_corners=False)
        if mesh is not None:
            y = y[:, :, scale : scale * (h + 1)]
        return y.permute(0, 2, 3, 1).contiguous()
    raise ValueError(f"unknown upsample method {method!r}")


def tile_concat(x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Tile a ``[B, D]`` vector over H, W and concat it to NHWC ``x``."""
    b, h, w, _ = x.shape
    tiled = cast(vec[:, None, None, :], x.dtype).expand(b, h, w, vec.shape[-1])
    return torch.cat([x, tiled], dim=-1)


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` plus ``bias`` in ``y``'s dtype: after the product is rounded to
    it, as flax adds its bias."""
    return y if bias is None else y + cast(bias, y.dtype)


def _unsharded(layer: str) -> None:
    if current_spatial() is not None:
        raise ValueError(f"{layer} is in no generator and has no spatially sharded form: it runs only outside "
                         "spatial partitioning")


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


class Conv3D(nn.Module):
    """3-D convolution over NTHWC clips, SAME padding, weight OITHW
    (reference ``ops.py#conv3d``; the JAX package's ``Conv3D``, which no
    model uses; the video discriminators use ``spectral.SpectralConv3D``)."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1), use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.strides = tuple(strides)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _unsharded("Conv3D")
        dt = layer_dtype(self.dtype, x, self.weight)
        fused, after = split_bias(self.bias, dt)
        return add_bias(conv3d_nthwc(cast(x, dt), cast(self.weight, dt), fused, self.strides), after)


class Local2D(nn.Module):
    """Locally connected conv layer (reference ``ops.py#local2d``; no model
    uses it): ``kernel [H,W,k,k,Cin,Cout]`` in the JAX layout (so the
    parameter count grows with H x W), ``bias [Cout]``; computes in
    ``dtype`` (the input's when None) as ``local2d_apply`` does. ``H`` and
    ``W`` fix the parameter shapes, as the first input does for flax."""

    def __init__(self, height: int, width: int, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty(height, width, k, k, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _unsharded("Local2D")
        return local2d_apply(cast(x, self.dtype or x.dtype), self.kernel, self.bias)


class SeparableLocal2D(nn.Module):
    """Separable locally connected conv layer (reference
    ``ops.py#separable_local2d``; no model uses it): per-pixel depthwise
    kernels of rank ``rank``, ``vertical`` and ``horizontal`` ``[H,W,k,rank,C]``
    in the JAX layout, ``bias [C]``; computes in ``dtype`` (the input's when
    None) as ``separable_local2d_apply`` does."""

    def __init__(self, height: int, width: int, features: int, kernel_size: int = 3, rank: int = 1,
                 use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        shape = (height, width, kernel_size, rank, features)
        self.vertical = nn.Parameter(torch.empty(shape))
        self.horizontal = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _unsharded("SeparableLocal2D")
        return separable_local2d_apply(cast(x, self.dtype or x.dtype), self.vertical, self.horizontal, self.bias)


class Dense(nn.Module):
    """Fully connected layer (reference ``ops.py#dense``), weight ``[out, in]``.
    ``zero_init``: the weight starts at zero (flax ``kernel_init=zeros``),
    not lecun-normal (``VideoPredictionModel.init_weights``)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype: Dtype = None,
                 zero_init: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = layer_dtype(self.dtype, x, self.weight)
        fused, after = split_bias(self.bias, dt)
        return add_bias(F.linear(cast(x, dt), cast(self.weight, dt), fused), after)


def _transpose_pads(k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of the dilated input in ``lax.conv_transpose``
    with ``padding="SAME"`` along one axis (``_conv_transpose_padding``)."""
    total = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-total // 2)
    return before, total - before


class ConvTranspose2D(nn.Module):
    """Transposed conv (reference ``ops.py#deconv2d``) as flax's
    ``nn.ConvTranspose`` with ``padding="SAME"`` and ``transpose_kernel=False``
    computes it: the input dilated by the stride, padded by ``_transpose_pads``
    (2 before and 1 after for k=3, stride 2) and cross-correlated with the
    kernel as it is; output ``stride`` times the input size.

    The weight is OIHW, the flax kernel mapped as any conv's. It runs as
    ``F.conv_transpose2d``, which pads k-1 on both sides and correlates with
    the kernel flipped and its in/out axes swapped: the forward passes the
    weight so, then crops the padding flax does not add."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, strides: int = 2,
                 use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.pads = _transpose_pads(kernel_size, strides)
        if max(self.pads) > kernel_size - 1:
            raise ValueError(f"kernel {kernel_size} with stride {strides}: SAME padding {self.pads} is past k-1")
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = layer_dtype(self.dtype, x, self.weight)
        fused, after = split_bias(self.bias, dt)
        w = cast(self.weight, dt).transpose(0, 1).flip(2, 3)
        s, k, h = self.strides, self.weight.shape[-1], x.shape[1]
        mesh = current_spatial()
        if mesh is not None:
            # the input rows this shard's output rows read: the dilated rows
            # from s*r0 - pads[0] to s*(r0 + h) - 1 - pads[0] + k - 1
            above = self.pads[0] // s
            below = max(0, (s * (above + h) + k - 2 - self.pads[0]) // s - (above + h - 1))
            x = SP.halo(x, mesh, above, below)
        y = F.conv_transpose2d(cast(x, dt).permute(0, 3, 1, 2), w, fused, stride=s)
        a, b = k - 1 - self.pads[0], k - 1 - self.pads[1]  # conv_transpose2d's padding past flax's
        y = y[:, :, a : y.shape[2] - b, a : y.shape[3] - b]
        if mesh is not None:
            y = y[:, :, s * above : s * (above + h)]
        return add_bias(y.permute(0, 2, 3, 1).contiguous(), after)


class ConvPool2D(nn.Module):
    """Conv-then-pool downsampling (reference ``ops.py#conv_pool2d``): 3x3
    SAME conv, then 2x2 ``pool_mode`` (average or max) pooling, VALID."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, pool_mode: str = "avg",
                 dtype: Dtype = None):
        super().__init__()
        self.pool_mode = pool_mode
        self.conv = Conv2D(in_features, features, kernel_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pool2d(self.conv(x), 2, self.pool_mode)


class UpsampleConv2D(nn.Module):
    """Resize-then-conv upsampling (reference ``ops.py#upsample_conv2d``):
    x2 by ``method`` (nearest or bilinear), then 3x3 SAME conv."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, method: str = "nearest",
                 dtype: Dtype = None):
        super().__init__()
        self.method = method
        self.conv = Conv2D(in_features, features, kernel_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2d(x, 2, self.method))


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
        mesh = current_spatial()
        if mesh is None:
            mu = xg.mean(dim=(1, 2, 4), keepdim=True)
            var = (xg - mu).square().mean(dim=(1, 2, 4), keepdim=True)
        else:  # the statistics of the global H x W, in GroupNorm's order: the mean, then the deviations
            count = h * mesh.k * w * (c // self.num_groups)
            mu = SP.all_reduce_sum(xg.sum(dim=(1, 2, 4), keepdim=True), mesh) / count
            var = SP.all_reduce_sum((xg - mu).square().sum(dim=(1, 2, 4), keepdim=True), mesh) / count
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
    """Upsample registry (reference ``ops.py#get_upsample_layer``); returns a
    constructor taking the input and output channel counts and ``dtype=``."""
    if name == "upsample_conv2d":
        return UpsampleConv2D
    if name == "deconv2d":
        return ConvTranspose2D
    if name == "bilinear_conv2d":
        return functools.partial(UpsampleConv2D, method="bilinear")
    raise ValueError(f"unknown upsample layer {name!r}")


def get_downsample_layer(name: str) -> Callable[..., nn.Module]:
    """Downsample registry (reference ``ops.py#get_downsample_layer``), as
    ``get_upsample_layer``; ``conv2d`` is a 3x3 SAME conv of stride 2."""
    if name == "conv_pool2d":
        return ConvPool2D
    if name == "max_pool_conv2d":
        return functools.partial(ConvPool2D, pool_mode="max")
    if name == "conv2d":
        return functools.partial(Conv2D, kernel_size=3, strides=2)
    raise ValueError(f"unknown downsample layer {name!r}")
