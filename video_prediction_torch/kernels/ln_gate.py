"""K2: per-gate LayerNorm + ConvLSTM gate math (``csrc/ln_gate.cu``).

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#fused_ln_gate``:
``z [R,4C]`` gate pre-activations (i, f, g, o), ``c [R,C]`` previous cell
state and ``ln_params [10,C]`` (scale, bias rows for i, f, g, o, c) ->
``(c_new, h_new)``, each ``[R,C]`` in ``c.dtype``, fp32 maths, LayerNorm eps
1e-6 with two-pass variance.

The CUDA kernel is memory-bound (one warp per row; design noted in the
source). On CPU tensors the wrapper runs the plain version below; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_prediction_torch.kernels import _lib

LN_EPS = 1e-6
MAX_CHANNELS = 512  # the kernel holds ceil(C/32) <= 16 values per gate per lane


def _ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def fused_ln_gate_reference(
    z: torch.Tensor, c: torch.Tensor, ln_params: torch.Tensor, forget_bias: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel."""
    cdim = c.shape[-1]
    zf, cf, lnp = z.float(), c.float(), ln_params.float()
    i = torch.sigmoid(_ln_rows(zf[:, 0 * cdim : 1 * cdim], lnp[0], lnp[1]))
    f = torch.sigmoid(_ln_rows(zf[:, 1 * cdim : 2 * cdim], lnp[2], lnp[3]) + forget_bias)
    g = torch.tanh(_ln_rows(zf[:, 2 * cdim : 3 * cdim], lnp[4], lnp[5]))
    o = torch.sigmoid(_ln_rows(zf[:, 3 * cdim : 4 * cdim], lnp[6], lnp[7]))
    c_new = f * cf + i * g
    h_new = o * torch.tanh(_ln_rows(c_new, lnp[8], lnp[9]))
    return c_new.to(c.dtype), h_new.to(c.dtype)


def fused_ln_gate(
    z: torch.Tensor, c: torch.Tensor, ln_params: torch.Tensor, forget_bias: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(z [R,4C], c [R,C], ln_params [10,C]) -> (c_new, h_new)``; the CUDA
    kernel on CUDA tensors."""
    if _lib.on_cpu(z, c, ln_params):
        return fused_ln_gate_reference(z, c, ln_params, forget_bias)
    _lib.require(c.dim() == 2 and z.dim() == 2, "want z [R,4C] and c [R,C]")
    r, cdim = c.shape
    _lib.require(tuple(z.shape) == (r, 4 * cdim), f"z {tuple(z.shape)} does not match c {tuple(c.shape)}")
    _lib.require(tuple(ln_params.shape) == (10, cdim), f"ln_params must be [10,{cdim}], got {tuple(ln_params.shape)}")
    _lib.require(z.dtype == c.dtype, f"z ({z.dtype}) and c ({c.dtype}) must share a dtype")
    _lib.require(ln_params.dtype == torch.float32, f"ln_params must be float32, got {ln_params.dtype}")
    _lib.require(0 < cdim <= MAX_CHANNELS, f"C={cdim} outside 1..{MAX_CHANNELS}")
    _lib.require(r > 0, "empty input")
    _lib.require(
        z.is_contiguous() and c.is_contiguous() and ln_params.is_contiguous(),
        "z, c and ln_params must be contiguous (keep the gate conv channels-last)",
    )
    c_new = torch.empty_like(c)
    h_new = torch.empty_like(c)
    _lib.launch(
        "vp_ln_gate_forward", z.data_ptr(), c.data_ptr(), ln_params.data_ptr(),
        c_new.data_ptr(), h_new.data_ptr(), r, cdim, float(forget_bias), _lib.dtype_code(c),
        device=c.device,
    )
    fused_ln_gate.launches += 1
    return c_new, h_new


fused_ln_gate.launches = 0
