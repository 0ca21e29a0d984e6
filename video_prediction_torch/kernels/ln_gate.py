"""K2: per-gate LayerNorm + ConvLSTM gate math (``csrc/ln_gate.cu``),
forward and backward.

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#fused_ln_gate``:
``z [R,4C]`` gate pre-activations (i, f, g, o), ``c [R,C]`` previous cell
state and ``ln_params [10,C]`` (scale, bias rows for i, f, g, o, c) ->
``(c_new, h_new)``, each ``[R,C]`` in ``c.dtype``, fp32 maths, LayerNorm eps
1e-6 with two-pass variance.

The Pallas kernel is forward only; JAX training differentiates the XLA
LayerNorm path of ``ops/rnn.py``. Here the wrapper is a
``torch.autograd.Function`` whose backward is a CUDA kernel too
(``fused_ln_gate_backward``: dz, dc and d ln_params from the gradients of
both outputs; it recomputes the LayerNorm statistics instead of saving
them). The CUDA kernels are memory-bound (one warp per row; designs noted
in the source). On CPU tensors the wrappers run the plain version below
(and autograd differentiates it); on CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_prediction_torch.kernels import _lib

LN_EPS = 1e-6
MAX_CHANNELS = 512  # the kernels hold ceil(C/32) <= 16 values per gate per lane


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


def _check(z: torch.Tensor, c: torch.Tensor, ln_params: torch.Tensor) -> None:
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


def _forward_kernel(z, c, ln_params, forget_bias):
    _check(z, c, ln_params)
    r, cdim = c.shape
    c_new = torch.empty_like(c)
    h_new = torch.empty_like(c)
    _lib.launch(
        "vp_ln_gate_forward", z.data_ptr(), c.data_ptr(), ln_params.data_ptr(),
        c_new.data_ptr(), h_new.data_ptr(), r, cdim, float(forget_bias), _lib.dtype_code(c),
        device=c.device,
    )
    fused_ln_gate.launches += 1
    return c_new, h_new


def fused_ln_gate_backward(
    z: torch.Tensor, c: torch.Tensor, ln_params: torch.Tensor, d_c_new: torch.Tensor, d_h_new: torch.Tensor,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dz [R,4C], dc [R,C], d ln_params [10,C])`` of ``fused_ln_gate`` for
    the upstream gradients of ``c_new`` and ``h_new``; the CUDA kernel on CUDA
    tensors, autograd of the plain version on CPU tensors."""
    if _lib.on_cpu(z, c, ln_params, d_c_new, d_h_new):
        return _lib.plain_vjp(
            lambda z_, c_, p_: fused_ln_gate_reference(z_, c_, p_, forget_bias), (z, c, ln_params), (d_c_new, d_h_new)
        )
    _check(z, c, ln_params)
    r, cdim = c.shape
    for name, g in (("d_c_new", d_c_new), ("d_h_new", d_h_new)):
        _lib.require(g.shape == c.shape and g.dtype == c.dtype and g.is_contiguous(),
                     f"{name} must be a contiguous {c.dtype} tensor of shape {tuple(c.shape)}")
    nblocks = _lib.query("vp_ln_gate_backward_blocks", r, c.device.index)
    _lib.require(nblocks > 0, "cannot read the device's SM count")
    dz = torch.empty_like(z)
    dc = torch.empty_like(c)
    d_ln = torch.empty_like(ln_params)
    partial = torch.empty((nblocks, 10, cdim), dtype=torch.float32, device=c.device)
    _lib.launch(
        "vp_ln_gate_backward", z.data_ptr(), c.data_ptr(), ln_params.data_ptr(), d_c_new.data_ptr(),
        d_h_new.data_ptr(), dz.data_ptr(), dc.data_ptr(), d_ln.data_ptr(), partial.data_ptr(), r, cdim,
        float(forget_bias), nblocks, _lib.dtype_code(c), device=c.device,
    )
    fused_ln_gate_backward.launches += 1
    return dz, dc, d_ln


class _LNGateFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, ln_params, forget_bias):
        ctx.save_for_backward(z, c, ln_params)
        ctx.forget_bias = forget_bias
        return _forward_kernel(z, c, ln_params, forget_bias)

    @staticmethod
    def backward(ctx, d_c_new, d_h_new):
        z, c, ln_params = ctx.saved_tensors
        dz, dc, d_ln = fused_ln_gate_backward(
            z, c, ln_params, d_c_new.contiguous(), d_h_new.contiguous(), ctx.forget_bias
        )
        need = ctx.needs_input_grad
        return (dz if need[0] else None, dc if need[1] else None, d_ln if need[2] else None, None)


def fused_ln_gate(
    z: torch.Tensor, c: torch.Tensor, ln_params: torch.Tensor, forget_bias: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(z [R,4C], c [R,C], ln_params [10,C]) -> (c_new, h_new)``; the CUDA
    kernels (forward and backward) on CUDA tensors."""
    if _lib.on_cpu(z, c, ln_params):
        return fused_ln_gate_reference(z, c, ln_params, forget_bias)
    return _LNGateFunction.apply(z, c, ln_params, forget_bias)


fused_ln_gate.launches = 0
fused_ln_gate_backward.launches = 0
