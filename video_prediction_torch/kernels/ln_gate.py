"""K2: per-gate LayerNorm + ConvLSTM gate math (``csrc/ln_gate.cu``),
forward and backward.

Replaces ``video_prediction_tpu/ops/pallas_kernels.py#fused_ln_gate``:
``z [R,4C]`` gate pre-activations (i, f, g, o), ``c [R,C]`` previous cell
state and ``ln_params [10,C]`` (scale, bias rows for i, f, g, o, c) ->
``(c_new, h_new)``, each ``[R,C]`` in ``c.dtype``, fp32 maths, LayerNorm eps
1e-6 with two-pass variance. The CUDA kernels take sigmoid and tanh from
approximate exponentials (``__expf``); their fp32 outputs stay within the
1e-5 tolerance of the plain version (measured error in ``csrc/ln_gate.cu``'s
header).

The Pallas kernel is forward only; JAX training differentiates the XLA
LayerNorm path of ``ops/rnn.py``. Here the wrapper is a
``torch.autograd.Function`` whose backward is a CUDA kernel too
(``fused_ln_gate_backward``: dz, dc and d ln_params from the gradients of
both outputs; it recomputes the LayerNorm statistics instead of saving
them). The CUDA kernels are memory-bound (design noted in the source). On
CPU tensors the wrappers run the plain version below (and autograd
differentiates it); on CUDA tensors they launch the kernels or raise.

Every launch's geometry comes from ``plan``, a pure function of the shapes,
the dtype, the alignment of the tensors, the SM count and the blocks an SM
holds (the occupancy the device reports for that instantiation), so that
the CPU tests reach it; the C launchers check it against the instantiation
they select.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, List, Tuple

import torch

from video_prediction_torch.kernels import _lib

LN_EPS = 1e-6
MAX_CHANNELS = 512  # the run-time instantiation holds at most 16 values of a gate a lane
# the widths with a compile-time instantiation of 16-byte chunks, staged by
# bulk copies into a two-stage ring; the run-time instantiation copies
# through registers, one stage
VECTOR_WIDTHS = (32, 64, 128, 256)
MAX_WARPS = 8  # warps a block (256 threads, the kernels' launch bound)
SMEM_LIMIT = 232_448  # shared memory a block may use on the H100 (227 KB)


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


@dataclass(frozen=True)
class Plan:
    """Geometry of one K2 launch (``csrc/ln_gate.cu``)."""

    width: int  # C of the compile-time instantiation; 0: the run-time one
    vec: int  # values a 16-byte chunk (4 fp32, 8 bf16); 1: scalar loads
    lanes: int  # lanes a row spans
    rows_per_warp: int  # rows of a warp's tile (32 // lanes)
    per_lane: int  # values of each gate a lane holds
    warps: int  # warps a block
    stages: int  # tiles in a warp's staging ring
    smem: int  # dynamic shared memory of a block, bytes
    tiles: int  # row tiles, ceil(R / rows_per_warp)
    blocks: int  # persistent blocks (the backward's d ln_params partials)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(rows_per_warp: int, per_lane: int, cdim: int, itemsize: int, backward: bool, warps: int,
               stages: int) -> int:
    """A block's shared memory, as ``csrc/ln_gate.cu#smem_bytes``: the warps'
    mbarriers (two each), ln_params [10,C] fp32, the warps' staging rings (a
    tile of z and c, and dc' and dh for the backward, in the dtype), and for
    the backward the warps' d ln_params slices [10, per_lane, 32] fp32."""
    stage = _align16(rows_per_warp * (7 if backward else 5) * cdim * itemsize)
    return (_align16(16 * warps) + _align16(10 * cdim * 4) + warps * stages * stage
            + (warps * 10 * per_lane * 32 * 4 if backward else 0))


def plan(rows: int, cdim: int, itemsize: int, aligned: bool, backward: bool, sms: int,
         blocks_per_sm: Callable[[Plan], int]) -> Plan:
    """The launch geometry of K2 for ``rows`` x ``cdim`` in a dtype of
    ``itemsize`` bytes; ``aligned``: every tensor the kernel reads or writes
    (ln_params too) starts on a 16-byte boundary. ``blocks_per_sm(plan)`` is
    the occupancy of the plan's instantiation (the device's answer, or a
    model of it in tests).

    Flagship widths with aligned tensors take 16-byte chunks on L =
    clamp(C/V, 4, 32) lanes a row and a two-stage ring of bulk copies; every
    other case the run-time instantiation (one row a warp, lane l holding l,
    l+32, ..., scalar loads, one stage). Warps a block: at most 8, fewer where the
    tiles would not give each SM a block, or where the shared memory would
    not fit; the grid is as many blocks as fit on the card at once, or as
    the tiles need."""
    vector = cdim in VECTOR_WIDTHS and aligned
    if vector:
        vec = 16 // itemsize
        lanes = min(32, max(4, cdim // vec))
        per_lane, width, stages = cdim // lanes, cdim, 2
    else:
        vec, lanes, width, stages = 1, 32, 0, 1
        per_lane = 1
        while 32 * per_lane < cdim:
            per_lane *= 2
    rows_per_warp = 32 // lanes
    tiles = -(-rows // rows_per_warp)
    warps = MAX_WARPS
    while warps > 1 and (-(-tiles // warps) < sms or smem_bytes(rows_per_warp, per_lane, cdim, itemsize, backward,
                                                                 warps, stages) > SMEM_LIMIT):
        warps //= 2
    geometry = Plan(width, vec, lanes, rows_per_warp, per_lane, warps, stages,
                    smem_bytes(rows_per_warp, per_lane, cdim, itemsize, backward, warps, stages), tiles, 0)
    per_sm = blocks_per_sm(geometry)
    _lib.require(per_sm > 0, f"K2 plan {geometry} fits no block on an SM ({per_sm})")
    return replace(geometry, blocks=min(-(-tiles // warps), per_sm * sms))


def lane_channels(p: Plan, cdim: int, lane: int) -> List[int]:
    """Channels that lane ``lane`` (0..lanes-1) of a row holds, slot by slot,
    as ``csrc/ln_gate.cu#Row`` maps them (run time: those below C)."""
    if p.width:
        return [(lane + p.lanes * (k // p.vec)) * p.vec + k % p.vec for k in range(p.per_lane)]
    return [ch for ch in (lane + 32 * k for k in range(p.per_lane)) if ch < cdim]


def warp_rows(p: Plan, rows: int, block: int, warp: int) -> List[int]:
    """Rows that warp ``warp`` of block ``block`` takes, tile by tile, as the
    kernels walk them (tile = global warp, + every warp of the grid, ...)."""
    stride = p.blocks * p.warps
    out = []
    for tile in range(block * p.warps + warp, p.tiles, stride):
        out.extend(r for r in range(tile * p.rows_per_warp, (tile + 1) * p.rows_per_warp) if r < rows)
    return out


@functools.lru_cache(maxsize=None)
def _cached_plan(backward: bool, rows: int, cdim: int, code: int, itemsize: int, aligned: bool, device: int) -> Plan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def blocks_per_sm(p: Plan) -> int:
        return _lib.query("vp_ln_gate_blocks_per_sm", int(backward), code, cdim, p.width, p.per_lane,
                          p.warps, p.stages, p.smem, device)

    return plan(rows, cdim, itemsize, aligned, backward, sms, blocks_per_sm)


def _device_plan(backward: bool, tensors) -> Plan:
    """``plan`` for CUDA tensors (z, c, ...): alignment read from their
    addresses, SM count and occupancy from the device; cached."""
    c = tensors[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return _cached_plan(backward, c.shape[0], c.shape[1], _lib.dtype_code(c), c.element_size(), aligned,
                        c.device.index)


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


def _plan_args(p: Plan) -> tuple:
    return p.width, p.per_lane, p.warps, p.stages, p.blocks, p.smem


def _forward_kernel(z, c, ln_params, forget_bias):
    _check(z, c, ln_params)
    r, cdim = c.shape
    c_new = torch.empty_like(c)
    h_new = torch.empty_like(c)
    p = _device_plan(False, (z, c, ln_params, c_new, h_new))
    _lib.launch(
        "vp_ln_gate_forward", z.data_ptr(), c.data_ptr(), ln_params.data_ptr(),
        c_new.data_ptr(), h_new.data_ptr(), r, cdim, float(forget_bias), *_plan_args(p), _lib.dtype_code(c),
        device=c.device,
    )
    _lib.count_launch(fused_ln_gate, c.dtype)
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
    dz = torch.empty_like(z)
    dc = torch.empty_like(c)
    d_ln = torch.empty_like(ln_params)
    p = _device_plan(True, (z, c, ln_params, d_c_new, d_h_new, dz, dc))
    partial = torch.empty((p.blocks, 10, cdim), dtype=torch.float32, device=c.device)
    _lib.launch(
        "vp_ln_gate_backward", z.data_ptr(), c.data_ptr(), ln_params.data_ptr(), d_c_new.data_ptr(),
        d_h_new.data_ptr(), dz.data_ptr(), dc.data_ptr(), d_ln.data_ptr(), partial.data_ptr(), r, cdim,
        float(forget_bias), *_plan_args(p), _lib.dtype_code(c), device=c.device,
    )
    _lib.count_launch(fused_ln_gate_backward, c.dtype)
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


fused_ln_gate.launches = {}
fused_ln_gate_backward.launches = {}
