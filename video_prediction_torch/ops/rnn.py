"""Convolutional RNN cells.

Port of ``video_prediction_tpu/ops/rnn.py#ConvLSTMCell`` (reference
``rnn_ops.py#BasicConv2DLSTMCell``). One conv computes all four gates; with
``use_norm`` the gate maths after it (four per-gate LayerNorms, sigmoid/tanh,
cell update, cell LayerNorm, output gate) is kernel K2 (``kernels/ln_gate.py``).
Without norm no TPU kernel covers the gate maths, and it stays torch ops.
``ConvGRUCell`` (JAX ``rnn.py:123-153``) runs no kernel: two convs and fp32
gate maths in torch ops, as XLA runs them.

Dtypes as in the JAX cell (``video_prediction_tpu/ops/rnn.py:59-121``): the
gate convs run in ``dtype`` (the compute dtype; the split form adds its two
convs in it), the state is kept in the dtype the caller makes it in (the
compute dtype, ``initial_state``), and the gate maths run in ``gate_dtype``.
K2 reads z and c in one dtype and computes in fp32, writing that dtype. So
with fp32 gates it takes them in the state dtype, which is exact: the JAX
cell's cast of bf16 to fp32 loses nothing, and it casts its fp32 results
back to the state dtype as K2 writes them. With bf16 gates it takes them in
bf16 (cast from an fp32 state, and its outputs cast back); the JAX cell
then rounds every intermediate of the gate maths to bf16, K2 rounds none: a
known departure (ROADMAP.md, queue 3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from video_prediction_torch.kernels.ln_gate import fused_ln_gate
from video_prediction_torch.ops.layers import Conv2D, cast

State = Tuple[torch.Tensor, torch.Tensor]
KERNEL_SIZE = 5  # gate conv, as every SAVP cell builds it (savp.py:131-139)
FORGET_BIAS = 1.0


class ConvLSTMCell(nn.Module):
    """Conv LSTM cell over NHWC tensors; state ``(c, h)``, each ``[B,H,W,F]``.

    ``gate_conv`` picks the JAX package's two parameter layouts: "split"
    (``gates_x`` over the input, with a bias only when ``use_norm`` is off,
    plus ``gates_h`` over h without bias, summed) or "merged" (one ``gates``
    conv over ``concat([x, h])``). With ``use_norm`` the LayerNorm scales and
    biases live in ``ln`` ``[10, F]``: rows scale, bias for i, f, g, o, then
    the cell state — the layout kernel K2 reads.
    """

    def __init__(self, in_features: int, features: int, use_norm: bool = False, gate_conv: str = "split",
                 dtype: Optional[torch.dtype] = None, gate_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.use_norm = use_norm
        self.gate_conv = gate_conv
        self.gate_dtype = gate_dtype
        k = KERNEL_SIZE
        if gate_conv == "merged":
            self.gates = Conv2D(in_features + features, 4 * features, k, use_bias=not use_norm, dtype=dtype)
        elif gate_conv == "split":
            self.gates_x = Conv2D(in_features, 4 * features, k, use_bias=not use_norm, dtype=dtype)
            self.gates_h = Conv2D(features, 4 * features, k, use_bias=False, dtype=dtype)
        else:
            raise ValueError(f"unknown gate_conv {gate_conv!r}")
        if use_norm:
            ln = torch.zeros(10, features)
            ln[0::2] = 1.0  # unit scales, zero biases
            self.ln = nn.Parameter(ln)

    def initial_state(self, batch: int, height: int, width: int, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> State:
        shape = (batch, height, width, self.features)
        return torch.zeros(shape, device=device, dtype=dtype), torch.zeros(shape, device=device, dtype=dtype)

    def forward(self, state: State, x: torch.Tensor) -> Tuple[State, torch.Tensor]:
        c, h = state
        if self.gate_conv == "merged":
            z = self.gates(torch.cat([x, cast(h, x.dtype)], dim=-1))
        else:
            z = self.gates_x(x) + self.gates_h(h)
        b, hh, ww, _ = z.shape
        f = self.features
        if self.use_norm:
            # K2's dtype: bf16 gates take bf16; fp32 gates the dtype that
            # holds z and c exactly
            kd = torch.promote_types(z.dtype, c.dtype) if self.gate_dtype == torch.float32 else self.gate_dtype
            # views, never copies (when no cast is due): the conv emits
            # contiguous NHWC, so each pixel's 4F gate channels are one row of z
            c_new, h_new = fused_ln_gate(cast(z, kd).view(-1, 4 * f), cast(c, kd).view(-1, f), self.ln, FORGET_BIAS)
            c_new, h_new = c_new.view(b, hh, ww, f), h_new.view(b, hh, ww, f)
        else:
            gdt = self.gate_dtype
            i, fg, g, o = torch.split(cast(z, gdt), f, dim=-1)
            c_new = torch.sigmoid(fg + FORGET_BIAS) * cast(c, gdt) + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
        c_new, h_new = cast(c_new, c.dtype), cast(h_new, h.dtype)
        return (c_new, h_new), h_new


class ConvGRUCell(nn.Module):
    """Conv GRU cell over NHWC tensors (reference ``rnn_ops.py#Conv2DGRUCell``);
    state ``h`` ``[B,H,W,F]``, one tensor. ``gates`` (2F: reset r, update u)
    over ``concat([x, h])`` with +1.0 on both before the sigmoid, then
    ``candidate`` over ``concat([x, r * h])``; the gate maths in fp32, ``h``
    cast back to its own dtype."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.gates = Conv2D(in_features + features, 2 * features, KERNEL_SIZE, dtype=dtype)
        self.candidate = Conv2D(in_features + features, features, KERNEL_SIZE, dtype=dtype)

    def initial_state(self, batch: int, height: int, width: int, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.zeros((batch, height, width, self.features), device=device, dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ru = torch.sigmoid(cast(self.gates(torch.cat([x, cast(h, x.dtype)], dim=-1)), torch.float32) + 1.0)
        r, u = torch.split(ru, self.features, dim=-1)
        cand = self.candidate(torch.cat([x, cast(cast(r, h.dtype) * h, x.dtype)], dim=-1))
        h_new = cast(u * cast(h, torch.float32) + (1.0 - u) * torch.tanh(cast(cand, torch.float32)), h.dtype)
        return h_new, h_new
