"""Convolutional RNN cells.

Port of ``video_prediction_tpu/ops/rnn.py#ConvLSTMCell`` (reference
``rnn_ops.py#BasicConv2DLSTMCell``). One conv computes all four gates; with
``use_norm`` the gate maths after it (four per-gate LayerNorms, sigmoid/tanh,
cell update, cell LayerNorm, output gate) is kernel K2 (``kernels/ln_gate.py``).
Without norm no TPU kernel covers the gate maths, and it stays torch ops.
``ConvGRUCell`` is still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from video_prediction_torch.kernels.ln_gate import fused_ln_gate
from video_prediction_torch.ops.layers import Conv2D

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

    def __init__(self, in_features: int, features: int, use_norm: bool = False, gate_conv: str = "split"):
        super().__init__()
        self.features = features
        self.use_norm = use_norm
        self.gate_conv = gate_conv
        k = KERNEL_SIZE
        if gate_conv == "merged":
            self.gates = Conv2D(in_features + features, 4 * features, k, use_bias=not use_norm)
        elif gate_conv == "split":
            self.gates_x = Conv2D(in_features, 4 * features, k, use_bias=not use_norm)
            self.gates_h = Conv2D(features, 4 * features, k, use_bias=False)
        else:
            raise ValueError(f"unknown gate_conv {gate_conv!r}")
        if use_norm:
            ln = torch.zeros(10, features)
            ln[0::2] = 1.0  # unit scales, zero biases
            self.ln = nn.Parameter(ln)

    def initial_state(self, batch: int, height: int, width: int, device: torch.device) -> State:
        shape = (batch, height, width, self.features)
        return torch.zeros(shape, device=device), torch.zeros(shape, device=device)

    def forward(self, state: State, x: torch.Tensor) -> Tuple[State, torch.Tensor]:
        c, h = state
        if self.gate_conv == "merged":
            z = self.gates(torch.cat([x, h], dim=-1))
        else:
            z = self.gates_x(x) + self.gates_h(h)
        b, hh, ww, _ = z.shape
        f = self.features
        if self.use_norm:
            # views, never copies: the conv emits contiguous NHWC, so each
            # pixel's 4F gate channels are one row of z
            c_new, h_new = fused_ln_gate(z.view(-1, 4 * f), c.view(-1, f), self.ln, FORGET_BIAS)
            c_new, h_new = c_new.view(b, hh, ww, f), h_new.view(b, hh, ww, f)
        else:
            i, fg, g, o = torch.split(z, f, dim=-1)
            c_new = torch.sigmoid(fg + FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (c_new, h_new), h_new
