"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel of
``video_prediction_tpu/ops/pallas_kernels.py``.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors, raising on any input the kernel does not take.
There is no fallback from a CUDA tensor to the plain version. Each wrapper
carries a ``launches`` counter, incremented once per kernel launch.
"""

from __future__ import annotations

from typing import Dict

from video_prediction_torch.kernels.cdna import apply_cdna_kernels, apply_cdna_kernels_reference
from video_prediction_torch.kernels.composite import composite, composite_reference
from video_prediction_torch.kernels.ln_gate import fused_ln_gate, fused_ln_gate_reference

WRAPPERS = {
    "apply_cdna_kernels": apply_cdna_kernels,
    "fused_ln_gate": fused_ln_gate,
    "composite": composite,
}

__all__ = [
    "WRAPPERS",
    "apply_cdna_kernels",
    "apply_cdna_kernels_reference",
    "composite",
    "composite_reference",
    "fused_ln_gate",
    "fused_ln_gate_reference",
    "launch_counts",
    "reset_launch_counts",
]


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
