"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel of
``video_prediction_tpu/ops/pallas_kernels.py``, each with a backward kernel.

Each forward wrapper runs its plain PyTorch version on CPU tensors and, on
CUDA tensors, a ``torch.autograd.Function`` that launches the forward CUDA
kernel and whose backward launches the backward CUDA kernel (through the
``*_backward`` wrappers), raising on any input the kernels do not take.
There is no fallback from a CUDA tensor to the plain version. Each of the
six wrappers carries ``launches``, its kernel's launches counted by the
dtype of the tensors (``{"float32": n, "bfloat16": m}``), one added per
launch. A CUDA graph launches the kernels its capture recorded without
calling the wrappers: the train step that replays one
(``train/step.py``) takes the capture's counts back out with
``add_launches(delta, -1)`` and adds them once per replay.
"""

from __future__ import annotations

from typing import Dict

from video_prediction_torch.kernels.cdna import (
    apply_cdna_kernels,
    apply_cdna_kernels_backward,
    apply_cdna_kernels_reference,
)
from video_prediction_torch.kernels.composite import composite, composite_backward, composite_reference
from video_prediction_torch.kernels.ln_gate import fused_ln_gate, fused_ln_gate_backward, fused_ln_gate_reference

WRAPPERS = {
    "apply_cdna_kernels": apply_cdna_kernels,
    "fused_ln_gate": fused_ln_gate,
    "composite": composite,
    "apply_cdna_kernels_backward": apply_cdna_kernels_backward,
    "fused_ln_gate_backward": fused_ln_gate_backward,
    "composite_backward": composite_backward,
}

__all__ = [
    "WRAPPERS",
    "add_launches",
    "apply_cdna_kernels",
    "apply_cdna_kernels_backward",
    "apply_cdna_kernels_reference",
    "composite",
    "composite_backward",
    "composite_reference",
    "fused_ln_gate",
    "fused_ln_gate_backward",
    "fused_ln_gate_reference",
    "launch_counts",
    "launch_dtypes",
    "reset_launch_counts",
]


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = {}


def launch_counts() -> Dict[str, int]:
    return {name: sum(fn.launches.values()) for name, fn in WRAPPERS.items()}


def launch_dtypes() -> Dict[str, Dict[str, int]]:
    """Each wrapper's launches by dtype, where it launched."""
    return {name: dict(fn.launches) for name, fn in WRAPPERS.items() if fn.launches}


def add_launches(counts: Dict[str, Dict[str, int]], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (wrapper -> dtype -> launches, as
    ``launch_dtypes`` gives them) to the wrappers' counters."""
    for name, by_dtype in counts.items():
        launches = WRAPPERS[name].launches
        for dtype, n in by_dtype.items():
            launches[dtype] = launches.get(dtype, 0) + times * n
