"""The device a command-line tool runs on."""

from __future__ import annotations

import torch


def device_or_raise(name: str) -> torch.device:
    """``torch.device(name)``; raises if it names a CUDA device and there is
    none, so that a tool never runs on the CPU when it was asked for the card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available (torch.cuda.is_available() is False); "
                           "pass --device cpu to run on the CPU")
    return device
