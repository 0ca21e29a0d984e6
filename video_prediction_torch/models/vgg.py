"""VGG-16 features for the VGG cosine-similarity metric.

Port of ``video_prediction_tpu/models/vgg.py`` (reference
``video_prediction/models/vgg_network.py``). No VGG weights ship with the
repository and none are downloaded, so:

- ``load_params_npz`` reads a local ``.npz`` with the JAX package's keys,
  ``conv{block}_{idx}/kernel`` (HWIO) and ``.../bias``, and transposes each
  kernel to PyTorch's OIHW: one file serves both packages;
- ``VGGMetric`` refuses to run without weights unless ``allow_random=True``,
  and then tags itself ``untrained`` (its random init is PyTorch's, not the
  JAX package's; the values compare with nothing).

Feature taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3. The convolutions
are cuDNN's, as they were XLA's in the JAX package, and run under the
process's TF32 setting, as the JAX package sets no precision for them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from video_prediction_torch.metrics import COSINE_EPS, unit_normalize

# (block, convs in the block, channels)
_CFG = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]

# ImageNet normalization (inputs are [0,1] RGB)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """VGG-16 conv trunk: ``[N, H, W, 3]`` in [0, 1] -> the 5 relu taps, each
    NCHW (``[N, C, h, w]``). 3x3 SAME convs, 2x2 max pools (VALID)."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for block, n_convs, ch in _CFG:
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{block}_{i}", nn.Conv2d(c_in, ch, 3, padding=1))
                c_in = ch
        self.register_buffer("mean", torch.tensor(_MEAN).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x.float().permute(0, 3, 1, 2) - self.mean) / self.std
        taps = []
        for block, n_convs, _ in _CFG:
            for i in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{block}_{i}")(x))
            taps.append(x)
            x = F.max_pool2d(x, 2)
        return taps


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``VGG16Features`` from an ``.npz`` with
    ``conv{b}_{i}/kernel`` (HWIO) and ``conv{b}_{i}/bias`` keys."""
    data = np.load(path)
    state: Dict[str, torch.Tensor] = {}
    for block, n_convs, _ in _CFG:
        for i in range(1, n_convs + 1):
            name = f"conv{block}_{i}"
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(data[f"{name}/kernel"].transpose(3, 2, 0, 1)))
            state[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}/bias"]))
    return state


def build_features(weights_path: Optional[str], allow_random: bool, device, what: str):
    """``(VGG16Features on device with frozen weights, untrained)``: the weights
    of ``weights_path`` when it exists, else a seeded random init when
    ``allow_random``, else ``FileNotFoundError``."""
    module = VGG16Features()
    if weights_path and os.path.exists(weights_path):
        module.load_state_dict(load_params_npz(weights_path))
        untrained = False
    elif allow_random:
        with torch.random.fork_rng(devices=[]):  # PyTorch's own init, from seed 0, leaving the global stream as it was
            torch.manual_seed(0)
            module = VGG16Features()
        untrained = True
    else:
        raise FileNotFoundError(
            f"{what} needs VGG16 weights: pass a path to a conv{{b}}_{{i}}/kernel .npz, or allow_random=True "
            "for untrained features (values tagged 'untrained', NOT comparable to the reference)."
        )
    module.requires_grad_(False)
    return module.to(device).eval(), untrained


def prepare_taps(module: VGG16Features, images: torch.Tensor, eps: float) -> List[torch.Tensor]:
    """The 5 taps of ``images [..., H, W, C]``, each in fp32, unit-normalised
    over its channels and ``[..., C, h, w]``."""
    lead = images.shape[:-3]
    taps = module(images.reshape(-1, *images.shape[-3:]))
    return [unit_normalize(t.float(), 1, eps).reshape(*lead, *t.shape[1:]) for t in taps]


class VGGMetric:
    """VGG cosine similarity between image batches: ``__call__(a, b)`` on
    ``[..., H, W, C]`` gives ``[...]``, the mean over the 5 taps of the
    channel cosine at each position averaged over the positions. Runs on
    ``device``; inputs must lie there.

    The metric splits for one target scored against many samples:
    ``prepare(target)`` runs the trunk on the target's frames and keeps
    their unit-normalised taps, and ``score(prepared, pred)`` runs it on the
    predictions only and takes the channel dot product against the target's
    taps broadcast over the sample axis. ``evaluate.BestOfN`` prepares a
    batch's target once; ``__call__``, which the ``vgg_cdist`` training loss
    differentiates, is the split at one target and one sample."""

    def __init__(self, weights_path: Optional[str] = None, allow_random: bool = False,
                 device: torch.device | str = "cpu"):
        self.module, self.untrained = build_features(weights_path, allow_random, device, "VGGMetric")

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.score(self.prepare(a[None]), b[None, None])[0, 0]

    def prepare(self, target: torch.Tensor) -> List[torch.Tensor]:
        """``target [B, ..., H, W, C]`` -> its 5 taps, unit-normalised over
        the channels, each ``[B, ..., C, h, w]``."""
        return prepare_taps(self.module, target, COSINE_EPS)

    def score(self, prepared: List[torch.Tensor], pred: torch.Tensor) -> torch.Tensor:
        """``pred [B, k, ..., H, W, C]``, ``k`` samples of the target that
        ``prepared`` holds -> the cosine similarity ``[B, k, ...]``."""
        sims = [(tt.unsqueeze(1) * tp).sum(dim=-3).mean(dim=(-2, -1))
                for tt, tp in zip(prepared, prepare_taps(self.module, pred, COSINE_EPS))]
        return torch.stack(sims).mean(dim=0)
