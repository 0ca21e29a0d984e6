"""Train state: the model (parameters and spectral ``u`` buffers), two Adam
optimizers (generator side and discriminators), the step and the RNG.

Port of ``video_prediction_tpu/train/state.py``. The JAX package keeps one
immutable pytree; here the model and the optimizers are updated in place
(no second copy of the parameters or of the Adam moments) and the state
object holds them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

GEN_KEYS = ("generator", "posterior", "prior")
ADAM_EPS = 1e-8  # optax.adam's default (eps_root 0): the update torch.optim.Adam makes


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_g: Optional[torch.optim.Adam]
    opt_d: Optional[torch.optim.Adam]
    step: int
    rng: torch.Generator  # the step noise, on the model's device


def split_params(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """The parameters of the generator-side top-level modules (``GEN_KEYS``)
    and those of ``discriminator``."""
    g, d = [], []
    for name, child in model.named_children():
        if name in GEN_KEYS:
            g.extend(child.parameters())
        elif name == "discriminator":
            d.extend(child.parameters())
    return g, d


def make_optimizers(model: nn.Module) -> Tuple[Optional[torch.optim.Adam], Optional[torch.optim.Adam]]:
    """Two Adams with the same betas (reference ``base_model.py``); the train
    step sets their learning rate from ``schedules.learning_rate`` each step."""
    hp = model.hparams
    g, d = split_params(model)

    def adam(params):
        return torch.optim.Adam(params, lr=hp.lr, betas=(hp.beta1, hp.beta2), eps=ADAM_EPS) if params else None

    return adam(g), adam(d)


def create_train_state(model: nn.Module, seed: int, device: torch.device | str) -> TrainState:
    """Initialize ``model`` from ``seed`` (on the CPU, so every device gets the
    same weights), move it to ``device`` and build the optimizers; the step
    noise comes from a generator on ``device`` seeded with ``seed + 1``."""
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device)
    opt_g, opt_d = make_optimizers(model)
    rng = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, opt_g=opt_g, opt_d=opt_d, step=0, rng=rng)


def param_count(params) -> int:
    return sum(p.numel() for p in params)
