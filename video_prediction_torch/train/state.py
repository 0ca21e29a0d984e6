"""Train state: the model (parameters and spectral ``u`` buffers), two Adam
optimizers (generator side and discriminators), the step and the RNG.

Port of ``video_prediction_tpu/train/state.py``. The JAX package keeps one
immutable pytree; here the model and the optimizers are updated in place
(no second copy of the parameters or of the Adam moments) and the state
object holds them.

The train step of several steps a call (``train/step.py``, ``steps_per_call
> 1``) needs Adams built for it (``make_optimizers(model, steps_per_call)``):
the learning rate a 0-d float32 tensor on the parameters' device, which the
step writes in place each step, and, on CUDA, ``capturable=True`` (Adam's
step count and bias corrections on the device), so that a CUDA graph holds
the whole update. ``load_optimizer`` restores a saved Adam into either kind.

A saved Adam (``optimizer_state``) keys its slots by parameter name (the
model's ``state_dict`` key), not by position: ``convert.py`` writes one from
a JAX run without building the model, and the loader maps the names onto
the model it is given. Files written before that, keyed by position in
``split_params`` order, still load.

Data parallel (``parallel/``): every rank builds the same state, the weights
from the same seed and the noise generator seeded alike, so that every rank
draws the global batch's noise and keeps its slice (``train/step.py``); the
train CLI then broadcasts rank 0's parameters and buffers
(``parallel/mesh.py#broadcast_module_``) after the state is built, resumed or
warm-started. The state holds nothing per rank, so a checkpoint written at
one world size resumes at another.
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


def make_optimizers(model: nn.Module, steps_per_call: int = 1
                    ) -> Tuple[Optional[torch.optim.Adam], Optional[torch.optim.Adam]]:
    """Two Adams with the same betas (reference ``base_model.py``); the train
    step sets their learning rate from ``schedules.learning_rate`` each step.
    For ``steps_per_call > 1`` the learning rate is a 0-d float32 tensor on
    the parameters' device, and on CUDA the Adams are capturable."""
    hp = model.hparams
    g, d = split_params(model)

    def adam(params):
        if not params:
            return None
        if steps_per_call == 1:
            return torch.optim.Adam(params, lr=hp.lr, betas=(hp.beta1, hp.beta2), eps=ADAM_EPS)
        device = params[0].device
        return torch.optim.Adam(params, lr=torch.tensor(hp.lr, dtype=torch.float32, device=device),
                                betas=(hp.beta1, hp.beta2), eps=ADAM_EPS, capturable=device.type == "cuda")

    return adam(g), adam(d)


def optimizer_param_names(model: nn.Module, opt: torch.optim.Adam) -> List[str]:
    """The ``state_dict`` names of ``opt``'s parameters, in its order."""
    names = {id(p): name for name, p in model.named_parameters()}
    return [names[id(p)] for group in opt.param_groups for p in group["params"]]


def optimizer_state(opt: torch.optim.Adam, names: List[str]) -> dict:
    """``opt.state_dict()`` with the slots and each group's parameters keyed by
    ``names`` (``optimizer_param_names``) instead of position."""
    saved = opt.state_dict()
    return {"state": {names[i]: slots for i, slots in saved["state"].items()},
            "param_groups": [{**group, "params": [names[i] for i in group["params"]]}
                             for group in saved["param_groups"]]}


def load_optimizer(opt: torch.optim.Adam, saved: dict, names: List[str]) -> None:
    """Restore ``opt``'s slots from ``saved``, whose parameters are ``names``
    (``optimizer_param_names``): keyed by name, as ``optimizer_state`` and
    ``convert.py`` write them, or by position in ``split_params`` order, as
    files from before names were written. The saved groups must name exactly
    ``opt``'s parameters (a parameter with no slots yet, before the first
    step, has none). ``opt`` keeps its own hyperparameters, learning-rate
    form and ``capturable`` flag: a state saved by one kind of Adam resumes
    into the other, each moment on its parameter's device, Adam's step count
    on the device where ``opt`` is capturable, on the CPU where not, as
    ``torch.optim.Adam`` keeps it."""
    saved_names = [n for group in saved["param_groups"] for n in group["params"]]
    slots_by_name = saved["state"]
    if saved_names and all(isinstance(n, int) for n in saved_names):  # by position
        if sorted(saved_names) != list(range(len(names))):
            raise ValueError(f"saved Adam of {len(saved_names)} parameters does not fit one of {len(names)}")
        saved_names = [names[i] for i in saved_names]
        slots_by_name = {names[i]: slots for i, slots in slots_by_name.items()}
    missing, unexpected = sorted(set(names) - set(saved_names)), sorted(set(saved_names) - set(names))
    if missing or unexpected or len(saved_names) != len(names):
        raise ValueError(f"saved Adam does not fit the model: missing {missing}, unexpected {unexpected}")
    opt.state.clear()
    owned = [(group, p) for group in opt.param_groups for p in group["params"]]
    for name, (group, p) in zip(names, owned):
        if name not in slots_by_name:
            continue
        restored = {}
        for key, v in slots_by_name[name].items():
            if key == "step":
                device = p.device if group["capturable"] else torch.device("cpu")
                restored[key] = torch.as_tensor(v).to(device=device, dtype=torch.float32)
            elif torch.is_tensor(v):
                if v.shape != p.shape:
                    raise ValueError(f"saved Adam slot {key} of {name}: shape {tuple(v.shape)}, the parameter's "
                                     f"{tuple(p.shape)}")
                restored[key] = v.to(device=p.device, dtype=p.dtype)
            else:
                restored[key] = v
        opt.state[p] = restored


def create_train_state(model: nn.Module, seed: int, device: torch.device | str,
                       steps_per_call: int = 1) -> TrainState:
    """Initialize ``model`` from ``seed`` (on the CPU, so every device gets the
    same weights), move it to ``device`` and build the optimizers for
    ``steps_per_call``; the step noise comes from a generator on ``device``
    seeded with ``seed + 1``, on every rank alike."""
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device)
    opt_g, opt_d = make_optimizers(model, steps_per_call)
    rng = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, opt_g=opt_g, opt_d=opt_d, step=0, rng=rng)


def param_count(params) -> int:
    return sum(p.numel() for p in params)
