"""Each model's own parts of the yardstick, found by the configuration's
``model``: ``benchmark/models/<model>.py``. A kind (``benchmark/kinds/``)
calls only these names of it, so a configuration of a new model enters with
that file (and the plain reference it wraps, under ``benchmark/reference/``)
and edits nothing that is here:

- ``train_steps(weights, hp, batches, noises)``: the plain reference's
  training steps from the benchmark's weights by name (``program.build_model``),
  one host batch a step as the program takes it (uint8 ``images``, and
  ``actions`` and ``states`` where the configuration has them) and one
  noise dict a step (``kinds/train.py#draw_noise``); a dict with each
  step's ``losses`` (``g_loss``, ``d_loss``), each leaf's first gradient
  norm (``grad_norms``) and change norm (``change_norms``), and the first
  step's rollout (``first_frames``), as ``kinds/train.py`` compares them;
- ``eval_rollout(weights, hp, batch, zs)``: the reference's prior rollout of
  ``batch`` (``images`` float in [0, 1]) with the prior draws ``zs``;
- ``train_step_flops(hp, b, t, h, w, c)``, ``rollout_flops(hp, samples, t,
  h, w, c)``: model FLOPs of a train step and of a rollout;
- ``kernel_bytes(hp, batch, h, w, c, backward)``, ``kernel_events(hp, h, w,
  backward)``: one generator step's K1-K3 bytes and device events.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

from benchmark import common


def find(cfg: Dict) -> ModuleType:
    """The module of the configuration's model; exits, naming the file it
    looked for, where there is none."""
    name = cfg["model"]
    path = common.BENCH_DIR / "models" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"configuration {cfg.get('name')!r} runs model {name!r}, which has no "
                         f"{path.relative_to(common.ROOT)} (its plain reference and work counts)")
    return importlib.import_module(f"benchmark.models.{name}")
