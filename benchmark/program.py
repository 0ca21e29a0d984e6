"""The system under test, built as every kind of cell builds it: the port's
model class from the configuration's hparams, filled with the benchmark's
weights; the VGG16 metric with its seeded weights; the host batches and
their copy to the device as the port's CLIs make it. The port is imported
inside the functions, so that a look at this module loads none of it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark import common


def hparams(cfg: Dict, overrides: Dict = None):
    """The port's ``ModelHparams`` of the configuration (its whole hparams
    dict, frozen in its file), with the hparams among ``overrides`` (test
    sizes) on top."""
    from video_prediction_torch.configs.hparams import ModelHparams, apply_overrides

    mine = {k: v for k, v in (overrides or {}).items() if k in cfg["hparams"]}
    return apply_overrides(ModelHparams(), dict(cfg["hparams"], **mine))


def build_model(cfg: Dict, hp, image_shape, seed: int, device) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """The configuration's model, at its ``action_dim`` and ``state_dim``
    (0 where it states none), on ``device`` with weights drawn from ``seed``
    (``common.make_weights``); returns it and those weights by name
    (parameters and spectral ``u`` vectors), which the reference is given."""
    from video_prediction_torch.models import get_model_class

    model = get_model_class(cfg["model"])(hp, image_shape=tuple(image_shape), action_dim=cfg.get("action_dim", 0),
                                          state_dim=cfg.get("state_dim", 0))
    model.to(device)
    state = model.state_dict()
    weights = common.make_weights({k: tuple(v.shape) for k, v in state.items()}, common.generator(seed, 0, device),
                                  device)
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(weights[k])
    return model, weights


def vgg_metric(seed: int, device):
    """The port's VGG16 cosine metric (``models/vgg.py``) with the benchmark's
    VGG16 weights, drawn from ``seed``; and those weights by name."""
    from video_prediction_torch.models.vgg import VGGMetric

    metric = VGGMetric(allow_random=True, device=device)
    state = metric.module.state_dict()
    weights = common.make_weights({k: tuple(v.shape) for k, v in state.items()}, common.generator(seed, 5, device),
                                  device, rule=common.he_rule)
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(weights[k])
    return metric, weights


def host_batches(pool: Dict, batch: int):
    """An endless iterator of host batches of ``batch`` clips cycling through
    ``pool`` (``common.make_inputs``), under the keys the port's loaders
    use: ``images [batch, T, H, W, C]``, and ``actions`` and ``states``
    where the pool has them."""
    n = len(pool["images"]) // batch
    i = 0
    while True:
        yield common.rows_of(pool, slice((i % n) * batch, (i % n + 1) * batch))
        i += 1


def batch_to_device(batch, device):
    from video_prediction_torch.generate import batch_to_device as to_device

    return to_device(batch, device)
