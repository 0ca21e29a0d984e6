"""Model registry (reference ``video_prediction/models/__init__.py#
get_model_class``). The port has ``savp``, ``sv2p`` and the parameter-free
baselines ``ground_truth`` and ``repeat``; ``dna`` and ``sna`` are still to
be ported (ROADMAP.md)."""

from video_prediction_torch.models.base import (  # noqa: F401
    GroundTruthVideoPredictionModel,
    NonTrainableVideoPredictionModel,
    RepeatVideoPredictionModel,
    VideoPredictionModel,
)
from video_prediction_torch.models.model_zoo import SAVPVideoPredictionModel, SV2PVideoPredictionModel  # noqa: F401

_MODELS = {
    "ground_truth": GroundTruthVideoPredictionModel,
    "repeat": RepeatVideoPredictionModel,
    "savp": SAVPVideoPredictionModel,
    "sv2p": SV2PVideoPredictionModel,
}


def get_model_class(name: str):
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODELS)}")
    return _MODELS[name]
