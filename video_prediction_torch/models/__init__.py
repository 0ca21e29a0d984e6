"""Model registry (reference ``video_prediction/models/__init__.py#
get_model_class``). The port has ``savp``."""

from video_prediction_torch.models.base import VideoPredictionModel  # noqa: F401
from video_prediction_torch.models.model_zoo import SAVPVideoPredictionModel  # noqa: F401

_MODELS = {
    "savp": SAVPVideoPredictionModel,
}


def get_model_class(name: str):
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODELS)}")
    return _MODELS[name]
