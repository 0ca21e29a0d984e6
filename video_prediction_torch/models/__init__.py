"""Model registry (reference ``video_prediction/models/__init__.py#
get_model_class``): name -> model class, covering the reference zoo,
``savp``, ``dna``, ``sna``, ``sv2p`` and the parameter-free baselines
``ground_truth`` and ``repeat``."""

from video_prediction_torch.models.base import (  # noqa: F401
    GroundTruthVideoPredictionModel,
    NonTrainableVideoPredictionModel,
    RepeatVideoPredictionModel,
    VideoPredictionModel,
    input_dims,
)
from video_prediction_torch.models.model_zoo import (  # noqa: F401
    DNAVideoPredictionModel,
    SAVPVideoPredictionModel,
    SNAVideoPredictionModel,
    SV2PVideoPredictionModel,
)

_MODELS = {
    "ground_truth": GroundTruthVideoPredictionModel,
    "repeat": RepeatVideoPredictionModel,
    "savp": SAVPVideoPredictionModel,
    "dna": DNAVideoPredictionModel,
    "sna": SNAVideoPredictionModel,
    "sv2p": SV2PVideoPredictionModel,
}


def get_model_class(name: str):
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODELS)}")
    return _MODELS[name]


def trainable_models() -> list:
    """The names of the models that have a train step, sorted."""
    return sorted(name for name, cls in _MODELS.items() if cls.trainable)
