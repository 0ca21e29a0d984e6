"""Dataset registry (reference ``video_prediction/datasets/__init__.py#
get_dataset_class``): ``bair``/``softmotion``, ``kth``, ``ucf101``,
``sv2p``, ``google_robot``, ``cartgripper``, ``something``
(Something-Something), plus the file-free ``synthetic``, as in
``video_prediction_tpu/data/__init__.py``. The TFRecord datasets read
through the native backend only (``data/base.py``); ``DeviceFeeder``
(``data/loader.py``) carries host batches to the device."""

from video_prediction_torch.data.bair import SoftmotionVideoDataset  # noqa: F401
from video_prediction_torch.data.base import BaseVideoDataset, VideoDataset  # noqa: F401
from video_prediction_torch.data.kth import KTHVideoDataset  # noqa: F401
from video_prediction_torch.data.loader import DeviceFeeder  # noqa: F401
from video_prediction_torch.data.something import SomethingSomethingVideoDataset  # noqa: F401
from video_prediction_torch.data.synthetic import SyntheticVideoDataset  # noqa: F401
from video_prediction_torch.data.variants import (  # noqa: F401
    CartgripperVideoDataset,
    GoogleRobotVideoDataset,
    SV2PVideoDataset,
    UCF101VideoDataset,
)

_DATASETS = {
    "bair": SoftmotionVideoDataset,
    "softmotion": SoftmotionVideoDataset,
    "kth": KTHVideoDataset,
    "ucf101": UCF101VideoDataset,
    "sv2p": SV2PVideoDataset,
    "google_robot": GoogleRobotVideoDataset,
    "cartgripper": CartgripperVideoDataset,
    "something": SomethingSomethingVideoDataset,
    "synthetic": SyntheticVideoDataset,
}


def get_dataset_class(name: str):
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(_DATASETS)}")
    return _DATASETS[name]


def register_dataset(name: str, cls) -> None:
    _DATASETS[name] = cls
