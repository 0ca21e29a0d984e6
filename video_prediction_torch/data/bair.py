"""BAIR robot-pushing (softmotion30_44k) dataset.

Reference: ``video_prediction/datasets/softmotion_dataset.py#
SoftmotionVideoDataset`` — per-frame features ``%d/image_aux1/encoded``
(raw uint8 64x64x3), ``%d/action`` (4-D), ``%d/endeffector_pos`` (3-D),
30-frame sequences. The primary benchmark dataset.
"""

from __future__ import annotations

from video_prediction_torch.configs.hparams import DatasetHparams
from video_prediction_torch.data.base import VideoDataset


class SoftmotionVideoDataset(VideoDataset):
    IMAGE_KEY = "%d/image_aux1/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "raw"
    ACTION_KEY = "%d/action"
    ACTION_DIM = 4
    STATE_KEY = "%d/endeffector_pos"
    STATE_DIM = 3
    SOURCE_SEQUENCE_LENGTH = 30

    default_hparams = DatasetHparams(
        context_frames=2,
        sequence_length=12,
        long_sequence_length=30,
        use_state=False,
    )


# alias used by the reference registry ("bair" and "softmotion")
BAIRVideoDataset = SoftmotionVideoDataset
