"""Additional dataset variants: UCF-101, SV2P-format, Google robot push.

Reference counterparts: ``datasets/ucf101_dataset.py``,
``datasets/sv2p_dataset.py``, ``datasets/google_robot_dataset.py``.
All are thin schema configurations of ``VideoDataset`` — per-frame key
template, image shape/encoding, action/state dims, stored length.
"""

from __future__ import annotations

from video_prediction_torch.configs.hparams import DatasetHparams
from video_prediction_torch.data.base import VideoDataset


class UCF101VideoDataset(VideoDataset):
    """UCF-101 action recognition clips repurposed for prediction
    (reference ``ucf101_dataset.py``; 64x64 center-crop JPEG frames)."""

    IMAGE_KEY = "%d/image/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "jpeg"
    ACTION_KEY = None
    STATE_KEY = None
    SOURCE_SEQUENCE_LENGTH = 25

    default_hparams = DatasetHparams(
        context_frames=4,
        sequence_length=14,
        long_sequence_length=25,
    )


class SV2PVideoDataset(VideoDataset):
    """BAIR records in the tensor2tensor/SV2P schema (reference
    ``sv2p_dataset.py``): per-frame ``%d/image/encoded`` raw bytes with
    ``%d/action`` 4-D actions."""

    IMAGE_KEY = "%d/image/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "raw"
    ACTION_KEY = "%d/action"
    ACTION_DIM = 4
    STATE_KEY = None
    SOURCE_SEQUENCE_LENGTH = 30

    default_hparams = DatasetHparams(
        context_frames=2,
        sequence_length=12,
        long_sequence_length=30,
    )


class GoogleRobotVideoDataset(VideoDataset):
    """Google robot-push dataset (Finn et al. 2016; reference
    ``google_robot_dataset.py``): per-frame ``move/%d/image/encoded`` JPEG,
    5-D commanded pose actions, 5-D gripper states."""

    IMAGE_KEY = "move/%d/image/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "jpeg"
    ACTION_KEY = "move/%d/commanded_pose/vec_pitch_yaw"
    ACTION_DIM = 5
    STATE_KEY = "move/%d/endeffector/vec_pitch_yaw"
    STATE_DIM = 5
    SOURCE_SEQUENCE_LENGTH = 15

    default_hparams = DatasetHparams(
        context_frames=2,
        sequence_length=15,
        long_sequence_length=15,
        use_state=False,
    )


class CartgripperVideoDataset(VideoDataset):
    """Sawyer cart-gripper records from the visual-MPC line of work
    (reference ``cartgripper_dataset.py``, SURVEY §2.2 — tagged uncertain
    there; schema reconstructed from the visual_mpc record format and
    unverifiable against the empty reference mount: per-frame
    ``%d/image_view0/encoded`` raw bytes, 5-D actions (x, y, z, rotation,
    gripper), 6-D low-dim states). Class attrs are the single override
    point if real records differ."""

    IMAGE_KEY = "%d/image_view0/encoded"
    IMAGE_SHAPE = (48, 64, 3)
    IMAGE_ENCODING = "raw"
    ACTION_KEY = "%d/action"
    ACTION_DIM = 5
    STATE_KEY = "%d/endeffector_pos"
    STATE_DIM = 6
    SOURCE_SEQUENCE_LENGTH = 30

    default_hparams = DatasetHparams(
        context_frames=2,
        sequence_length=15,
        long_sequence_length=30,
    )
