"""Something-Something (20BN) dataset + webm/frames -> TFRecord converter,
without TensorFlow (port of ``video_prediction_tpu/data/something.py``; the
converter writes through ``data/records.py``).

The BASELINE.json north star names "TFRecord video datasets (BAIR push,
KTH, Something-Something)" and its configs[4] is "Something-Something full
SAVP, multi-chip data-parallel with VGG-cosine eval"; the SAVP line of work
uses the 20BN Something-Something v1/v2 crowd-acted object-interaction
clips as its hardest action-free benchmark. (The dataset was a SURVEY.md
blind spot — no reference file anchor exists; the schema here follows this
repo's KTH/UCF-101 converter convention: per-frame JPEG under
``%d/image/encoded`` with fixed-length windows, so variable-length source
videos become uniform records.)

Clips are action-free (the label is a text template, not a control signal):
no action/state features, like KTH.

Converter: ``python -m video_prediction_torch.data.something <frames_root>
<out_dir>`` where ``frames_root/<video_id>/*.jpg`` are pre-extracted frames
(the 20BN v1 distribution ships exactly that layout; for v2 webm files,
extract frames first, e.g. with ffmpeg). Frames
are center-cropped to square then resized, preserving aspect ratio the way
the SAVP preprocessing does for non-square sources.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from video_prediction_torch.configs.hparams import DatasetHparams
from video_prediction_torch.data.base import VideoDataset
from video_prediction_torch.data.convert import convert_tree, convert_video_dir, list_frames
from video_prediction_torch.data.records import TFRecordWriter


class SomethingSomethingVideoDataset(VideoDataset):
    """20BN Something-Something clips as fixed-window JPEG records."""

    IMAGE_KEY = "%d/image/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "jpeg"
    ACTION_KEY = None
    STATE_KEY = None
    SOURCE_SEQUENCE_LENGTH = 16  # converter window (clips are ~30-50 frames at 12 fps)

    default_hparams = DatasetHparams(
        context_frames=2,
        sequence_length=12,
        long_sequence_length=16,
        use_state=False,
    )


# ---------------------------------------------------------------------- #
# converter
# ---------------------------------------------------------------------- #


def save_tf_record(
    out_path: str,
    video_dirs: Sequence[str],
    window: int = 16,
    size: int = 64,
    stride: int | None = None,
) -> int:
    """Write fixed-length JPEG windows from each clip's frame directory.

    Thin wrapper over the generic :func:`data.convert.convert_video_dir`
    with ``center_crop=True`` (20BN sources are non-square; crop to square
    before resize instead of distorting the aspect ratio)."""
    count = 0
    with TFRecordWriter(out_path) as writer:
        for vdir in video_dirs:
            count += convert_video_dir(
                writer,
                list_frames(vdir),
                key_template="%d/image/encoded",
                window=window,
                size=(size, size),
                stride=stride,
                center_crop=True,
            )
    return count


def partition_data(video_dirs: List[str], val_fraction: float = 0.02):
    """Deterministic train/val split by video id (the official 20BN split
    lists live in JSON label files we may not have offline; a stable split
    taking the head of the id-sorted list as val keeps the converter
    self-contained — same rule as ``data.convert.convert_tree``)."""
    n_val = max(1, int(len(video_dirs) * val_fraction)) if val_fraction > 0 else 0
    return video_dirs[n_val:], video_dirs[:n_val]


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames_root", help="dir of <video_id>/<frame>.jpg trees")
    p.add_argument("out_dir")
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--stride", type=int, default=0, help="0 -> window (non-overlapping)")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--val_fraction", type=float, default=0.02)
    args = p.parse_args()

    n1, n2 = convert_tree(
        args.frames_root,
        args.out_dir,
        key_template="%d/image/encoded",
        window=args.window,
        size=args.image_size,
        val_fraction=args.val_fraction,
        stride=args.stride or None,
        center_crop=True,
        record_prefix="something_",
    )
    print(f"wrote {n1} train / {n2} val sequences")


if __name__ == "__main__":
    main()
