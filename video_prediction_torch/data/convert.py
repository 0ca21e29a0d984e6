"""Generic raw-frames -> TFRecord converter, without TensorFlow.

Port of ``video_prediction_tpu/data/convert.py`` (the counterpart of the
reference's per-dataset ``__main__`` converter blocks: ``kth_dataset.py``,
``ucf101_dataset.py`` ...): one shared implementation that writes
fixed-length windows of JPEG frames under a per-frame key template, so any
``<root>/<video_name>/<frame>.png`` tree becomes a dataset consumable by the
``VideoDataset`` schema classes. Records go through the port's own writer
(``data/records.py``) in place of ``tf.io.TFRecordWriter``; frames through
PIL, as in the JAX package. ``tests/test_torch_data.py`` reads what both
converters write to the same examples.

CLI: ``python -m video_prediction_torch.data.convert <frames_root> <out_dir>
[--key '%d/image/encoded'] [--window 30] [--size 64] [--val_fraction 0.05]``
"""

from __future__ import annotations

import glob
import io
import os
from typing import Sequence, Tuple

from video_prediction_torch.data.records import TFRecordWriter, bytes_feature, encode_example, int64_feature


def _load_frame(path: str, size: Tuple[int, int], center_crop: bool):
    """uint8 RGB PIL image, optionally center-cropped to square first
    (aspect-preserving, the SAVP preprocessing for non-square sources)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if center_crop:
        w, h = img.size
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side))
    return img.resize(size[::-1])


def convert_video_dir(
    writer,
    frame_paths: Sequence[str],
    key_template: str = "%d/image/encoded",
    window: int = 30,
    size: Tuple[int, int] = (64, 64),
    stride: int | None = None,
    center_crop: bool = False,
) -> int:
    """Write consecutive ``window``-frame examples from one video's frames."""
    stride = stride or window
    count = 0
    for start in range(0, len(frame_paths) - window + 1, stride):
        feat = {}
        for i in range(window):
            img = _load_frame(frame_paths[start + i], size, center_crop)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=95)
            feat[key_template % i] = bytes_feature([buf.getvalue()])
        feat["sequence_length"] = int64_feature([window])
        writer.write(encode_example(feat))
        count += 1
    return count


def list_frames(video_dir: str) -> list:
    """Sorted image frame paths inside one video directory."""
    return sorted(
        glob.glob(os.path.join(video_dir, "*.png"))
        + glob.glob(os.path.join(video_dir, "*.jpg"))
        + glob.glob(os.path.join(video_dir, "*.jpeg"))
    )


def convert_tree(
    frames_root: str,
    out_dir: str,
    key_template: str = "%d/image/encoded",
    window: int = 30,
    size: int = 64,
    val_fraction: float = 0.05,
    stride: int | None = None,
    center_crop: bool = False,
    record_prefix: str = "",
) -> Tuple[int, int]:
    """Convert ``<frames_root>/<video>/*.{png,jpg}`` into train/val records.

    The val split takes the head of the id-sorted video list (deterministic
    without any external split files)."""
    video_dirs = sorted(d for d in glob.glob(os.path.join(frames_root, "*")) if os.path.isdir(d))
    if not video_dirs:
        raise FileNotFoundError(f"no video dirs under {frames_root!r}")
    n_val = max(1, int(len(video_dirs) * val_fraction)) if val_fraction > 0 else 0
    splits = {"train": video_dirs[n_val:], "val": video_dirs[:n_val]} if n_val else {"train": video_dirs}

    counts = {}
    for split, dirs in splits.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        path = os.path.join(out_dir, split, f"{record_prefix}{split}.tfrecord")
        with TFRecordWriter(path) as w:
            n = 0
            for vdir in dirs:
                frames = list_frames(vdir)
                if len(frames) >= window:
                    n += convert_video_dir(
                        w, frames, key_template, window, (size, size), stride, center_crop
                    )
            counts[split] = n
    return counts.get("train", 0), counts.get("val", 0)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames_root")
    p.add_argument("out_dir")
    p.add_argument("--key", default="%d/image/encoded")
    p.add_argument("--window", type=int, default=30)
    p.add_argument("--stride", type=int, default=0, help="0 -> window (non-overlapping)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--val_fraction", type=float, default=0.05)
    args = p.parse_args()
    n_train, n_val = convert_tree(
        args.frames_root,
        args.out_dir,
        args.key,
        args.window,
        args.size,
        args.val_fraction,
        args.stride or None,
    )
    print(f"wrote {n_train} train / {n_val} val sequences to {args.out_dir}")


if __name__ == "__main__":
    main()
