"""KTH human-actions dataset + raw-frames -> TFRecord converter, without
TensorFlow (port of ``video_prediction_tpu/data/kth.py``; the converter
writes through ``data/records.py``).

Reference: ``video_prediction/datasets/kth_dataset.py#KTHVideoDataset`` and
its ``__main__`` converter (persons 1-16 train / 17-25 test, ffmpeg frame
extraction upstream). Our records store per-frame JPEG under
``%d/image/encoded`` with a ``sequence_length`` int64 context feature;
variable-length source videos are written in fixed windows of
``SOURCE_SEQUENCE_LENGTH`` frames.

Converter: ``python -m video_prediction_torch.data.kth <frames_root> <out_dir>``
where ``frames_root/<video_name>/*.png|jpg`` are pre-extracted frames
(PIL-based; no ffmpeg dependency).
"""

from __future__ import annotations

import glob
import os
from typing import List

from video_prediction_torch.configs.hparams import DatasetHparams
from video_prediction_torch.data.base import VideoDataset
from video_prediction_torch.data.records import TFRecordWriter, bytes_feature, encode_example, int64_feature


class KTHVideoDataset(VideoDataset):
    IMAGE_KEY = "%d/image/encoded"
    IMAGE_SHAPE = (64, 64, 3)
    IMAGE_ENCODING = "jpeg"
    ACTION_KEY = None
    STATE_KEY = None
    SOURCE_SEQUENCE_LENGTH = 30

    default_hparams = DatasetHparams(
        context_frames=10,
        sequence_length=20,
        long_sequence_length=40,
        use_state=False,
    )


# ---------------------------------------------------------------------- #
# converter
# ---------------------------------------------------------------------- #

TRAIN_PERSONS = list(range(1, 17))  # reference partition: 1-16 train
TEST_PERSONS = list(range(17, 26))  # 17-25 test


def partition_data(video_dirs: List[str]):
    """Split video dirs by KTH person id embedded in the name
    (``person01_boxing_d1`` ...). Reference ``kth_dataset.py#partition_data``."""
    train, test = [], []
    for d in video_dirs:
        name = os.path.basename(d)
        try:
            pid = int(name.split("_")[0].replace("person", ""))
        except ValueError:
            pid = -1
        (train if pid in TRAIN_PERSONS else test).append(d)
    return train, test


def save_tf_record(out_path: str, video_dirs: List[str], window: int = 30, size=(64, 64)):
    """Write fixed-length JPEG-frame windows from each video directory.

    ``size=None`` stores frames at their native resolution (KTH: 120x160);
    the dataset's ``scale_size``/``crop_size`` hparams then pick the model
    resolution at read time (64 or 128px, reference-style).
    """
    import io

    from PIL import Image

    count = 0
    with TFRecordWriter(out_path) as writer:
        for vdir in video_dirs:
            frames = sorted(
                glob.glob(os.path.join(vdir, "*.png"))
                + glob.glob(os.path.join(vdir, "*.jpg"))
                + glob.glob(os.path.join(vdir, "*.jpeg"))
            )
            for start in range(0, len(frames) - window + 1, window):
                feat = {}
                for i in range(window):
                    img = Image.open(frames[start + i]).convert("RGB")
                    if size is not None:
                        img = img.resize(size[::-1])
                    buf = io.BytesIO()
                    img.save(buf, format="JPEG", quality=95)
                    feat[f"{i}/image/encoded"] = bytes_feature([buf.getvalue()])
                feat["sequence_length"] = int64_feature([window])
                writer.write(encode_example(feat))
                count += 1
    return count


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames_root", help="dir of <video_name>/<frame>.png trees")
    p.add_argument("out_dir")
    p.add_argument("--window", type=int, default=30)
    p.add_argument(
        "--image_size",
        type=int,
        default=64,
        help="square size baked into the records; 0 stores native resolution "
        "(use dataset hparams scale_size/crop_size to pick 64/128 at read time)",
    )
    args = p.parse_args()

    size = (args.image_size, args.image_size) if args.image_size else None
    video_dirs = sorted(d for d in glob.glob(os.path.join(args.frames_root, "*")) if os.path.isdir(d))
    train, test = partition_data(video_dirs)
    os.makedirs(os.path.join(args.out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(args.out_dir, "test"), exist_ok=True)
    n1 = save_tf_record(os.path.join(args.out_dir, "train", "kth_train.tfrecord"), train, args.window, size)
    n2 = save_tf_record(os.path.join(args.out_dir, "test", "kth_test.tfrecord"), test, args.window, size)
    print(f"wrote {n1} train / {n2} test sequences")


if __name__ == "__main__":
    main()
