"""The port's TensorBoard event files (``utils/summary.py``, no TensorFlow)
against TensorFlow on the CPU: a scalar's ``Summary.Value`` is the one
``tf.summary.scalar`` writes; TensorFlow reads the train CLI's event file
(the five tags of ``tests/test_cli_e2e.py:117-149``, the scalars ``main``
returns); the GIF summary is ``tile_image_grid`` of ground truth beside the
prediction; ``--no_tensorboard`` writes nothing; the port's reader reads
TensorFlow's files and checks every CRC."""

import glob
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import tensorflow as tf
import torch

from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams, apply_overrides
from video_prediction_torch.data.synthetic import SyntheticVideoDataset
from video_prediction_torch.models import get_model_class
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_torch.train.checkpoint import load_params
from video_prediction_torch.train.step import make_eval_step
from video_prediction_torch.utils.gif import encode_gif, tile_image_grid
from video_prediction_torch.utils.summary import EventWriter, Image, read_events, scalar_value

torch.set_num_threads(1)

ZOO = Path(__file__).resolve().parent.parent / "hparams" / "bair_action_free" / "ours_savp" / "model_hparams.json"
SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4"
SEED = 4
TAGS = ("g_loss", "lr", "schedule_sampling_prob", "kl_weight", "gen_images")
MAX_STEPS, SPC, GIF_FREQ = 4, 2, 4  # two calls of two steps; the GIF at step 4


def _argv(run_dir, *extra):
    return ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL,
            "--output_dir", str(run_dir), "--max_steps", str(MAX_STEPS), "--batch_size", "2", "--device", "cpu",
            "--seed", str(SEED), "--steps_per_call", str(SPC), "--summary_freq", "1", "--progress_freq", "0",
            "--image_summary_freq", str(GIF_FREQ), "--save_freq", "0", "--eval_summary_freq", "0",
            "--accum_eval_summary_freq", "0", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("summary_run")
    summary = train_main(_argv(run_dir))
    (path,) = glob.glob(str(run_dir / "events.out.tfevents.*"))
    return run_dir, summary, path


def _tf_events(path):
    return [tf.compat.v1.Event.FromString(rec.numpy()) for rec in tf.data.TFRecordDataset(path)]


def test_tensorflow_reads_the_cli_event_file(run):
    """TensorFlow reads every record; the first event is the file version;
    the five tags are there, the scalars at each call's end (steps 2 and 4)
    and the GIF at step 4; the scalars at step 4 are ``main``'s summaries."""
    _, summary, path = run
    events = _tf_events(path)
    assert events[0].file_version == "brain.Event:2"
    steps = {}
    last = {}
    for ev in events[1:]:
        for v in ev.summary.value:
            steps.setdefault(v.tag, []).append(ev.step)
            if v.HasField("tensor"):
                last[v.tag] = float(tf.make_ndarray(v.tensor))
    assert all(tag in steps for tag in TAGS), sorted(steps)
    assert steps["g_loss"] == [2, 4] and steps["gen_images"] == [GIF_FREQ]
    assert summary["step"] == MAX_STEPS and sorted(last) == sorted(summary["summaries"])
    for tag, value in summary["summaries"].items():
        assert last[tag] == float(np.float32(value)), tag


def test_scalar_value_is_what_tf_summary_scalar_writes(tmp_path):
    """The port's scalar ``Summary.Value`` equals, field for field and byte
    for byte, the one ``tf.summary.scalar`` writes to a file in this test."""
    values = {"g_loss": 0.25, "eval/psnr": 17.53125, "lr": 2e-4}
    writer = tf.summary.create_file_writer(str(tmp_path / "tf"))
    with writer.as_default():
        for tag, v in values.items():
            tf.summary.scalar(tag, v, step=3)
    writer.flush()
    (tf_path,) = glob.glob(str(tmp_path / "tf" / "events.out.tfevents.*"))
    theirs = [ev for ev in _tf_events(tf_path) if ev.HasField("summary")]
    with EventWriter(str(tmp_path / "port")) as w:
        w.scalars(3, values)
    ours = [ev for ev in _tf_events(w.path) if ev.HasField("summary")]
    assert len(ours) == len(theirs) == len(values)
    for a, b, tag in zip(ours, theirs, values):
        assert a.step == b.step == 3
        assert a.summary.value[0] == b.summary.value[0], tag
        assert a.summary.value[0].SerializeToString() == b.summary.value[0].SerializeToString() \
            == scalar_value(tag, values[tag])


def test_gif_is_ground_truth_beside_the_prediction(run):
    """The ``gen_images`` GIF at step 4 is ``encode_gif(tile_image_grid(...))``
    of ground truth ``images[:, 1:]`` beside the prior rollout on the last
    batch of the stack fetched after the second call (stream batch 5), from
    the final parameters and the generator seeded with ``seed + 4``; its
    ``Summary.Image`` fields are the grid's shape, and it decodes to one
    frame a predicted step."""
    from PIL import Image as PILImage

    run_dir, _, path = run
    (event,) = [e for e in read_events(path) if any(tag == "gen_images" for tag, _ in e.values)]
    image = event.values[0][1]
    assert isinstance(image, Image) and event.step == GIF_FREQ
    with open(os.path.join(run_dir, "model_hparams.json")) as f:
        hp = apply_overrides(ModelHparams(), json.load(f))
    model = get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)
    load_params(str(run_dir), model)
    dhp = DatasetHparams(context_frames=hp.context_frames, sequence_length=hp.sequence_length)
    stream = SyntheticVideoDataset(mode="train", hparams=dhp, seed=SEED).make_iterator(2)
    batch = [next(stream) for _ in range(2 * SPC + SPC)][-1]  # the last of the third stack
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen, _ = make_eval_step(model)(batch, generator=torch.Generator().manual_seed(SEED + GIF_FREQ))
    side = torch.cat([batch["images"][:, 1:].float() / 255.0, gen], dim=3)
    grid = tile_image_grid(side[:8].numpy())
    assert image.encoded == encode_gif(grid, fps=4)
    assert (image.height, image.width, image.colorspace) == grid.shape[1:] == (64, 2 * 2 * 64, 3)
    gif = PILImage.open(io.BytesIO(image.encoded))
    assert gif.n_frames == hp.sequence_length - 1 and gif.size == (grid.shape[2], grid.shape[1])


def test_no_tensorboard_writes_no_event_file(tmp_path):
    summary = train_main(_argv(tmp_path, "--no_tensorboard") + ["--max_steps", "2"])
    assert summary["step"] == 2 and summary["summaries"]
    assert not glob.glob(str(tmp_path / "events.out.tfevents.*"))


def test_port_reader_reads_tensorflow_files_and_checks_crcs(tmp_path):
    """``read_events`` reads what TensorFlow writes (scalars and a raw
    ``Summary.Image``), reads its own files back, takes another name when
    one is taken, and refuses a file with a flipped byte."""
    writer = tf.summary.create_file_writer(str(tmp_path / "tf"))
    with writer.as_default():
        tf.summary.scalar("g_loss", 1.5, step=7)
        img = tf.compat.v1.Summary.Image(height=2, width=3, colorspace=3, encoded_image_string=b"GIF89a")
        raw = tf.compat.v1.Summary(value=[tf.compat.v1.Summary.Value(tag="gen_images", image=img)])
        tf.summary.experimental.write_raw_pb(raw.SerializeToString(), step=8)
    writer.flush()
    (tf_path,) = glob.glob(str(tmp_path / "tf" / "events.out.tfevents.*"))
    events = read_events(tf_path)
    assert events[0].file_version == "brain.Event:2"
    assert [(e.step, e.values) for e in events[1:]] == [(7, [("g_loss", 1.5)]),
                                                      (8, [("gen_images", Image(2, 3, 3, b"GIF89a"))])]
    with EventWriter(str(tmp_path / "port")) as w, EventWriter(str(tmp_path / "port")) as w2:
        w.scalars(1, {"a": 0.5, "b": -2.0})
        w.image(2, "gen_images", b"GIF89a", 2, 3, 3)
    assert w2.path != w.path and os.path.exists(w2.path)
    assert [(e.step, e.values) for e in read_events(w.path)[1:]] == [
        (1, [("a", 0.5)]), (1, [("b", -2.0)]), (2, [("gen_images", Image(2, 3, 3, b"GIF89a"))])]
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 0xFF
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(data))
    with pytest.raises(OSError):  # the native reader checks every CRC
        read_events(str(bad))
