"""TensorBoard event files without TensorFlow: a writer and a reader.

The counterpart of the JAX CLI's ``tf.summary.create_file_writer`` and
``tf.summary.scalar`` / ``write_raw_pb`` (``scripts/train.py:204-234``).
``EventWriter(logdir)`` writes ``logdir/events.out.tfevents.<time>.<host>``
(a suffix ``.1``, ``.2``, ... where that name is taken):

- TFRecord framing, ``data/records.py#frame_record`` (masked CRC-32C);
- the protobuf wire format of ``Event { double wall_time = 1; int64 step =
  2; oneof { string file_version = 3; Summary summary = 5 } }``, the first
  event ``file_version: "brain.Event:2"``;
- a scalar as TensorFlow 2's ``tf.summary.scalar`` writes it, one event a
  value: ``Summary.Value { tag = 1; TensorProto tensor = 8 { dtype = 1:
  DT_FLOAT; tensor_shape = 2: {}; tensor_content = 4: the float32, little
  endian }; SummaryMetadata metadata = 9 { plugin_data = 1 { plugin_name =
  1: "scalars" } } }``;
- an image as ``Summary.Value { tag = 1; Summary.Image image = 4 { height =
  1; width = 2; colorspace = 3; encoded_image_string = 4 } }``, what the
  JAX CLI's GIF summary writes.

``read_events(path)`` reads such a file back through the native TFRecord
reader (``native.read_records``, every CRC checked): the scalars
(``tensor_content``, ``float_val`` or ``simple_value``) and the images of
each event.

    with EventWriter(run_dir) as w:
        w.scalars(step, {"g_loss": 0.25, "lr": 2e-4})
        w.image(step, "gen_images", gif_bytes, height, width, 3)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, NamedTuple, Tuple, Union

from video_prediction_torch.data.records import _field, _varint, frame_record
from video_prediction_torch.native import read_records

FILE_VERSION = "brain.Event:2"
DT_FLOAT = 1


class Image(NamedTuple):
    height: int
    width: int
    colorspace: int
    encoded: bytes


class Event(NamedTuple):
    wall_time: float
    step: int
    file_version: str
    values: List[Tuple[str, Union[float, Image]]]  # (tag, scalar) or (tag, image)


# ---- encoding ------------------------------------------------------------ #


def _int_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _event(summary: bytes = b"", step: int = 0, file_version: str = "") -> bytes:
    out = _varint(1 << 3 | 1) + struct.pack("<d", time.time())
    if step:
        out += _int_field(2, step)
    if file_version:
        out += _field(3, file_version.encode())
    if summary:
        out += _field(5, summary)
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """The ``Summary.Value`` of one scalar, as ``tf.summary.scalar`` encodes it."""
    tensor = _int_field(1, DT_FLOAT) + _field(2, b"") + _field(4, struct.pack("<f", value))
    metadata = _field(1, _field(1, b"scalars"))
    return _field(1, tag.encode()) + _field(8, tensor) + _field(9, metadata)


def image_value(tag: str, encoded: bytes, height: int, width: int, colorspace: int) -> bytes:
    """The ``Summary.Value`` of one encoded image (a GIF, here)."""
    image = _int_field(1, height) + _int_field(2, width) + _int_field(3, colorspace) + _field(4, encoded)
    return _field(1, tag.encode()) + _field(4, image)


class EventWriter:
    """An event file under ``logdir``; ``close()`` (or the context manager)
    closes it. Each ``scalars``/``image`` call is flushed to the file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        base = os.path.join(logdir, f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}")
        self.path, n = base, 0
        while True:
            try:
                self._f = open(self.path, "xb")
                break
            except FileExistsError:
                n += 1
                self.path = f"{base}.{n}"
        self._write(_event(file_version=FILE_VERSION))

    def _write(self, *events: bytes) -> None:
        self._f.write(b"".join(frame_record(e) for e in events))
        self._f.flush()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        self._write(*(_event(_field(1, scalar_value(tag, float(v))), step) for tag, v in values.items()))

    def image(self, step: int, tag: str, encoded: bytes, height: int, width: int, colorspace: int) -> None:
        self._write(_event(_field(1, image_value(tag, encoded, height, width, colorspace)), step))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---- decoding ------------------------------------------------------------ #


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, Union[int, bytes]]]:
    """(field number, value) of a message: varints as ints, the rest as bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos : pos + length], pos + length
        elif wire == 5:
            value, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def _tensor_scalar(buf: bytes) -> float:
    content = [v for n, v in _fields(buf) if n in (4, 5)]
    if not content or len(content[0]) != 4:
        raise ValueError("summary tensor is not one float32")
    return struct.unpack("<f", content[0])[0]


def _value(buf: bytes) -> Tuple[str, Union[float, Image, None]]:
    tag, value = "", None
    for n, v in _fields(buf):
        if n == 1:
            tag = v.decode()
        elif n == 2:
            value = struct.unpack("<f", v)[0]
        elif n == 4:
            f = dict(_fields(v))
            value = Image(f.get(1, 0), f.get(2, 0), f.get(3, 0), f.get(4, b""))
        elif n == 8:
            value = _tensor_scalar(v)
    return tag, value


def read_events(path: str) -> List[Event]:
    """Every event of the event file ``path``, in order."""
    events = []
    for record in read_records(path):
        wall_time, step, version, values = 0.0, 0, "", []
        for n, v in _fields(record):
            if n == 1:
                wall_time = struct.unpack("<d", v)[0]
            elif n == 2:
                step = v
            elif n == 3:
                version = v.decode()
            elif n == 5:
                values += [_value(value) for number, value in _fields(v) if number == 1]
        events.append(Event(wall_time, step, version, values))
    return events
