"""TFRecord writer and ``tf.train.Example`` encoder without TensorFlow.

The counterpart of ``tf.io.TFRecordWriter`` and ``tf.train.Example(...)
.SerializeToString()``, which the JAX package's converters write through.
What it writes is what ``native/tfrecord.cc`` reads:

- TFRecord framing, each record ``uint64 length (LE) | uint32
  masked_crc32c(length) | data | uint32 masked_crc32c(data)``, with the
  masked CRC-32C (Castagnoli) that TensorFlow's ``crc32c::Mask`` computes;
- the protobuf wire format of ``Example { Features features = 1 }``,
  ``Features { map<string, Feature> feature = 1 }`` and ``Feature { oneof
  { BytesList bytes_list = 1; FloatList float_list = 2; Int64List
  int64_list = 3 } }``, float and int64 values packed as TensorFlow packs
  them.

Pure Python, numpy and the standard library: a table-driven CRC, which is
fast enough for converters and test fixtures (``chip_smoke.py`` prints the
time it takes for its records).

    with TFRecordWriter(path) as w:
        w.write(encode_example({"0/image/encoded": bytes_feature([jpeg]),
                                "0/action": float_feature([0.1, 0.2]),
                                "sequence_length": int64_feature([30])}))
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, NamedTuple, Sequence

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of ``data``."""
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data) -> int:
    """TensorFlow's masked CRC: rotate right by 15 bits, add 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data) -> bytes:
    """One TFRecord: the length, its masked CRC, the data, the data's masked CRC."""
    data = bytes(data)
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


class TFRecordWriter:
    """``tf.io.TFRecordWriter`` without TensorFlow: ``write(record)``,
    ``close()``, and a context manager that closes."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record) -> None:
        self._f.write(frame_record(record))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---- protobuf wire format ----------------------------------------------- #


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # negative int64s: ten-byte two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


class Feature(NamedTuple):
    """One encoded ``tf.train.Feature`` message."""

    encoded: bytes


def bytes_feature(values: Iterable) -> Feature:
    """``Feature(bytes_list=BytesList(value=values))``; each value bytes-like."""
    return Feature(_field(1, b"".join(_field(1, bytes(v)) for v in values)))


def float_feature(values: Sequence[float]) -> Feature:
    """``Feature(float_list=FloatList(value=values))``, values as float32."""
    packed = np.asarray(values, dtype="<f4").tobytes()
    return Feature(_field(2, _field(1, packed) if packed else b""))


def int64_feature(values: Sequence[int]) -> Feature:
    """``Feature(int64_list=Int64List(value=values))``."""
    packed = b"".join(_varint(int(v)) for v in values)
    return Feature(_field(3, _field(1, packed) if packed else b""))


def encode_example(features: Dict[str, Feature]) -> bytes:
    """``tf.train.Example(features=Features(feature=features))
    .SerializeToString()``: one map entry per feature, in the dict's order."""
    entries = b"".join(
        _field(1, _field(1, key.encode()) + _field(2, feat.encoded)) for key, feat in features.items()
    )
    return _field(1, entries)
