"""Native (C++) data-plane components, bound via ctypes.

``tfrecord.cc`` replaces the role tf.data's C++ core plays for the reference
(reference ``datasets/base_dataset.py`` sits on ``tf.data.TFRecordDataset``
+ ``tf.io.parse_single_example``): TFRecord framing with masked-CRC32C
verification and a minimal ``tf.train.Example`` wire-format parser. The
shared library is compiled with g++ on first use and cached next to the
source (rebuilt when the source is newer).

``imagecodec.cc`` (libjpeg) decodes JPEG frames without PIL — the role
``tf.image.decode_image``'s C++ kernel plays for the reference.

Public surface:
  - ``available()`` -> bool (g++ or a prebuilt .so present)
  - ``read_records(path, verify_crc=True)`` -> iterator of ``bytes``
  - ``parse_example(record)`` -> dict of feature name ->
    ``list[bytes] | np.ndarray(float32) | np.ndarray(int64)``
  - ``iter_examples(path)`` -> iterator of the same dicts via the batched
    zero-copy C boundary (the data-plane hot path; bytes values are
    memoryviews into a per-chunk buffer)
  - ``codec_available()`` / ``decode_jpeg(data)`` -> ``uint8 [H,W,3]``
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Iterator, List, Union

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tfrecord.cc")
_LIB_PATH = os.path.join(_HERE, "libtfrecord.so")
_CODEC_SRC = os.path.join(_HERE, "imagecodec.cc")
_CODEC_LIB_PATH = os.path.join(_HERE, "libimagecodec.so")

_lib = None
_codec_lib = None
_codec_failed = False
_lib_lock = threading.Lock()


def _build_lib(src: str, lib_path: str, extra_link: tuple = ()) -> str:
    """Compile a shared library (g++ -O3) if missing or stale."""
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        return lib_path
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src, *extra_link]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        raise RuntimeError(f"native build failed: {e.stderr}") from e
    os.replace(tmp, lib_path)  # atomic under concurrent builders
    return lib_path


def _build() -> str:
    return _build_lib(_SRC, _LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())

        lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tfr_open.restype = ctypes.c_void_p
        lib.tfr_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tfr_next.restype = ctypes.c_int
        lib.tfr_next_chunk.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tfr_next_chunk.restype = ctypes.c_int
        lib.tfr_error.argtypes = [ctypes.c_void_p]
        lib.tfr_error.restype = ctypes.c_char_p
        lib.tfr_close.argtypes = [ctypes.c_void_p]

        lib.tfrex_parse.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.tfrex_parse.restype = ctypes.c_void_p
        lib.tfrex_parse_view.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.tfrex_parse_view.restype = ctypes.c_void_p
        lib.tfrex_pack_sizes.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint64)
        ] * 4
        lib.tfrex_pack.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,  # base (chunk) pointer byte offsets refer to
            ctypes.c_char_p,  # keys
            ctypes.c_void_p,  # key_lens  uint64[n]
            ctypes.c_void_p,  # types     int32[n]
            ctypes.c_void_p,  # nvals     uint64[n]
            ctypes.c_void_p,  # byte_offs uint64[n_byte_items]
            ctypes.c_void_p,  # byte_lens uint64[n_byte_items]
            ctypes.c_void_p,  # floats    float32[floats_total]
            ctypes.c_void_p,  # int64s    int64[int64s_total]
        ]
        lib.tfrex_gather_sizes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,  # keys blob (concatenated, no separators)
            ctypes.c_void_p,  # key_lens uint64[nkeys]
            ctypes.c_uint64,  # nkeys
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tfrex_gather_sizes.restype = ctypes.c_int
        lib.tfrex_gather_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,  # base
            ctypes.c_void_p,  # types     int32[nkeys]
            ctypes.c_void_p,  # nvals     uint64[nkeys]
            ctypes.c_void_p,  # byte_offs
            ctypes.c_void_p,  # byte_lens
            ctypes.c_void_p,  # floats
            ctypes.c_void_p,  # int64s
        ]
        lib.tfrex_error.argtypes = [ctypes.c_void_p]
        lib.tfrex_error.restype = ctypes.c_char_p
        lib.tfrex_count.argtypes = [ctypes.c_void_p]
        lib.tfrex_count.restype = ctypes.c_uint64
        lib.tfrex_key.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.tfrex_key.restype = ctypes.c_char_p
        lib.tfrex_type.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.tfrex_type.restype = ctypes.c_int
        lib.tfrex_num_values.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.tfrex_num_values.restype = ctypes.c_uint64
        lib.tfrex_bytes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tfrex_bytes.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.tfrex_floats.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
        lib.tfrex_int64s.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)]
        lib.tfrex_free.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is usable (prebuilt, or g++ on PATH)."""
    if os.path.exists(_LIB_PATH):
        return True
    try:
        subprocess.run(["g++", "--version"], capture_output=True, check=True)
        return True
    except Exception:
        return False


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Iterate raw records of one TFRecord file (CRC-verified by default)."""
    lib = _load()
    h = lib.tfr_open(path.encode(), 1 if verify_crc else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_uint64()
        while True:
            rc = lib.tfr_next(h, ctypes.byref(data), ctypes.byref(n))
            if rc == 0:
                return
            if rc < 0:
                raise IOError(f"{path}: {lib.tfr_error(h).decode()}")
            yield ctypes.string_at(data, n.value)
    finally:
        lib.tfr_close(h)


def _iter_chunks(
    path: str, verify_crc: bool, max_records: int, max_bytes: int, copy: bool = True
):
    """Yield ``(chunk uint8 ndarray, record_lengths list)`` per reader chunk
    — ONE ctypes round-trip per ~``max_bytes`` of records.

    ``copy=False`` skips the copy out of the reader's internal buffer: the
    yielded array is a VIEW valid only until the next iteration (or the
    generator closing). Use it only when every view derived from the chunk
    is consumed before advancing — the in-repo loader's discipline."""
    lib = _load()
    h = lib.tfr_open(path.encode(), 1 if verify_crc else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        data = ctypes.POINTER(ctypes.c_uint8)()
        lens_p = ctypes.POINTER(ctypes.c_uint64)()
        count = ctypes.c_uint64()
        while True:
            rc = lib.tfr_next_chunk(
                h,
                max_records,
                max_bytes,
                ctypes.byref(data),
                ctypes.byref(lens_p),
                ctypes.byref(count),
            )
            if rc < 0:
                raise IOError(f"{path}: {lib.tfr_error(h).decode()}")
            n_rec = count.value
            if n_rec == 0:
                return
            rec_lens = np.ctypeslib.as_array(lens_p, shape=(n_rec,))
            total = int(rec_lens.sum())
            chunk = np.ctypeslib.as_array(data, shape=(total,))
            yield (chunk.copy() if copy else chunk), rec_lens.tolist()
    finally:
        lib.tfr_close(h)


class GatheredExample:
    """One example's features for a FIXED ordered key request (the
    schema-aware fast path): per-request ``types``/``nvals`` arrays, bytes
    payloads as zero-copy memoryviews (in request order), and floats/int64
    values packed in request order. Missing keys: type -1, nvals 0."""

    __slots__ = ("types", "nvals", "byte_values", "floats", "int64s")

    def __init__(self, types, nvals, byte_values, floats, int64s):
        self.types = types
        self.nvals = nvals
        self.byte_values = byte_values
        self.floats = floats
        self.int64s = int64s


def iter_gathered(
    path: str,
    keys,
    verify_crc: bool = True,
    max_records: int = 256,
    max_bytes: int = 8 << 20,
) -> Iterator[GatheredExample]:
    """Iterate :class:`GatheredExample` for a fixed ordered ``keys`` list.

    The per-example Python work drops to a handful of numpy allocations —
    key matching happens in C++ against the parse table (the role
    ``tf.io.parse_single_example``'s fixed-feature spec plays for the
    reference pipeline).

    LIFETIME: byte memoryviews point into the reader's INTERNAL chunk
    buffer (no copy at all on this path) and are valid only until the
    iterator advances past the example's chunk — consume (decode/copy)
    each example before requesting the next, as the loader does.
    ``iter_examples`` keeps the safer copied-chunk contract."""
    lib = _load()
    encoded = [k.encode() for k in keys]
    keys_blob = b"".join(encoded)
    key_lens = np.asarray([len(k) for k in encoded], np.uint64)
    nkeys = len(encoded)
    sizes = [ctypes.c_uint64() for _ in range(3)]
    for chunk, rec_lens in _iter_chunks(
        path, verify_crc, max_records, max_bytes, copy=False
    ):
        chunk_mv = memoryview(chunk)
        base = chunk.ctypes.data
        off = 0
        for rec_len in rec_lens:
            eh = lib.tfrex_parse_view(base + off, rec_len)
            try:
                err = lib.tfrex_error(eh)
                if err:
                    raise ValueError(f"bad Example proto: {err.decode()}")
                lib.tfrex_gather_sizes(
                    eh,
                    keys_blob,
                    key_lens.ctypes.data,
                    nkeys,
                    *(ctypes.byref(s) for s in sizes),
                )
                n_byte, n_float, n_int = (s.value for s in sizes)
                types = np.empty(nkeys, np.int32)
                nvals = np.empty(nkeys, np.uint64)
                boffs = np.empty(n_byte, np.uint64)
                blens = np.empty(n_byte, np.uint64)
                floats = np.empty(n_float, np.float32)
                int64s = np.empty(n_int, np.int64)
                lib.tfrex_gather_fill(
                    eh,
                    base,
                    types.ctypes.data,
                    nvals.ctypes.data,
                    boffs.ctypes.data,
                    blens.ctypes.data,
                    floats.ctypes.data,
                    int64s.ctypes.data,
                )
            finally:
                lib.tfrex_free(eh)
            byte_values = [
                chunk_mv[o:e]
                for o, e in zip(boffs.tolist(), (boffs + blens).tolist())
            ]
            yield GatheredExample(types, nvals, byte_values, floats, int64s)
            off += rec_len


def iter_examples(
    path: str,
    verify_crc: bool = True,
    max_records: int = 256,
    max_bytes: int = 8 << 20,
) -> Iterator[Dict[str, "FeatureValue"]]:
    """Fast path: iterate parsed feature dicts of one TFRecord file.

    Batches the C boundary — ONE ``tfr_next_chunk`` call per ~``max_bytes``
    of records and five calls per example (parse_view / error / count /
    pack_sizes / pack) instead of ~5 per *feature* — and decodes payloads
    zero-copy: bytes values are returned as uint8 numpy VIEWS into the
    chunk buffer (valid while referenced; numpy keeps the chunk alive via
    ``.base``), float/int64 values as numpy views of per-example arrays.
    ~4x faster than ``read_records`` + ``parse_example`` on BAIR-schema
    records; semantics match those exactly (parity-tested).
    """
    lib = _load()
    sizes = [ctypes.c_uint64() for _ in range(4)]
    for chunk, rec_lens in _iter_chunks(path, verify_crc, max_records, max_bytes):
        chunk_mv = memoryview(chunk)  # cheaper slicing than ndarray
        base = chunk.ctypes.data
        off = 0
        for rec_len in rec_lens:
            eh = lib.tfrex_parse_view(base + off, rec_len)
            try:
                err = lib.tfrex_error(eh)
                if err:
                    raise ValueError(f"bad Example proto: {err.decode()}")
                nfeat = lib.tfrex_count(eh)
                lib.tfrex_pack_sizes(eh, *(ctypes.byref(s) for s in sizes))
                keys_len, n_byte, n_float, n_int = (s.value for s in sizes)
                keys_buf = ctypes.create_string_buffer(max(keys_len, 1))
                key_lens = np.empty(nfeat, np.uint64)
                types = np.empty(nfeat, np.int32)
                nvals = np.empty(nfeat, np.uint64)
                boffs = np.empty(n_byte, np.uint64)
                blens = np.empty(n_byte, np.uint64)
                floats = np.empty(n_float, np.float32)
                int64s = np.empty(n_int, np.int64)
                lib.tfrex_pack(
                    eh,
                    base,
                    keys_buf,
                    key_lens.ctypes.data,
                    types.ctypes.data,
                    nvals.ctypes.data,
                    boffs.ctypes.data,
                    blens.ctypes.data,
                    floats.ctypes.data,
                    int64s.ctypes.data,
                )
            finally:
                lib.tfrex_free(eh)
            out: Dict[str, FeatureValue] = {}
            kp = bi = fi = ii = 0
            raw_keys = keys_buf.raw[: int(keys_len)]
            all_keys = raw_keys.decode()
            if len(all_keys) != keys_len:
                # non-ASCII key bytes: char offsets != byte offsets, so
                # slice the raw bytes per key instead (rare path)
                all_keys = None
            boffs_l = boffs.tolist()
            blens_l = blens.tolist()
            for kl, typ, nv in zip(
                key_lens.tolist(), types.tolist(), nvals.tolist()
            ):
                key = (
                    all_keys[kp : kp + kl]
                    if all_keys is not None
                    else raw_keys[kp : kp + kl].decode()
                )
                kp += kl
                if typ == 0:
                    out[key] = [
                        chunk_mv[boffs_l[bi + j] : boffs_l[bi + j] + blens_l[bi + j]]
                        for j in range(nv)
                    ]
                    bi += nv
                elif typ == 1:
                    out[key] = floats[fi : fi + nv]
                    fi += nv
                elif typ == 2:
                    out[key] = int64s[ii : ii + nv]
                    ii += nv
                # typ == -1 (empty Feature oneof): key omitted, matching
                # parse_example
            yield out
            off += rec_len


def _load_codec():
    """Bind the JPEG codec library; None when it can't build (no libjpeg)."""
    global _codec_lib, _codec_failed
    if _codec_lib is not None or _codec_failed:
        return _codec_lib
    with _lib_lock:
        if _codec_lib is not None or _codec_failed:
            return _codec_lib
        try:
            lib = ctypes.CDLL(_build_lib(_CODEC_SRC, _CODEC_LIB_PATH, ("-ljpeg",)))
        except (RuntimeError, OSError):
            _codec_failed = True
            return None
        lib.imgc_jpeg_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        lib.imgc_jpeg_decode.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.imgc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _codec_lib = lib
        return _codec_lib


def codec_available() -> bool:
    """True when the native JPEG decoder is usable on this box."""
    return _load_codec() is not None


def decode_jpeg(data) -> np.ndarray:
    """Decode JPEG bytes (or any bytes-like, e.g. the memoryviews
    ``iter_examples`` yields) to ``uint8 [H, W, 3]`` (RGB) via libjpeg.
    Zero-copy in: the C decoder only reads, so the input buffer is passed
    directly."""
    lib = _load_codec()
    if lib is None:
        raise RuntimeError("native JPEG codec unavailable (libjpeg or g++ missing)")
    arr = np.frombuffer(data, np.uint8)  # no copy for bytes/memoryview
    buf = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    p = lib.imgc_jpeg_decode(
        buf, arr.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), err, 256
    )
    if not p:
        raise ValueError(f"jpeg decode failed: {err.value.decode()}")
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(p, shape=(n,)).copy().reshape(h.value, w.value, c.value)
    finally:
        lib.imgc_free(p)
    return arr


FeatureValue = Union[List[bytes], np.ndarray]


def parse_example(record: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized ``tf.train.Example`` into a feature dict.

    bytes_list -> ``list[bytes]``; float_list -> ``np.float32[n]``;
    int64_list -> ``np.int64[n]``.
    """
    lib = _load()
    buf = (ctypes.c_uint8 * len(record)).from_buffer_copy(record)
    h = lib.tfrex_parse(buf, len(record))
    try:
        err = lib.tfrex_error(h)
        if err:
            raise ValueError(f"bad Example proto: {err.decode()}")
        out: Dict[str, FeatureValue] = {}
        for i in range(lib.tfrex_count(h)):
            key = lib.tfrex_key(h, i).decode()
            typ = lib.tfrex_type(h, i)
            nv = lib.tfrex_num_values(h, i)
            if typ == 0:
                vals = []
                ln = ctypes.c_uint64()
                for j in range(nv):
                    p = lib.tfrex_bytes(h, i, j, ctypes.byref(ln))
                    vals.append(ctypes.string_at(p, ln.value))
                out[key] = vals
            elif typ == 1:
                arr = np.empty(nv, np.float32)
                if nv:
                    lib.tfrex_floats(h, i, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                out[key] = arr
            elif typ == 2:
                arr = np.empty(nv, np.int64)
                if nv:
                    lib.tfrex_int64s(h, i, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                out[key] = arr
        return out
    finally:
        lib.tfrex_free(h)
