"""The port's TFRecord data plane against the JAX package's native backend,
on the CPU: for each TFRecord schema of the registry, the port's batches
equal the JAX pipeline's byte for byte at the same seed in every mode
(``train``: file shuffle, random offsets with ``time_shift=2``, the shuffle
buffer; ``val`` with and without ``shuffle_on_val``; ``test``), and in
``test`` mode the JAX tf.data backend's; KTH cropped and scaled from its
native 120x160; the same errors; the record count; pooled decode; and
``DeviceFeeder`` on the CPU.

Records are written here by TensorFlow (``tf.io.TFRecordWriter``,
``tf.train.Example``), JPEG frames by PIL, independently of the port's own
writer (``tests/test_torch_native.py`` holds that)."""

import io
import threading

import numpy as np
import pytest
import torch

from video_prediction_torch.configs.hparams import DatasetHparams as TDH
from video_prediction_torch.data import DeviceFeeder
from video_prediction_torch.data import get_dataset_class as t_get
from video_prediction_torch.data.native_loader import NativeVideoPipeline
from video_prediction_tpu.configs.hparams import DatasetHparams as JDH
from video_prediction_tpu.data import get_dataset_class as j_get

tf = pytest.importorskip("tensorflow")

torch.set_num_threads(1)

# the seven TFRecord schema classes; ``softmotion`` is ``bair``'s class
SCHEMAS = ["bair", "kth", "something", "ucf101", "sv2p", "google_robot", "cartgripper"]
SMALL_SHAPE = {"cartgripper": (6, 8, 3)}  # non-square, as the class's 48x64
MODES = [("train", False), ("val", False), ("val", True), ("test", False)]
RECORDS_PER_FILE = (5, 4)  # two files of unequal length: the file shuffle shows
BATCH, N_BATCHES, SEED = 3, 3, 11


def _feature(kind, values):
    if kind == "bytes":
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
    if kind == "float":
        return tf.train.Feature(float_list=tf.train.FloatList(value=values))
    return tf.train.Feature(int64_list=tf.train.Int64List(value=values))


def write_tf_records(path, examples):
    """``examples``: dicts of key -> (kind, values), written by TensorFlow."""
    with tf.io.TFRecordWriter(str(path)) as w:
        for ex in examples:
            feats = {k: _feature(kind, list(v)) for k, (kind, v) in ex.items()}
            w.write(tf.train.Example(features=tf.train.Features(feature=feats)).SerializeToString())


def _jpeg(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _frames(rng, n, shape):
    """``n`` frames of a square moving over a gradient, with sensor noise."""
    h, w, c = shape
    base = np.linspace(0, 160, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
    y0, x0 = rng.randint(0, max(1, h // 2)), rng.randint(0, max(1, w // 2))
    out = []
    for t in range(n):
        img = np.broadcast_to(base, shape).copy()
        y, x = (y0 + t) % h, (x0 + 2 * t) % w
        img[y : y + max(1, h // 4), x : x + max(1, w // 4)] = 250.0
        out.append(np.clip(img + rng.randint(0, 8, shape), 0, 255).astype(np.uint8))
    return out


def schema_examples(cls, n, shape, seed):
    """``n`` records of ``cls``'s schema: its frame key and encoding, its
    action and state keys and dims, its stored length; the truth frames."""
    rng = np.random.RandomState(seed)
    examples, truth = [], []
    for _ in range(n):
        frames = _frames(rng, cls.SOURCE_SEQUENCE_LENGTH, shape)
        ex = {}
        for i, img in enumerate(frames):
            ex[cls.IMAGE_KEY % i] = ("bytes", [img.tobytes() if cls.IMAGE_ENCODING == "raw" else _jpeg(img)])
            if cls.ACTION_KEY:
                ex[cls.ACTION_KEY % i] = ("float", rng.rand(cls.ACTION_DIM).astype(np.float32))
            if cls.STATE_KEY:
                ex[cls.STATE_KEY % i] = ("float", rng.rand(cls.STATE_DIM).astype(np.float32))
        ex["sequence_length"] = ("int64", [cls.SOURCE_SEQUENCE_LENGTH])
        examples.append(ex)
        truth.append(np.stack(frames))
    return examples, truth


def small(cls, shape):
    return type(f"Small{cls.__name__}", (cls,), {"IMAGE_SHAPE": shape})


@pytest.fixture(scope="module")
def schema_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("schemas")
    dirs = {}
    for k, name in enumerate(SCHEMAS):
        cls = j_get(name)
        d = root / name
        d.mkdir()
        shape = SMALL_SHAPE.get(name, (8, 8, 3))
        for f, n in enumerate(RECORDS_PER_FILE):
            write_tf_records(d / f"{name}_{f}.tfrecord", schema_examples(cls, n, shape, seed=100 * k + f)[0])
        dirs[name] = str(d)
    return dirs


def _pair(name, d, mode, shuffle_on_val=False, use_state=True, seed=SEED, **hp):
    """The port's and the JAX package's dataset of ``name`` on ``d``."""
    shape = SMALL_SHAPE.get(name, (8, 8, 3))
    tcls, jcls = small(t_get(name), shape), small(j_get(name), shape)
    stored = tcls.SOURCE_SEQUENCE_LENGTH
    kw = dict(sequence_length=stored // 2 + 1, time_shift=2, use_state=use_state, shuffle_on_val=shuffle_on_val)
    kw.update(hp)
    return (tcls(d, mode=mode, hparams=TDH(**kw), seed=seed), jcls(d, mode=mode, hparams=JDH(**kw), seed=seed))


def assert_batches_equal(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


@pytest.mark.parametrize("mode,shuffle_on_val", MODES, ids=["train", "val", "val_shuffled", "test"])
@pytest.mark.parametrize("name", SCHEMAS)
def test_batches_equal_the_jax_native_pipeline(name, mode, shuffle_on_val, schema_dirs):
    tds, jds = _pair(name, schema_dirs[name], mode, shuffle_on_val)
    tit, jit = tds.make_iterator(BATCH), jds.make_iterator(BATCH, backend="native")
    for i in range(N_BATCHES):
        tb, jb = next(tit), next(jit)
        assert_batches_equal(tb, jb, f"{name} {mode} batch {i}")
    assert tb["images"].dtype == np.uint8
    assert tb["images"].shape == (BATCH, tds.hparams.sequence_length, *tds.IMAGE_SHAPE)
    has_actions = bool(tds.ACTION_KEY)
    assert ("actions" in tb) == has_actions and ("states" in tb) == bool(tds.STATE_KEY)
    if has_actions:
        assert tb["actions"].shape == (BATCH, tds.hparams.sequence_length, tds.ACTION_DIM)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_bair_without_state_equals_jax(mode, schema_dirs):
    tds, jds = _pair("bair", schema_dirs["bair"], mode, use_state=False)
    tb, jb = next(tds.make_iterator(BATCH)), next(jds.make_iterator(BATCH, backend="native"))
    assert sorted(tb) == ["images"]
    assert_batches_equal(tb, jb)


def _decoded_records(ds, decode):
    """Every record of ``ds`` in file order, its frames decoded by ``decode``."""
    from video_prediction_torch import native

    out = []
    for f in ds.filenames:
        for rec in native.read_records(f):
            feats = native.parse_example(rec)
            out.append(np.stack([decode(feats[ds.IMAGE_KEY % i][0]) for i in range(ds.SOURCE_SEQUENCE_LENGTH)]))
    return out


@pytest.mark.parametrize("name", SCHEMAS)
def test_test_mode_equals_the_jax_tf_backend(name, schema_dirs):
    """Raw schemas byte for byte. JPEG schemas decode by two libraries:
    TensorFlow's ``decode_image`` in the JAX package's tf.data backend,
    libjpeg (or PIL, which gives the same bytes) in its native backend and
    the port. So there each batch is held to the same records and frames:
    the port's images equal the native decode of the frames, the tf.data
    images TensorFlow's decode of the same frames, and every other array
    is equal byte for byte."""
    tds, jds = _pair(name, schema_dirs[name], "test")
    tit, jit = tds.make_iterator(BATCH), jds.make_iterator(BATCH, backend="tf")
    seq = tds.hparams.sequence_length
    if tds.IMAGE_ENCODING != "raw":
        from video_prediction_torch import native
        from video_prediction_torch.data.base import _pil_decode

        mine = _decoded_records(tds, native.decode_jpeg if native.codec_available() else _pil_decode)
        theirs = _decoded_records(tds, lambda raw: tf.image.decode_image(raw, channels=3).numpy())
    for i in range(2):
        tb, jb = next(tit), next(jit)
        if tds.IMAGE_ENCODING == "raw":
            assert_batches_equal(tb, jb, f"{name} batch {i}")
            continue
        assert_batches_equal({k: v for k, v in tb.items() if k != "images"},
                             {k: v for k, v in jb.items() if k != "images"})
        idx = [(i * BATCH + j) % len(mine) for j in range(BATCH)]
        np.testing.assert_array_equal(tb["images"], np.stack([mine[r][:seq] for r in idx]))
        np.testing.assert_array_equal(jb["images"], np.stack([theirs[r][:seq] for r in idx]))


def test_native_decode_equals_pil(schema_dirs):
    """The port decodes JPEG with libjpeg where it links and with PIL where it
    does not (``data/base.py#_pil_decode``): the same bytes either way."""
    from video_prediction_torch import native
    from video_prediction_torch.data.base import _pil_decode

    if not native.codec_available():
        pytest.skip("libjpeg does not link here: the port decodes with PIL only")
    cls = small(t_get("kth"), (8, 8, 3))(schema_dirs["kth"])
    for a, b in zip(_decoded_records(cls, native.decode_jpeg), _decoded_records(cls, _pil_decode)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["test", "val"])
def test_kth_crop_and_scale_from_its_native_size(mode, tmp_path):
    """KTH stored at 120x160, read at 64 px with ``crop_size=120,scale_size=64``
    (as ``tests/test_data.py`` reads it)."""
    cls = j_get("kth")
    write_tf_records(tmp_path / "kth.tfrecord", schema_examples(cls, 3, (120, 160, 3), seed=5)[0])
    kw = dict(sequence_length=20, crop_size=120, scale_size=64)
    tds = t_get("kth")(str(tmp_path), mode=mode, hparams=TDH(**kw), seed=SEED)
    jds = cls(str(tmp_path), mode=mode, hparams=JDH(**kw), seed=SEED)
    tb = next(tds.make_iterator(2))
    assert tb["images"].shape == (2, 20, 64, 64, 3)
    assert_batches_equal(tb, next(jds.make_iterator(2, backend="native")))


def test_test_mode_reads_the_records_in_order(schema_dirs):
    """Against the truth frames: ``test`` reads file after file, record after
    record, each from frame 0."""
    cls = small(t_get("sv2p"), (8, 8, 3))
    truth = []
    for f, n in enumerate(RECORDS_PER_FILE):
        truth += schema_examples(j_get("sv2p"), n, (8, 8, 3), seed=100 * SCHEMAS.index("sv2p") + f)[1]
    ds = cls(schema_dirs["sv2p"], mode="test", hparams=TDH(sequence_length=12))
    it = ds.make_iterator(3)
    got = np.concatenate([next(it)["images"] for _ in range(4)])
    want = np.stack([truth[i % len(truth)][:12] for i in range(12)])
    np.testing.assert_array_equal(got, want)


# ---- the same errors ------------------------------------------------------ #


def _first_error(ds, **kw):
    with pytest.raises(Exception) as info:
        next(ds.make_iterator(2, **kw))
    return info.value


def _assert_same_error(tds, jds):
    te, je = _first_error(tds), _first_error(jds, backend="native")
    assert type(te) is type(je) and str(te) == str(je), (te, je)
    return te


def test_no_records_raise_alike(tmp_path):
    te = _assert_same_error(*_pair("bair", str(tmp_path), "train"))
    assert isinstance(te, FileNotFoundError)


def test_sequence_longer_than_stored_raises_alike(schema_dirs):
    te = _assert_same_error(*_pair("bair", schema_dirs["bair"], "test", sequence_length=31))
    assert isinstance(te, ValueError) and "31 > stored length 30" in str(te)


@pytest.mark.parametrize("use_state", [False, True])
def test_two_payloads_under_one_frame_key_raise_alike(use_state, tmp_path):
    ex, _ = schema_examples(j_get("bair"), 1, (8, 8, 3), seed=0)
    key = "3/image_aux1/encoded"
    ex[0][key] = ("bytes", ex[0][key][1] * 2)
    write_tf_records(tmp_path / "bad.tfrecord", ex)
    te = _assert_same_error(*_pair("bair", str(tmp_path), "test", use_state=use_state))
    assert isinstance(te, ValueError)


def test_corrupted_crc_raises_alike(tmp_path, schema_dirs):
    src = t_get("bair")(schema_dirs["bair"]).filenames[0]
    data = bytearray(open(src, "rb").read())
    data[100] ^= 0xFF  # inside the first record's data
    (tmp_path / "bad.tfrecord").write_bytes(bytes(data))
    te = _assert_same_error(*_pair("bair", str(tmp_path), "test"))
    assert isinstance(te, OSError) and "crc" in str(te).lower()


def test_the_tf_backend_is_refused(schema_dirs, monkeypatch):
    ds = small(t_get("bair"), (8, 8, 3))(schema_dirs["bair"], mode="test")
    with pytest.raises(ValueError, match="no tf.data backend"):
        next(ds.make_iterator(2, backend="tf"))
    monkeypatch.setenv("VP_DATA_BACKEND", "tf")
    with pytest.raises(ValueError, match="no tf.data backend"):
        next(ds.make_iterator(2))
    with pytest.raises(ValueError, match="no tf.data backend"):
        next(ds.make_iterator(2, backend="tf"))
    monkeypatch.setenv("VP_DATA_BACKEND", "native")
    assert next(ds.make_iterator(2))["images"].dtype == np.uint8
    with pytest.raises(ValueError, match="unknown data backend"):
        next(ds.make_iterator(2, backend="xla"))
    for method, args in (("parser", (b"",)), ("preprocess_images", (None,)), ("_slice_sequences", ({},)),
                         ("make_dataset", (2,)), ("make_batch", (2,))):
        with pytest.raises(NotImplementedError, match="native"):
            getattr(ds, method)(*args)


# ---- other pipeline checks ------------------------------------------------- #


@pytest.mark.parametrize("name", SCHEMAS)
def test_num_examples_per_epoch_equal(name, schema_dirs):
    tds, jds = _pair(name, schema_dirs[name], "test")
    assert tds.num_examples_per_epoch() == jds.num_examples_per_epoch() == sum(RECORDS_PER_FILE)


@pytest.mark.parametrize("name", ["kth", "bair"])
def test_pooled_decode_equals_serial(name, schema_dirs, monkeypatch):
    tds, _ = _pair(name, schema_dirs[name], "train")
    serial = next(tds.make_iterator(BATCH))
    monkeypatch.setenv("VP_DATA_DECODE_WORKERS", "2")
    pooled = next(_pair(name, schema_dirs[name], "train")[0].make_iterator(BATCH))
    assert_batches_equal(pooled, serial)


def test_the_stream_is_the_pipelines(schema_dirs):
    """``make_iterator`` is ``NativeVideoPipeline``'s stream, with the JAX
    package's shuffle buffer and prefetch depth."""
    assert (NativeVideoPipeline.SHUFFLE_BUFFER, NativeVideoPipeline.PREFETCH_BATCHES) == (1024, 4)
    tds, _ = _pair("sv2p", schema_dirs["sv2p"], "train")
    assert_batches_equal(next(iter(NativeVideoPipeline(tds, BATCH))), next(tds.make_iterator(BATCH)))


# ---- DeviceFeeder on the CPU ----------------------------------------------- #


def test_feeder_hands_over_the_host_batches(schema_dirs):
    tds, _ = _pair("bair", schema_dirs["bair"], "train")
    host = tds.make_iterator(BATCH)
    want = [next(host) for _ in range(4)]
    feeder = DeviceFeeder(_pair("bair", schema_dirs["bair"], "train")[0].make_iterator(BATCH), "cpu")
    try:
        for w in want:
            got = next(feeder)
            assert sorted(got) == sorted(w) == ["actions", "images", "states"]
            for k in w:
                assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
                assert got[k].numpy().dtype == w[k].dtype and got[k].numpy().tobytes() == w[k].tobytes()
            assert got["images"].dtype == torch.uint8 and not got["images"].is_pinned()
    finally:
        feeder.close()
    assert not feeder._thread.is_alive()


def test_feeder_passes_an_error_on():
    def host():
        yield {"images": np.zeros((2, 3, 4, 4, 3), np.uint8)}
        raise RuntimeError("bad record")

    feeder = DeviceFeeder(host(), "cpu")
    assert next(feeder)["images"].shape == (2, 3, 4, 4, 3)
    with pytest.raises(RuntimeError, match="bad record"):
        next(feeder)
    feeder._thread.join(5)
    assert not feeder._thread.is_alive()


def test_feeder_ends_with_its_stream():
    batches = [{"images": np.full((1, 2, 2, 2, 3), i, np.uint8)} for i in range(3)]
    feeder = DeviceFeeder(iter(batches), "cpu")
    assert [int(b["images"][0, 0, 0, 0, 0]) for b in feeder] == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(feeder)


def test_feeder_close_ends_its_thread_and_the_pipeline(schema_dirs):
    before = set(threading.enumerate())
    feeder = DeviceFeeder(_pair("bair", schema_dirs["bair"], "test")[0].make_iterator(BATCH), "cpu")
    next(feeder)
    feeder.close()
    assert not feeder._thread.is_alive()
    for t in set(threading.enumerate()) - before:  # the pipeline's prefetch thread stops within its poll
        t.join(5)
        assert not t.is_alive(), t.name
