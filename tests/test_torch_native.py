"""The port's copies of the JAX package's data plane, its TFRecord writer and
its converters, on the CPU:

- ``video_prediction_torch/native/`` equals ``video_prediction_tpu/native/``
  with only the package name substituted, ``data/{bair,variants}.py`` too;
  every function and class that the port copied into ``data/`` has the same
  code as its original (docstrings and comments aside);
- ``bilinear_resize_uint8`` and ``center_crop_or_pad`` give equal outputs;
- ``data/records.py`` frames records as ``tf.io.TFRecordWriter`` does, byte
  for byte, and its Examples parse under ``tf.io.parse_single_example`` and
  both native parsers to the same values as TensorFlow's own Examples;
- the ``convert``, ``kth`` and ``something`` converters write records that
  the JAX reader parses to the same examples as the JAX converters' records.
"""

import ast
import inspect
import os
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from video_prediction_torch import native as t_native
from video_prediction_torch.data import base as t_base
from video_prediction_torch.data import convert as t_convert
from video_prediction_torch.data import kth as t_kth
from video_prediction_torch.data import native_loader as t_loader
from video_prediction_torch.data import records as R
from video_prediction_torch.data import something as t_something
from video_prediction_tpu import native as j_native
from video_prediction_tpu.data import base as j_base
from video_prediction_tpu.data import convert as j_convert
from video_prediction_tpu.data import kth as j_kth
from video_prediction_tpu.data import native_loader as j_loader
from video_prediction_tpu.data import something as j_something

tf = pytest.importorskip("tensorflow")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _port_text(path):
    return path.read_text().replace("video_prediction_tpu", "video_prediction_torch")


@pytest.mark.parametrize("path", ["native/tfrecord.cc", "native/imagecodec.cc", "native/__init__.py",
                                  "data/bair.py", "data/variants.py"])
def test_file_is_a_copy(path):
    assert (REPO / "video_prediction_torch" / path).read_text() == _port_text(REPO / "video_prediction_tpu" / path)


def _code(obj):
    """The code of ``obj`` as an AST dump, without its docstrings."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Module)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("video_prediction_tpu", "video_prediction_torch")


COPIED = {
    "native_loader": (t_loader, j_loader, ["bilinear_resize_uint8", "center_crop_or_pad", "NativeVideoPipeline"]),
    "base": (t_base, j_base, ["_pil_decode", "_decode_pool", "BaseVideoDataset.__init__",
                              "VideoDataset.source_sequence_length", "VideoDataset.parse_example_np",
                              "VideoDataset._materialize_images", "VideoDataset.gather_plan",
                              "VideoDataset.parse_gathered_np"]),
    "kth": (t_kth, j_kth, ["KTHVideoDataset", "partition_data", "main"]),
    "something": (t_something, j_something, ["SomethingSomethingVideoDataset", "partition_data", "main"]),
    "convert": (t_convert, j_convert, ["_load_frame", "list_frames", "main"]),
}


def _resolve(module, dotted):
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part) if not isinstance(obj, type) else obj.__dict__[part]
    return obj.fget if isinstance(obj, property) else obj


@pytest.mark.parametrize("module,name", [(m, n) for m, (_, _, names) in COPIED.items() for n in names])
def test_copied_code_equals_the_original(module, name):
    port, jax_mod, _ = COPIED[module]
    assert _code(_resolve(port, name)) == _code(_resolve(jax_mod, name))


def test_copied_constants_and_schema_attributes_equal():
    assert (t_kth.TRAIN_PERSONS, t_kth.TEST_PERSONS) == (j_kth.TRAIN_PERSONS, j_kth.TEST_PERSONS)
    attrs = ["IMAGE_KEY", "IMAGE_SHAPE", "IMAGE_ENCODING", "ACTION_KEY", "ACTION_DIM", "STATE_KEY", "STATE_DIM",
             "SOURCE_SEQUENCE_LENGTH"]
    for cls in ("BaseVideoDataset", "VideoDataset"):
        t, j = getattr(t_base, cls), getattr(j_base, cls)
        assert [getattr(t, a, None) for a in attrs] == [getattr(j, a, None) for a in attrs]
        assert t.default_hparams.to_dict() == j.default_hparams.to_dict()


# ---- numpy preprocessing ---------------------------------------------------- #


@pytest.mark.parametrize("shape,out", [((2, 3, 16, 12, 3), (8, 8)), ((1, 120, 160, 3), (64, 64)),
                                       ((4, 5, 7, 1), (9, 11)), ((1, 8, 8, 3), (8, 8))])
def test_bilinear_resize_equal(shape, out):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    a, b = t_loader.bilinear_resize_uint8(x, *out), j_loader.bilinear_resize_uint8(x, *out)
    assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape,size", [((2, 120, 160, 3), 120), ((1, 10, 6, 3), 8), ((3, 5, 9, 1), 7),
                                        ((1, 8, 8, 3), 8)])
def test_center_crop_or_pad_equal(shape, size):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    a, b = t_loader.center_crop_or_pad(x, size), j_loader.center_crop_or_pad(x, size)
    assert a.shape == b.shape == shape[:-3] + (size, size, shape[-1]) and a.tobytes() == b.tobytes()


# ---- the writer -------------------------------------------------------------- #


def test_crc32c_check_value():
    assert R.crc32c(b"123456789") == 0xE3069283  # the CRC-32C catalogue's check value
    assert R.crc32c(b"") == 0


def test_framing_equals_the_tf_writer(tmp_path):
    rng = np.random.RandomState(0)
    payloads = [b"", b"a", rng.bytes(1000), rng.bytes(70_000), b"\x00" * 300]
    with tf.io.TFRecordWriter(str(tmp_path / "tf.tfrecord")) as w:
        for p in payloads:
            w.write(p)
    with R.TFRecordWriter(str(tmp_path / "port.tfrecord")) as w:
        for p in payloads:
            w.write(p)
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "tf.tfrecord").read_bytes()
    assert list(t_native.read_records(str(tmp_path / "port.tfrecord"))) == payloads


EXAMPLES = {
    "bytes": {"a": ("bytes", [b"xyz"])},
    "multi_bytes": {"frames": ("bytes", [b"", b"\x00\xff", bytes(range(256)) * 3])},
    "float": {"f": ("float", [0.25])},
    "multi_float": {"f": ("float", [-1.5, 3.0e-8, 1e30, 0.1]), "g": ("float", [2.0])},
    "int64": {"n": ("int64", [30])},
    "multi_int64": {"n": ("int64", [0, 1, -1, 2**63 - 1, -(2**63), 300, 127, 128])},
    "empty_lists": {"b": ("bytes", []), "f": ("float", []), "i": ("int64", [])},
    "bair_frame": {"0/image_aux1/encoded": ("bytes", [bytes(192)]), "0/action": ("float", [0.1, 0.2, 0.3, 0.4]),
                   "0/endeffector_pos": ("float", [1.0, 2.0, 3.0]), "sequence_length": ("int64", [30])},
}
_PORT_FEATURE = {"bytes": R.bytes_feature, "float": R.float_feature, "int64": R.int64_feature}
_TF_DTYPE = {"bytes": tf.string, "float": tf.float32, "int64": tf.int64}


def _tf_example(ex):
    def feat(kind, v):
        if kind == "bytes":
            return tf.train.Feature(bytes_list=tf.train.BytesList(value=v))
        if kind == "float":
            return tf.train.Feature(float_list=tf.train.FloatList(value=v))
        return tf.train.Feature(int64_list=tf.train.Int64List(value=v))

    return tf.train.Example(features=tf.train.Features(feature={k: feat(*kv) for k, kv in ex.items()}))


@pytest.mark.parametrize("case", sorted(EXAMPLES))
def test_example_parses_like_tensorflows(case):
    ex = EXAMPLES[case]
    ours = R.encode_example({k: _PORT_FEATURE[kind](v) for k, (kind, v) in ex.items()})
    theirs = _tf_example(ex)
    assert tf.train.Example.FromString(ours) == theirs  # the same message
    spec = {k: tf.io.VarLenFeature(_TF_DTYPE[kind]) for k, (kind, _) in ex.items()}
    parsed_ours = tf.io.parse_single_example(ours, spec)
    parsed_theirs = tf.io.parse_single_example(theirs.SerializeToString(), spec)
    for k, (kind, values) in ex.items():
        got = parsed_ours[k].values.numpy()
        np.testing.assert_array_equal(got, parsed_theirs[k].values.numpy())
        if kind == "bytes":
            assert list(got) == list(values)
        else:
            np.testing.assert_array_equal(got, np.asarray(values, np.float32 if kind == "float" else np.int64))
    for parse in (t_native.parse_example, j_native.parse_example):
        a, b = parse(ours), parse(theirs.SerializeToString())
        assert sorted(a) == sorted(b) == sorted(ex)
        for k in a:
            if isinstance(a[k], list):
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ---- the converters ------------------------------------------------------------ #


def _frame_tree(root, names, n_frames, size=(24, 32)):
    from PIL import Image

    rng = np.random.RandomState(0)
    for v, name in enumerate(names):
        d = root / name
        d.mkdir(parents=True)
        base = np.linspace(0, 200, size[1])[None, :, None] + 20 * v
        for i in range(n_frames):
            img = np.clip(np.broadcast_to(base, (*size, 3)) + rng.randint(0, 30, (*size, 3)) + 2 * i, 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"frame_{i:05d}.png")
    return sorted(str(root / n) for n in names)


def _examples(path):
    """Every record of ``path``, parsed by the JAX package's native parser."""
    return [j_native.parse_example(r) for r in j_native.read_records(str(path))]


def _assert_same_records(a, b):
    ea, eb = _examples(a), _examples(b)
    assert len(ea) == len(eb) > 0
    for x, y in zip(ea, eb):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], list):
                assert x[k] == y[k], k
            else:
                assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("center_crop,stride", [(False, None), (True, 3)])
def test_convert_tree_writes_what_the_jax_converter_writes(tmp_path, center_crop, stride):
    _frame_tree(tmp_path / "frames", [f"video{v}" for v in range(4)], 9)
    counts = []
    for mod, out in ((t_convert, "port"), (j_convert, "jax")):
        counts.append(mod.convert_tree(str(tmp_path / "frames"), str(tmp_path / out), window=6, size=16,
                                       val_fraction=0.25, stride=stride, center_crop=center_crop, record_prefix="x_"))
    assert counts[0] == counts[1] and counts[0][0] > 0 and counts[0][1] > 0
    for split in ("train", "val"):
        _assert_same_records(tmp_path / "port" / split / f"x_{split}.tfrecord",
                             tmp_path / "jax" / split / f"x_{split}.tfrecord")


@pytest.mark.parametrize("size", [(64, 64), None])
def test_kth_converter_writes_what_the_jax_converter_writes(tmp_path, size):
    dirs = _frame_tree(tmp_path / "frames", ["person01_boxing_d1", "person17_walking_d2"], 12)
    assert t_kth.partition_data(dirs) == j_kth.partition_data(dirs)
    train, _ = t_kth.partition_data(dirs)
    n = [mod.save_tf_record(str(tmp_path / f"{out}.tfrecord"), train, window=5, size=size)
         for mod, out in ((t_kth, "port"), (j_kth, "jax"))]
    assert n == [2, 2]
    _assert_same_records(tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord")


def test_something_converter_writes_what_the_jax_converter_writes(tmp_path):
    dirs = _frame_tree(tmp_path / "frames", ["1001", "1002"], 10)
    assert t_something.partition_data(dirs) == j_something.partition_data(dirs)
    n = [mod.save_tf_record(str(tmp_path / f"{out}.tfrecord"), dirs, window=4, size=16, stride=3)
         for mod, out in ((t_something, "port"), (j_something, "jax"))]
    assert n == [6, 6]
    _assert_same_records(tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord")


@pytest.mark.parametrize("module,argv,files", [
    ("convert", ["--window", "5", "--size", "16", "--val_fraction", "0.5"], ["train/train.tfrecord",
                                                                            "val/val.tfrecord"]),
    ("kth", ["--window", "5", "--image_size", "16"], ["train/kth_train.tfrecord", "test/kth_test.tfrecord"]),
    ("something", ["--window", "5", "--image_size", "16", "--val_fraction", "0.5"],
     ["train/something_train.tfrecord", "val/something_val.tfrecord"]),
])
def test_converter_main_writes_what_the_jax_main_writes(module, argv, files, tmp_path, monkeypatch, capsys):
    """``python -m video_prediction_torch.data.<module>`` in-process, against
    ``python -m video_prediction_tpu.data.<module>`` with the same argv."""
    _frame_tree(tmp_path / "frames", ["person02_boxing_d1", "person18_walking_d2"], 11)
    mods = {"convert": (t_convert, j_convert), "kth": (t_kth, j_kth), "something": (t_something, j_something)}
    for mod, out in zip(mods[module], ("port", "jax")):
        monkeypatch.setattr(sys, "argv", [module, str(tmp_path / "frames"), str(tmp_path / out)] + argv)
        mod.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("port", "jax") == lines[1]
    for f in files:
        _assert_same_records(tmp_path / "port" / f, tmp_path / "jax" / f)


def test_the_converters_import_no_tensorflow():
    """The converters' module path runs without TensorFlow: a fresh
    interpreter with ``tensorflow`` unimportable converts a frame tree."""
    import subprocess

    code = textwrap.dedent(
        """
        import sys, tempfile, os
        sys.modules["tensorflow"] = None  # any import of it raises
        import numpy as np
        from PIL import Image
        from video_prediction_torch.data.convert import convert_tree
        from video_prediction_torch.data.bair import SoftmotionVideoDataset
        root = tempfile.mkdtemp()
        os.makedirs(f"{root}/frames/v0")
        for i in range(4):
            Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(f"{root}/frames/v0/{i}.png")
        assert convert_tree(f"{root}/frames", f"{root}/out", window=4, size=8, val_fraction=0) == (1, 0)
        class Small(SoftmotionVideoDataset):
            IMAGE_KEY, IMAGE_ENCODING, IMAGE_SHAPE, SOURCE_SEQUENCE_LENGTH = "%d/image/encoded", "jpeg", (8, 8, 3), 4
        from video_prediction_torch.configs.hparams import DatasetHparams
        ds = Small(f"{root}/out/train", mode="test", hparams=DatasetHparams(sequence_length=4))
        batch = next(ds.make_iterator(1))
        assert batch["images"].shape == (1, 4, 8, 8, 3), batch["images"].shape
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "VP_DATA_BACKEND"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
