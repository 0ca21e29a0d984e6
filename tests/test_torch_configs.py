"""The port's copies of the JAX package's framework-free modules stay equal
to the originals (they are copied, not imported, because importing the JAX
package imports jax), and the port never imports jax, flax or tensorflow."""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.data import get_dataset_class
from video_prediction_torch.data.synthetic import SyntheticVideoDataset as TSynthetic
from video_prediction_torch.models import get_model_class
from video_prediction_torch.utils import gif as tgif
from video_prediction_torch.utils import html as thtml
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset as JSynthetic
from video_prediction_tpu.utils import gif as jgif
from video_prediction_tpu.utils import html as jhtml

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["ModelHparams", "DatasetHparams"])
def test_hparams_fields_and_defaults_equal(name):
    jcls, tcls = getattr(jhp, name), getattr(thp, name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jcls)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert tcls().to_dict() == jcls().to_dict()
    assert getattr(tcls, "_ALLOWED", None) == getattr(jcls, "_ALLOWED", None)


@pytest.mark.parametrize(
    "spec",
    ["", "ngf=8,nz=4", "kernel_size=[3, 3],where_add=middle", "lr=1e-4,learn_prior=True",
     "decay_steps=(10, 20),transformation=cdna"],
)
def test_parse_and_apply_overrides_equal(spec):
    assert thp.parse_overrides(spec) == jhp.parse_overrides(spec)
    t = thp.apply_overrides(thp.ModelHparams(), thp.parse_overrides(spec))
    j = jhp.apply_overrides(jhp.ModelHparams(), jhp.parse_overrides(spec))
    assert t.to_dict() == j.to_dict()


def test_override_errors_equal():
    for mod in (thp, jhp):
        with pytest.raises(ValueError, match="unknown hparam"):
            mod.apply_overrides(mod.ModelHparams(), {"bogus": 1})
        with pytest.raises(ValueError, match="not one of"):
            mod.ModelHparams(gate_dtype="bf16")
        with pytest.raises(ValueError, match="key=value"):
            mod.parse_overrides("ngf")


def test_every_zoo_file_resolves_equally():
    for path in sorted(thp.zoo_dir().glob("*/*/model_hparams.json")):
        t = thp.resolve_model_hparams(thp.ModelHparams(), str(path))
        j = jhp.resolve_model_hparams(jhp.ModelHparams(), str(path))
        assert t.to_dict() == j.to_dict(), path


def test_inference_defaults_are_a_no_op():
    hp = thp.ModelHparams(scan_unroll=3)
    assert thp.adopt_inference_defaults(hp, {}) == hp


@pytest.mark.parametrize("mode,size,seq", [("test", 64, 12), ("train", 32, 6)])
def test_synthetic_batches_equal_byte_for_byte(mode, size, seq):
    jds = JSynthetic(mode=mode, seed=3, image_size=size, hparams=jhp.DatasetHparams(sequence_length=seq))
    tds = TSynthetic(mode=mode, seed=3, image_size=size, hparams=thp.DatasetHparams(sequence_length=seq))
    jit, tit = jds.make_iterator(3), tds.make_iterator(3)
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes(), k


def test_dataset_registry():
    from video_prediction_torch.data import _DATASETS, register_dataset
    from video_prediction_tpu.data import _DATASETS as J_DATASETS

    assert get_dataset_class("synthetic") is TSynthetic
    assert sorted(_DATASETS) == sorted(J_DATASETS)  # all nine names
    assert get_dataset_class("bair") is get_dataset_class("softmotion")
    for name, cls in _DATASETS.items():
        assert cls.__name__ == J_DATASETS[name].__name__, name
    with pytest.raises(ValueError, match="available"):
        get_dataset_class("bogus")
    register_dataset("bogus", TSynthetic)
    try:
        assert get_dataset_class("bogus") is TSynthetic
    finally:
        del _DATASETS["bogus"]


def test_gif_encoding_equal():
    frames = np.random.RandomState(0).rand(3, 8, 8, 3).astype(np.float32)
    assert tgif.encode_gif(frames, fps=5) == jgif.encode_gif(frames, fps=5)
    grid = np.random.RandomState(1).rand(5, 2, 4, 4, 3)
    np.testing.assert_array_equal(tgif.tile_image_grid(grid, 2), jgif.tile_image_grid(grid, 2))


def test_html_gallery_equal(tmp_path):
    assert inspect.getsource(thtml.HTML) == inspect.getsource(jhtml.HTML)
    pages = []
    for mod, sub in ((thtml, "port"), (jhtml, "jax")):
        page = mod.HTML(str(tmp_path / sub), title="synthetic/savp", refresh=5)
        page.add_header("example 0")
        page.add_text("best of 8")
        page.add_images(["images/gt_00000.gif", "images/gen_00000.gif"], ["ground truth", "savp"], height=128)
        pages.append(open(page.save(), "rb").read())
        assert os.path.isdir(page.get_image_dir())
    assert pages[0] == pages[1]


def test_model_registry():
    from video_prediction_torch.models import _MODELS, trainable_models

    assert sorted(_MODELS) == ["dna", "ground_truth", "repeat", "savp", "sna", "sv2p"]
    assert get_model_class("sv2p").default_hparams().latent_time_invariant
    assert get_model_class("dna").default_hparams().transformation == "dna"
    assert get_model_class("sna").default_hparams().first_image_background
    assert not get_model_class("repeat").trainable and get_model_class("savp").trainable
    assert trainable_models() == ["dna", "savp", "sna", "sv2p"]
    with pytest.raises(ValueError, match="available"):
        get_model_class("cdna")


def test_port_never_imports_jax_or_flax():
    """Import the package and every submodule in a fresh interpreter: no jax,
    flax, ``video_prediction_tpu`` or tensorflow module is loaded after."""
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        import video_prediction_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        # the Python modules: native/'s ctypes libraries (lib*.so) are no extension modules
        names = [n for n in names if importlib.util.find_spec(n).origin.endswith(".py")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "video_prediction_tpu", "tensorflow"))
        assert len(names) > 20, names
        training = ["losses", "ops.spectral", "train.schedules", "train.state", "train.step", "train.checkpoint",
                    "train.__main__", "train.profile_step"]
        evaluation = ["metrics", "evaluate", "models.vgg", "models.lpips", "utils.html", "utils.summary"]
        data = ["native", "data.base", "data.native_loader", "data.records", "data.loader", "data.bair", "data.kth",
                "data.something", "data.variants", "data.convert", "data.synthetic"]
        generator = ["ops.cdna", "ops.warp", "ops.rnn", "ops.layers", "models.savp", "models.model_zoo"]
        tools = ["bench", "bench_common", "bench_generate", "bench_probe", "convert"]
        parallel = ["parallel", "parallel.distributed", "parallel.mesh"]
        assert not [m for m in training + evaluation + data + generator + tools + parallel
                    if "video_prediction_torch." + m not in names], names
        assert not leaked, leaked
        print(len(names))
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
