"""The port's package surface against the JAX package's: each of
``video_prediction_tpu/{ops,configs,parallel,train,utils}/__init__.py``
re-exports a list of public names, read here with ``ast`` (importing the JAX
package would import jax). The port's counterpart re-exports the same list,
less the JAX-only names it lists (``parallel.JAX_ONLY``), and each name
resolves to an object of the port."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from video_prediction_torch.ops import apply_cdna_kernels, identity_kernel
from video_prediction_tpu.ops import identity_kernel as j_identity_kernel

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ["ops", "configs", "parallel", "train", "utils"]


def _exported(package_dir: Path) -> list:
    """The names an ``__init__.py`` imports from its submodules, in order."""
    tree = ast.parse((package_dir / "__init__.py").read_text())
    return [alias.asname or alias.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names]


def _jax_only(name: str) -> tuple:
    return importlib.import_module(f"video_prediction_torch.{name}").__dict__.get("JAX_ONLY", ())


@pytest.mark.parametrize("name", PACKAGES)
def test_port_reexports_the_jax_names(name):
    jax_names = _exported(REPO / "video_prediction_tpu" / name)
    assert jax_names, f"no re-exports read from video_prediction_tpu/{name}/__init__.py"
    left_out = _jax_only(name)
    assert set(left_out) <= set(jax_names), f"JAX_ONLY names the JAX package does not export: {left_out}"
    assert _exported(REPO / "video_prediction_torch" / name) == [n for n in jax_names if n not in left_out]
    package = importlib.import_module(f"video_prediction_torch.{name}")
    for n in jax_names:
        if n not in left_out:
            obj = getattr(package, n)
            assert getattr(obj, "__module__", "").startswith("video_prediction_torch."), (n, obj)
    for n in left_out:
        assert f"``{n}``" in package.__doc__, f"{n} is left out of video_prediction_torch.{name} unlisted"


def test_jax_only_names_are_the_device_mesh_helpers():
    """Only ``parallel`` leaves names out: those of a ``jax.sharding`` mesh."""
    assert {n: _jax_only(n) for n in PACKAGES if _jax_only(n)} == {"parallel": (
        "make_mesh", "mesh_for_batch", "batch_sharding", "batch_shardings", "leaf_spec", "replicated_sharding",
        "spatial_mesh")}


@pytest.mark.parametrize("size", [1, 3, 5])
def test_identity_kernel_matches_jax(size):
    """``ops.identity_kernel``, the one name the port lacked, against the
    JAX function, and applied by CDNA it reproduces the frame."""
    k = identity_kernel(size)
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_identity_kernel(size)))
    image = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(size))
    kernels = k[None, :, :, None].expand(2, size, size, 1).contiguous()
    torch.testing.assert_close(apply_cdna_kernels(image, kernels)[:, 0], image, rtol=0, atol=0)
