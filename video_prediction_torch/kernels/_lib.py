"""Build and bind the port's CUDA kernels.

All kernels live in ``csrc/*.cu``. At first use on a CUDA tensor they are
compiled by ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, under ``build/torch_kernels/`` at the repository root, and loaded
with ``ctypes``. The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded. Nothing
here runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# dtype codes shared with csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "vp_cdna_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_ln_gate_forward": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P],
    "vp_composite_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vp_cdna_backward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_cdna_backward_tiles": [_I, _I, _I, _I, _I, _I],
    "vp_ln_gate_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _P],
    "vp_ln_gate_backward_blocks": [_I, _I],
    "vp_composite_backward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvp_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    """nvcc all ``csrc/*.cu`` into ``target``."""
    target.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernel library if the current sources have none yet, then load it."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vp_error_string.argtypes = [ctypes.c_int]
    lib.vp_error_string.restype = ctypes.c_char_p
    return lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16 tensors, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version runs); False
    when every tensor is on one CUDA device (the kernel runs). Anything else
    raises: a kernel's wrapper never moves or copies its inputs."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"kernel inputs must be on CPU or CUDA, got {device}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def plain_vjp(fn, inputs, grads):
    """Gradients of plain version ``fn`` at ``inputs`` for upstream ``grads``,
    by autograd: what a backward wrapper returns for CPU tensors."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, grads)


def query(name: str, *args) -> int:
    """Call size helper ``name`` (no launch, no stream) and return its int."""
    return getattr(load_library(), name)(*args)


def launch(name: str, *args, device: torch.device) -> None:
    """Call kernel launcher ``name`` with ``args`` followed by the device index
    and PyTorch's current stream on that device; raise on a non-zero code."""
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.vp_error_string(err).decode()}")
