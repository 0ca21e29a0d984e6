"""Build and bind the port's CUDA kernels.

All kernels live in ``csrc/*.cu``. At first use on a CUDA tensor each source
is compiled by its own ``nvcc`` for ``sm_90a``, all started together, and the
objects are linked into one shared library with a plain C interface, under
``build/torch_kernels/`` at the repository root, and loaded with ``ctypes``.
``ptxas``'s report (registers, shared memory, spills of every kernel
instantiation) is kept beside the library and read by ``ptxas_report``. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU-only tests import every module.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype codes shared with csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "vp_cdna_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_ln_gate_forward": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_composite_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_cdna_backward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vp_cdna_backward_tiles": [_I, _I, _I, _I, _I, _I, _I, _I],
    "vp_ln_gate_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "vp_ln_gate_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _I, _I, _I],
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


def ptxas_log_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def _compile(target: Path) -> None:
    """nvcc each ``csrc/*.cu`` into an object, all at once, then link them
    into ``target``; keep ptxas's report beside it."""
    target.parent.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, err = proc.communicate()
            logs.append(f"# {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([_nvcc(), "-shared", "-o", lib, *objs], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        Path(tmp, "ptxas.txt").write_text("\n".join(logs))
        os.replace(Path(tmp, "ptxas.txt"), ptxas_log_path())
        os.replace(lib, target)  # atomic: a concurrent loader never sees a partial file


def ptxas_report() -> list:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of every
    kernel instantiation in the built library, from ptxas's report; names
    demangled with ``cu++filt`` where the toolkit has it."""
    import re

    rows, current, spills = [], None, (0, 0)
    for line in ptxas_log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            rows.append((current, int(m.group(1)), *spills))
            current = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True, text=True,
                             check=False).stdout.splitlines()
        if len(out) == len(rows):
            rows = [(name, *r[1:]) for name, r in zip(out, rows)]
    return rows


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


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel on ``dtype`` tensors, counted in
    its ``launches`` (``{"float32": n, "bfloat16": m}``)."""
    key = str(dtype).replace("torch.", "")
    wrapper.launches[key] = wrapper.launches.get(key, 0) + 1


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
