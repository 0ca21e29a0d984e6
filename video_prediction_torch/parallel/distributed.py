"""Processes for data-parallel training: one process per GPU, as ``torchrun``
launches them.

Port of ``video_prediction_tpu/parallel/distributed.py``. The JAX package
connects its hosts with ``jax.distributed.initialize`` and lets one mesh
span every chip. Here every GPU has a process of its own, the processes form
PyTorch's default process group, and the train step mean-reduces the
gradients over it (``parallel/mesh.py``, ``train/step.py``).

``maybe_initialize`` resolves the group in the JAX function's order:
explicit arguments, then the launcher's environment (``torchrun`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), and otherwise nothing, so that a single-process run is
untouched. The backend is NCCL for a CUDA device and gloo for the CPU,
unless the caller names one. There is no fallback: a failed
``init_process_group`` raises, and so does a CUDA request without a card.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from video_prediction_torch.utils.device import device_or_raise


def maybe_initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Join the default process group when configured; returns True if this
    call created it.

    Resolution order: explicit arguments, then ``WORLD_SIZE``/``RANK`` and
    ``MASTER_ADDR`` (``init_method="env://"``, as ``torchrun`` sets them).
    Without either it does nothing and returns False, and so it does when
    a group exists already (a caller's group is used as it is). ``device``
    is the run's device (``local_device`` resolves it): the backend is
    ``nccl`` on CUDA, ``gloo`` on the CPU, unless ``backend`` names one."""
    if dist.is_initialized():
        return False
    world = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rk = rank if rank is not None else _int_env("RANK")
    if init_method is None:
        if not os.environ.get("MASTER_ADDR") or world is None or rk is None:
            return False
        init_method = "env://"
    if world is None or rk is None:
        raise ValueError(f"init_method {init_method!r} needs a world size and a rank (arguments, or WORLD_SIZE and "
                         f"RANK), got {world} and {rk}")
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's communicator binds to the current device
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rk)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0, or a single process: the one that writes files and prints."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def local_device(requested: str) -> torch.device:
    """The device of this process: ``cuda`` means ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` 0 where the launcher set none), an explicit ``cuda:i``
    is taken as given; raises for CUDA without a card
    (``utils/device.py#device_or_raise``)."""
    device = device_or_raise(requested)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _int_env("LOCAL_RANK") or 0)
    return device


def per_host_batch(global_batch: int, spatial: int = 1) -> int:
    """The rows of a global batch each process feeds (the group's ranks
    together make up the batch; the ``spatial`` ranks of a spatial group
    feed the same rows)."""
    n = world_size() // spatial
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n
