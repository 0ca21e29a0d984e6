"""The data axis of ``video_prediction_tpu/parallel/mesh.py`` over a process
group.

In the JAX package a mesh's ``data`` axis shards the leading dim of every
batch leaf, the parameters are replicated, and XLA emits the gradient
``psum`` from the step's ``in_shardings``. Here "the mesh" is the default
process group: every rank holds the whole model, takes its rows of the
global batch (``shard_batch``) and of the step's noise (``shard_noise``),
and the train step mean-reduces the gradients and the reported scalars
(``all_reduce_mean_``). The parameters start equal on every rank
(``broadcast_module_`` from rank 0) and stay equal, since every rank applies
the same reduced gradients.

``mesh_for_batch``'s shrinking of the data axis to a divisor of the batch
has no counterpart: with one process per GPU no rank can sit idle, so a
batch the ranks do not divide raises. The collectives are only
``all_reduce`` and ``broadcast``, the two that gloo runs on CUDA tensors.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the step noise (models/base.py#draw_noise) split by rank: the batch dim of
# each leaf; clip_start is not split, so every rank's discriminators see one clip
NOISE_BATCH_DIM = {"use_gt_u": 1, "eps_q": 0, "z_p": 0}


def _rows(n: int, rank: int, world: int) -> slice:
    if n % world:
        raise ValueError(f"global batch {n} not divisible by {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _take(v, dim: int, rank: int, world: int):
    return v[(slice(None),) * dim + (_rows(v.shape[dim], rank, world),)]


def shard_batch(batch: Dict[str, Any], rank: int, world: int, stacked: bool = False) -> Dict[str, Any]:
    """Rank ``rank``'s rows of a global batch (numpy arrays or tensors):
    along dim 0, or dim 1 of batches stacked ``[K, B, ...]``
    (``leaf_spec(stacked=True)``)."""
    return {k: _take(v, 1 if stacked else 0, rank, world) for k, v in batch.items()}


def shard_noise(noise: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of one step's noise drawn for the global batch:
    ``use_gt_u [T-1,B]`` along dim 1, ``eps_q`` and ``z_p`` ``[B,·,nz]``
    along dim 0, ``clip_start`` whole."""
    return {k: _take(v, NOISE_BATCH_DIM[k], rank, world).contiguous() if k in NOISE_BATCH_DIM else v
            for k, v in noise.items()}


def _flat(tensors: Sequence[torch.Tensor], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype or t.dtype) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive pieces of ``flat`` back into ``tensors`` (all of
    them read into ``flat`` first, so tensors that share storage get one value)."""
    pieces = torch.split(flat, [t.numel() for t in tensors])
    torch._foreach_copy_([t.detach() for t in tensors], [p.view(t.shape) for p, t in zip(pieces, tensors)])


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``: one flat
    fp32 buffer a call (bf16 gradients would be reduced in fp32), summed,
    then divided by the world size. NCCL captures it into a CUDA graph."""
    flat = _flat(tensors, torch.float32)
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    _unflat_(flat, tensors)


def broadcast_module_(module: torch.nn.Module, src: int = 0, group: Optional[dist.ProcessGroup] = None) -> None:
    """Give every rank ``src``'s parameters and buffers (the spectral
    ``u``s): one flat buffer a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = _flat(tensors)
            dist.broadcast(flat, src, group=group)
            _unflat_(flat, tensors)
