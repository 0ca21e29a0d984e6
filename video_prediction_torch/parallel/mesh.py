"""``video_prediction_tpu/parallel/mesh.py`` over process groups: its data
axis and its ``model`` axis (spatial partitioning).

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

Spatial partitioning (``make_spatial_mesh``, the JAX ``make_mesh``'s
``model`` axis): image height is sharded over the k ranks of a spatial
group. With world size W, rank r has data coordinate ``r // k`` and
spatial coordinate ``r % k`` (the model axis varies fastest, as
``make_mesh`` orders the devices). The k ranks of a spatial group see the
same samples and the same noise, each its H/k rows of the images
(``shard_batch(spatial=...)``, ``leaf_spec``'s ``P("data", None,
"model")``); low-dim leaves stay whole in the group. Model code reads the
mesh from ``spatial_context`` (the counterpart of ``spatial_trace_mesh``)
through ``current_spatial``; ``whole`` leaves it for the subnetworks that
run on gathered tensors (the counterpart of ``constrain_data_parallel``).
Outside a spatial context every layer is the unsharded one, bit for bit.
The halo exchanges, statistics and gathers are ``parallel/spatial.py``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the step noise (models/base.py#draw_noise) split by rank: the batch dim of
# each leaf; clip_start is not split, so every rank's discriminators see one clip
NOISE_BATCH_DIM = {"use_gt_u": 1, "eps_q": 0, "z_p": 0}
# and of the leaves the train step derives from it under data parallel
# (train/step.py#_rank_noise): the ranks of use_gt_u in its global rows
DERIVED_NOISE_DIM = {"use_gt_rank": 1}


def _rows(n: int, rank: int, world: int) -> slice:
    if n % world:
        raise ValueError(f"global batch {n} not divisible by {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _take(v, dim: int, rank: int, world: int):
    return v[(slice(None),) * dim + (_rows(v.shape[dim], rank, world),)]


def shard_batch(batch: Dict[str, Any], rank: int, world: int, stacked: bool = False,
                spatial: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Rank ``rank``'s rows of a global batch (numpy arrays or tensors):
    along dim 0, or dim 1 of batches stacked ``[K, B, ...]``
    (``leaf_spec(stacked=True)``). ``spatial`` ``(coord, k)``: ``rank`` and
    ``world`` are the data coordinate and size, and ``images`` also keep
    their ``coord``-th of k slices of height (``image_rows``)."""
    out = {k: _take(v, 1 if stacked else 0, rank, world) for k, v in batch.items()}
    return out if spatial is None else image_rows(out, *spatial, stacked=stacked)


def image_rows(batch: Dict[str, Any], coord: int, k: int, stacked: bool = False) -> Dict[str, Any]:
    """``batch`` with ``images [B,T,H,W,C]`` (``[K,B,T,H,W,C]`` stacked) cut
    to the ``coord``-th of ``k`` slices of H; the low-dim leaves whole
    (``leaf_spec``)."""
    return {key: _take(v, 3 if stacked else 2, coord, k) if key == "images" else v for key, v in batch.items()}


def shard_noise(noise: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of one step's noise drawn for the global batch:
    ``use_gt_u [T-1,B]`` along dim 1, ``eps_q`` and ``z_p`` ``[B,·,nz]``
    along dim 0, ``use_gt_rank`` as ``use_gt_u``, ``clip_start`` and
    ``use_gt_batch`` whole."""
    dims = {**NOISE_BATCH_DIM, **DERIVED_NOISE_DIM}
    return {k: _take(v, dims[k], rank, world).contiguous() if k in dims else v for k, v in noise.items()}


def _flat(tensors: Sequence[torch.Tensor], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype or t.dtype) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive pieces of ``flat`` back into ``tensors`` (all of
    them read into ``flat`` first, so tensors that share storage get one value)."""
    pieces = torch.split(flat, [t.numel() for t in tensors])
    torch._foreach_copy_([t.detach() for t in tensors], [p.view(t.shape) for p, t in zip(pieces, tensors)])


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup] = None,
                     divisor: Optional[int] = None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``: one flat
    fp32 buffer a call (bf16 gradients would be reduced in fp32), summed,
    then divided by the world size, or by ``divisor``: the data size under
    spatial partitioning, where each rank holds its share of its spatial
    group's sum. NCCL captures it into a CUDA graph."""
    flat = _flat(tensors, torch.float32)
    dist.all_reduce(flat, group=group)
    flat.div_(divisor or dist.get_world_size(group))
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


# ---------------------------------------------------------------------------
# spatial partitioning: the model axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """This rank's place in a (data, spatial) mesh of process groups: ``k``
    ranks a spatial group, this rank's spatial coordinate ``coord``, its
    data coordinate ``data_rank`` of ``data_size``, and ``group``, its
    spatial group."""

    k: int
    coord: int
    data_rank: int
    data_size: int
    group: Any


def make_spatial_mesh(spatial: int) -> Optional[SpatialMesh]:
    """The (data, spatial) mesh of the default process group with
    ``spatial`` ranks a spatial group; None for ``spatial == 1``. Every rank
    makes every spatial group, in the same order (``dist.new_group``). A
    world that ``spatial`` does not divide raises (``mesh_for_batch``), so
    ``spatial > 1`` in one process does."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} ranks not divisible by spatial_shards={spatial}")
    if spatial == 1:
        return None
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(d * spatial, (d + 1) * spatial))) for d in range(world // spatial)]
    return SpatialMesh(spatial, rank % spatial, rank // spatial, world // spatial, groups[rank // spatial])


def validate_spatial_mesh(k: int, height: int, width: int) -> None:
    """Reject spatial-shard factors that would degenerate the generator's
    bottleneck (the JAX function, with the port's ``generator_num_scales``):
    the bottleneck must split into k slices of at least 4 rows, so 64 and
    128 px take k <= 2 and 256 px k <= 4. Every shard height at every
    scale is then even, as the 2x2 pools and stride-2 convs need."""
    if k <= 1:
        return
    from video_prediction_torch.models.savp import generator_num_scales

    bottleneck = min(height, width) >> generator_num_scales(height, width)
    if bottleneck % k or bottleneck // k < 4:
        raise ValueError(f"spatial_shards={k} over {height}x{width} inputs leaves {bottleneck / k:g} rows per shard "
                         f"at the {bottleneck}px bottleneck (< 4, the validated minimum for the 5x5 ConvLSTM "
                         f"kernels); use a smaller --spatial_shards")


_SPATIAL: contextvars.ContextVar[Optional[SpatialMesh]] = contextvars.ContextVar("vp_spatial_mesh", default=None)


@contextlib.contextmanager
def spatial_context(mesh: Optional[SpatialMesh]) -> Iterator[None]:
    """Run model code in the block on this rank's rows of ``mesh`` (None:
    unsharded), as the JAX step traces under ``spatial_trace_mesh``."""
    token = _SPATIAL.set(mesh)
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def whole() -> contextlib.AbstractContextManager:
    """Leave the spatial context for a subnetwork that runs on gathered,
    whole-height tensors (the posterior, the learned prior, the
    discriminators, VGG; ``constrain_data_parallel``)."""
    return spatial_context(None)


def current_spatial() -> Optional[SpatialMesh]:
    """The mesh of the enclosing ``spatial_context``, or None."""
    return _SPATIAL.get()
