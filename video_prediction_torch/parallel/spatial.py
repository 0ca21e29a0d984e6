"""The collectives of spatial partitioning, each a ``torch.autograd.Function``
whose backward is its exact adjoint.

The JAX package marks where image height is sharded and lets GSPMD insert
the halo exchanges; here each is written by hand over the ranks of a
spatial group (``parallel/mesh.py#SpatialMesh``):

- ``halo``: a shard padded with its neighbours' rows; at the global top and
  bottom with zeros (a conv's SAME padding) or the edge row repeated (a
  bilinear resize's clamp). Adjoint: each halo row's gradient goes back to
  its owner and is added there.
- ``all_reduce_sum``: the sum over the group (the norms' statistics, the
  global average pools). Adjoint: the same sum.
- ``gather_rows``: the full height on every rank of the group. Adjoint: a
  reduce-scatter of the sum.
- ``take_rows``: this rank's rows of a full tensor, a ``narrow``, whose
  autograd already scatters the gradient into zeros.

Each is built from one ``dist.all_reduce`` (sum) of a zero-filled fp32
buffer in which each rank fills its own slot: gloo runs only ``all_reduce``
and ``broadcast`` on CUDA tensors (two ranks on one card need gloo; NCCL
refuses them), and NCCL's ``all_reduce`` captures into a CUDA graph.
Adding zeros is exact, and so is carrying a bf16 tensor in fp32. Every
rank issues the same collectives in the same order: a shard at the global
edge joins a halo's all-reduce with its slot filled all the same.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from video_prediction_torch.parallel.mesh import SpatialMesh, current_spatial


def _exchange(mesh: SpatialMesh, piece: torch.Tensor) -> torch.Tensor:
    """``[k, *piece.shape]`` fp32: every rank's ``piece`` in its slot."""
    buf = piece.new_zeros((mesh.k,) + tuple(piece.shape), dtype=torch.float32)
    buf[mesh.coord] = piece
    dist.all_reduce(buf, group=mesh.group)
    return buf


def _summed(mesh: SpatialMesh, x: torch.Tensor) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=mesh.group)
    return y.to(x.dtype)


def _border(x: torch.Tensor, dim: int, row: int, rows: int, edge: bool) -> torch.Tensor:
    """``rows`` rows beyond the global border: zeros, or row ``row`` repeated."""
    shape = list(x.shape)
    shape[dim] = rows
    return x.narrow(dim, row, 1).expand(shape) if edge else x.new_zeros(shape)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, before, after, edge):
        ctx.mesh, ctx.dim, ctx.before, ctx.after, ctx.edge = mesh, dim, before, after, edge
        n = x.shape[dim]
        # my first `after` rows are my predecessor's bottom halo, my last
        # `before` rows my successor's top halo
        buf = _exchange(mesh, torch.cat([x.narrow(dim, 0, after), x.narrow(dim, n - before, before)], dim))
        c = mesh.coord
        top = buf[c - 1].narrow(dim, after, before).to(x.dtype) if c > 0 else _border(x, dim, 0, before, edge)
        bot = buf[c + 1].narrow(dim, 0, after).to(x.dtype) if c < mesh.k - 1 else _border(x, dim, n - 1, after, edge)
        return torch.cat([top, x, bot], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, before, after = ctx.mesh, ctx.dim, ctx.before, ctx.after
        n = g.shape[dim] - before - after
        g_top, g_bot = g.narrow(dim, 0, before), g.narrow(dim, before + n, after)
        buf = _exchange(mesh, torch.cat([g_top, g_bot], dim))
        gx = g.narrow(dim, before, n).to(torch.float32, copy=True)
        c = mesh.coord
        if c < mesh.k - 1:  # my successor's top halo is my last rows
            gx.narrow(dim, n - before, before).add_(buf[c + 1].narrow(dim, 0, before))
        elif ctx.edge:
            gx.narrow(dim, n - 1, 1).add_(g_bot.float().sum(dim, keepdim=True))
        if c > 0:  # my predecessor's bottom halo is my first rows
            gx.narrow(dim, 0, after).add_(buf[c - 1].narrow(dim, before, after))
        elif ctx.edge:
            gx.narrow(dim, 0, 1).add_(g_top.float().sum(dim, keepdim=True))
        return gx.to(g.dtype), None, None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.mesh, g), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return torch.cat(_exchange(mesh, x).unbind(0), dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        n = g.shape[dim] // mesh.k
        return _summed(mesh, g).narrow(dim, mesh.coord * n, n), None, None


def halo(x: torch.Tensor, mesh: SpatialMesh, before: int, after: int, dim: int = 1,
         edge: bool = False) -> torch.Tensor:
    """``x`` (this rank's rows along ``dim``) with ``before`` rows of its
    predecessor's above and ``after`` rows of its successor's below; at the
    global borders zeros, or with ``edge`` the border row repeated."""
    dim %= x.dim()
    if max(before, after) > x.shape[dim]:
        raise ValueError(f"a halo of ({before}, {after}) rows is deeper than the shard's {x.shape[dim]} rows")
    if before == after == 0:
        return x
    return _Halo.apply(x, mesh, dim, before, after, edge)


def all_reduce_sum(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The sum of ``x`` over the spatial group (in fp32, ``x``'s dtype out)."""
    return _AllReduceSum.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: SpatialMesh, dim: int = 1) -> torch.Tensor:
    """The full height along ``dim``: the group's shards in coordinate order."""
    return _GatherRows.apply(x, mesh, dim % x.dim())


def take_rows(x: torch.Tensor, mesh: SpatialMesh, dim: int = 1) -> torch.Tensor:
    """This rank's slice of a whole tensor along ``dim``."""
    if x.shape[dim] % mesh.k:
        raise ValueError(f"{x.shape[dim]} rows do not split into {mesh.k} shards")
    n = x.shape[dim] // mesh.k
    return x.narrow(dim, mesh.coord * n, n)


def gathered(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``x`` at full height under a spatial context (``gather_rows``), ``x``
    itself outside one."""
    mesh = current_spatial()
    return x if mesh is None else gather_rows(x, mesh, dim)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The mean of NHWC ``x`` over H and W (a global average pool): the
    local sums all-reduced over the spatial group and divided by the global
    H x W under a spatial context, ``x.mean(dim=(1, 2))`` outside one."""
    mesh = current_spatial()
    if mesh is None:
        return x.mean(dim=(1, 2))
    total = all_reduce_sum(x.sum(dim=(1, 2), dtype=torch.float32), mesh)
    return (total / (x.shape[1] * mesh.k * x.shape[2])).to(x.dtype)


def global_rows(h: int, mesh: Optional[SpatialMesh]) -> int:
    """The full height of a shard of ``h`` rows (``h`` when unsharded)."""
    return h if mesh is None else h * mesh.k


def row_offset(h: int, mesh: Optional[SpatialMesh]) -> int:
    """The global index of this rank's first row of ``h`` (0 when unsharded)."""
    return 0 if mesh is None else mesh.coord * h
