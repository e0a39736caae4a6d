"""Sharded-point-axis (SP) geometry losses over a grid of ranks
(``pccf/dist/sp.py``).

At large point counts the ``(N, M)`` distance structure of a loss dominates
memory.  These functions cut the point axis over a grid axis
(:class:`~pccf_torch.dist.sharding.Grid`), so that each rank holds an
``(N/sp, M)`` slab.  Each takes this rank's slab of both clouds (the points
cut over ``axis``; with ``batch_axis`` the batch cut over that axis, see
:func:`slab`) and returns the ``(B_local,)`` result on every rank of the
``axis`` group:

- :func:`sp_chamfer` gathers the opposing cloud, takes the nearest indices
  from :func:`pccf_torch.kernels.api.nn_distance` without a gradient (on the
  card the kernel at the slab's shape), re-expresses the distances as
  gathers and sums each direction over the ranks;
- :func:`sp_match_cost` runs ApproxMatch's nine levels with the row state
  on this rank and one all-reduce of the ``(B, M)`` column demand a level,
  then the plan-constant gradients (``sp.py:147-246``); its per-rank math
  stays in PyTorch operations, as JAX keeps it in jnp (``sp.py:24-36``: a
  kernel cannot host a collective between levels);
- :func:`sp_knn` gathers the cloud and sorts each of this rank's points'
  distances: global indices, no gradient.

Only ``all_reduce`` is called, the collective that gloo implements for CUDA
tensors beside ``broadcast``, so the same code runs under NCCL and gloo.  A
gather is an all-reduce of a zeroed full-size buffer into which each rank
writes its slab (adding zeros is exact).  The gradients are those of the
global loss counted once: each rank's slab gradient is its rows of the
gradient of the one-device function.  So the sum over the ranks of a
replicated result has the identity as its backward, and a gather's backward
is an all-reduce of the cotangent, then this rank's slice
(``mesh.all_reduce_sum`` sums the ranks' cotangents instead, and would count
a loss replicated over ``mp`` ranks ``mp`` times).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pccf_torch.dist.sharding import Grid
from pccf_torch.kernels import api, chamfer, ops

Tensor = torch.Tensor


def _check_points(n: int, grid: Grid, axis: str) -> int:
    sp = grid.size(axis)
    if n % sp:
        raise ValueError(f'point count {n} not divisible by grid axis {axis!r} size {sp}')
    return sp


def _check_axes(grid: Grid, axis: str, batch_axis: str | None) -> None:
    for name in (axis, batch_axis):
        if name is not None:
            grid.size(name)  # an unknown axis raises
    if batch_axis == axis:
        raise ValueError(f'the batch and the points are cut over one grid axis {axis!r}')


def slab(x: Tensor, grid: Grid, axis: str = 'mp', batch_axis: str | None = None) -> Tensor:
    """This rank's slab of a global ``(B, N, C)`` tensor: its ``N / sp``
    points on ``axis`` and, with ``batch_axis``, its ``B / size`` clouds on
    that axis (``PartitionSpec(batch_axis, axis, None)``)."""
    _check_axes(grid, axis, batch_axis)
    sp = _check_points(x.shape[1], grid, axis)
    n_loc = x.shape[1] // sp
    x = x.narrow(1, grid.index(axis) * n_loc, n_loc)
    if batch_axis is not None:
        parts = grid.size(batch_axis)
        if x.shape[0] % parts:
            raise ValueError(f'batch {x.shape[0]} not divisible by grid axis {batch_axis!r} size {parts}')
        b_loc = x.shape[0] // parts
        x = x.narrow(0, grid.index(batch_axis) * b_loc, b_loc)
    return x


def _gathered(x: Tensor, grid: Grid, axis: str, dim: int) -> Tensor:
    """The axis-wide tensor, this rank's ``x`` at its place along ``dim``:
    an all-reduce of zeros but for each rank's slab, which is exact."""
    shape = list(x.shape)
    shape[dim] *= grid.size(axis)
    buf = x.new_zeros(shape)
    buf.narrow(dim, grid.index(axis) * x.shape[dim], x.shape[dim]).copy_(x)
    if grid.group(axis) is not None:
        dist.all_reduce(buf, group=grid.group(axis))
    return buf


def _summed(x: Tensor, grid: Grid, axis: str) -> Tensor:
    """The sum over the axis's ranks of their ``x``, as a new tensor."""
    x = x.contiguous().clone()
    if grid.group(axis) is not None:
        dist.all_reduce(x, group=grid.group(axis))
    return x


class _Gather(torch.autograd.Function):
    """:func:`_gathered`; backward: the all-reduce of the cotangent, then
    this rank's slice (every rank's use of the gathered tensor counts)."""

    @staticmethod
    def forward(ctx, x, grid, axis, dim):
        ctx.args = (grid, axis, dim, x.shape[dim])
        return _gathered(x, grid, axis, dim)

    @staticmethod
    def backward(ctx, g):
        grid, axis, dim, length = ctx.args
        return _summed(g, grid, axis).narrow(dim, grid.index(axis) * length, length), None, None, None


class _Psum(torch.autograd.Function):
    """:func:`_summed`; the result is replicated, so the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        return _summed(x, grid, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sp_chamfer(x: Tensor, y: Tensor, grid: Grid, axis: str = 'mp', batch_axis: str | None = None,
               reduction: str = 'mean') -> Tensor:
    """Chamfer distance ``(B_local,)`` of clouds whose points are cut over
    ``axis`` (``sp.py:59-113``): this rank's slabs ``x (B, N/sp, C)`` and
    ``y (B, M/sp, C)``; ``reduction`` ``'mean'`` (over each direction's
    points) or ``'sum'``.  Differentiable.  The nearest-neighbour kernel sees
    no tensor that requires grad."""
    _check_axes(grid, axis, batch_axis)
    sp, here = grid.size(axis), grid.index(axis)
    n, m, m_loc = x.shape[1] * sp, y.shape[1] * sp, y.shape[1]
    yg = _Gather.apply(y, grid, axis, 1)  # (B, M, C)
    with torch.no_grad():
        _, i1, _, i2 = api.nn_distance(x.detach(), yg.detach())
    dist1 = torch.sum(torch.square(x - chamfer.GatherRows.apply(yg, i1)), dim=-1)  # (B, N/sp): all of y present
    part2 = torch.sum(torch.square(yg - chamfer.GatherRows.apply(x, i2)), dim=-1)  # (B, M): this slab's minima
    fwd = _Psum.apply(torch.sum(dist1, dim=1), grid, axis)
    # the minimum over the ranks' partial minima, on the rank that holds those rows of y
    parts = _Gather.apply(part2[None], grid, axis, 0)  # (sp, B, M)
    dist2 = torch.amin(parts.narrow(2, here * m_loc, m_loc), dim=0)
    bwd = _Psum.apply(torch.sum(dist2, dim=1), grid, axis)
    if reduction == 'mean':
        return fwd / n + bwd / m
    return fwd + bwd


@torch.no_grad()
def sp_knn(x: Tensor, k: int, grid: Grid, axis: str = 'mp', batch_axis: str | None = None) -> Tensor:
    """Self-kNN indices ``(B_local, N/sp, k)`` int32 of this rank's points
    into the whole cloud (``sp.py:116-144``): sorted by distance, the lowest
    index first on ties (``jax.lax.top_k``'s order, as ``ops.knn``)."""
    _check_axes(grid, axis, batch_axis)
    d = ops.square_distance(x, _gathered(x, grid, axis, 1))
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].to(torch.int32)


class _MatchCost(torch.autograd.Function):
    """ApproxMatch cost ``(B,)`` of the sharded clouds; the gradients with
    the plan held constant, computed in the forward and scaled in the
    backward (``sp.py:186-227``)."""

    @staticmethod
    def forward(ctx, x1, x2, grid, axis):
        here = grid.index(axis)
        b, n_loc, m_loc = x1.shape[0], x1.shape[1], x2.shape[1]
        mult_l, mult_r = ops.emd_marginal_multipliers(n_loc * grid.size(axis), m_loc * grid.size(axis))
        x2g = _gathered(x2, grid, axis, 1)  # (B, M, C)
        d = ops.square_distance(x1, x2g)  # (B, N/sp, M)
        remain_l = torch.full((b, n_loc), mult_l, dtype=x1.dtype, device=x1.device)  # this rank's rows
        remain_r = torch.full((b, x2g.shape[1]), mult_r, dtype=x1.dtype, device=x1.device)
        match = torch.zeros_like(d)
        for level in ops.APPROX_MATCH_LEVELS:
            kernel = torch.exp(level * d)
            suml = torch.einsum('bnm,bm->bn', kernel, remain_r) + 1e-9
            ratio_l = remain_l / suml
            demand = _summed(torch.einsum('bnm,bn->bm', kernel, ratio_l), grid, axis) * remain_r
            consumption = torch.clamp_max(remain_r / (demand + 1e-9), 1.0)
            ratio_r = consumption * remain_r
            w = kernel * ratio_l[:, :, None] * ratio_r[:, None, :]
            match = match + w
            remain_l = torch.clamp_min(remain_l - torch.sum(w, dim=2), 0.0)
            remain_r = torch.clamp_min(remain_r - demand, 0.0)
        cost = _summed(torch.sum(match * torch.sqrt(torch.clamp_min(d, 0.0)), dim=(1, 2)), grid, axis)
        diff = x1[:, :, None, :] - x2g[:, None, :, :]  # (B, N/sp, M, 3)
        w = match * torch.rsqrt(torch.clamp_min(d, 1e-20))
        grad1 = torch.einsum('bnm,bnmc->bnc', w, diff)
        grad2 = _summed(-torch.einsum('bnm,bnmc->bmc', w, diff), grid, axis)  # (B, M, 3): keep this rank's rows
        ctx.save_for_backward(grad1, grad2.narrow(1, here * m_loc, m_loc).contiguous())
        return cost

    @staticmethod
    def backward(ctx, g):
        grad1, grad2 = ctx.saved_tensors
        return grad1 * g[:, None, None], grad2 * g[:, None, None], None, None


def sp_match_cost(x1: Tensor, x2: Tensor, grid: Grid, axis: str = 'mp', batch_axis: str | None = None) -> Tensor:
    """ApproxMatch EMD ``(B_local,)`` of clouds whose points are cut over
    ``axis`` (``sp.py:229-246``): the value and plan-constant gradients of
    ``ops.match_cost``, with ``N/sp x M`` of the plan on each rank."""
    _check_axes(grid, axis, batch_axis)
    return _MatchCost.apply(x1, x2, grid, axis)
