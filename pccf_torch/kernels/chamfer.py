"""Bidirectional nearest neighbours and the Chamfer distance: the CUDA kernel
``csrc/nn_distance.cu``, its plain version, and the autograd functions.

Replaces ``pccf/kernels/pallas_chamfer.py:78`` ``_nn_distance_raw``, which
serves ``chamfer_tpu:127`` and, through ``kernels/api.py:184``,
``nn_distance_tpu:66`` (:class:`NNDistance`, ``api.nn_distance``; the
sharded-point-axis Chamfer of :mod:`pccf_torch.dist.sp` takes its indices
from it).  The forward returns
each point's nearest squared distance and index in the other cloud; the
backward gathers the nearest points and scatter-adds with plain tensor
operations, as JAX does outside its kernel (``pallas_chamfer.py:109-153``),
the scatter through the row scatter's kernel on the card.
:func:`nn_distance_grads` is that backward, shared by every loss that holds
Chamfer's argmins (:mod:`~pccf_torch.kernels.emd`,
:mod:`~pccf_torch.kernels.sinkhorn`).

The kernel computes each pair's distance once and folds it into the row's
and the column's running minimum: a block owns :func:`nn_plan`'s rows of one
sample against all of ``y``, and a second launch combines each column's
partials over the row tiles.  The lexicographic (distance, index) minimum
does not depend on the order of combination, so the outputs equal the plain
version's bit for bit.
"""

from __future__ import annotations

import functools

import torch

from pccf_torch.kernels import _build, gather, ops


def plain(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, from the golden minima over the kernel's
    exact squared distances: ``d1, i1, d2, i2``."""
    return ops.nn_distance(x, y, ops.pair_square_distance(x, y))


ROWS_PER_WARP = 8  # rows of x each lane of a warp of csrc/nn_distance.cu holds
ROWS_PER_BLOCK = 64  # rows of x a block owns: 8 warps
MAX_SPLITS = 16


def nn_plan(b: int, n: int, sms: int) -> int:
    """Column splits of ``csrc/nn_distance.cu``: each (row tile, sample)
    block is cut into this many blocks over ranges of ``y``'s points, the
    fewest (a power of two up to 16) that give half the card's ``sms`` SMs a
    block: 1 at stage 1's (8, 2048) clouds, 8 at (2, 512)."""
    blocks = b * -(-n // ROWS_PER_BLOCK)
    splits = 1
    while splits < MAX_SPLITS and 2 * blocks * splits < sms:
        splits *= 2
    return splits


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nn_distance_cuda(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``x (B, N, 3)``, ``y (B, M, 3)`` float32 on the card -> ``d1 (B, N),
    i1 (B, N) int32, d2 (B, M), i2 (B, M) int32``, cut into
    :func:`nn_plan`'s column splits."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f'x: expected (B, N, 3), got {tuple(x.shape)}')
    b, n, _ = x.shape
    if y.dim() != 3:
        raise ValueError(f'y: expected (B, M, 3), got {tuple(y.shape)}')
    m = y.shape[1]
    _build.require(y, 'y', torch.float32, (b, m, 3))
    dev = x.device
    out = (torch.empty((b, n), dtype=torch.float32, device=dev), torch.empty((b, n), dtype=torch.int32, device=dev),
           torch.empty((b, m), dtype=torch.float32, device=dev), torch.empty((b, m), dtype=torch.int32, device=dev))
    splits = nn_plan(b, n, _sms(x.get_device()))
    # each row's partials over the splits and each column's over the row tiles
    scratch = torch.empty(2 * b * (splits * n + -(-n // ROWS_PER_BLOCK) * m), dtype=torch.float32, device=dev)
    err = _build.lib().pccf_nn_distance(x.data_ptr(), y.data_ptr(), b, n, m, *(t.data_ptr() for t in out),
                                        scratch.data_ptr(), splits, _build.stream())
    _build.check('pccf_nn_distance', err, f'x {tuple(x.shape)}, y {tuple(y.shape)}')
    nn_distance_cuda.launches += 1
    return out


nn_distance_cuda.launches = 0


def _forward(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    if _build.on_cuda(x):
        return nn_distance_cuda(x.contiguous(), y.contiguous())
    return plain(x, y)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _scatter_rows(rows: int, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g (B, N, C)`` added into the rows ``idx (B, N)`` of zeros ``(B, rows, C)``,
    each row's terms in ascending order: the row scatter's kernel on the
    card (``scatter_add_`` adds there with atomics, so a step would differ
    from run to run), its plain version on the CPU."""
    return gather.scatter_rows(g, idx.to(torch.int32)[..., None].contiguous(), rows)


def nn_distance_grads(x, y, i1, i2, g1, g2) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``d1 = |x - y[i1]|²`` and ``d2 = |y - x[i2]|²`` under the
    cotangents ``g1 (B, N)`` and ``g2 (B, M)`` (or any shape that broadcasts
    to them, such as ``(B, 1)``), the indices held constant
    (``pallas_chamfer.py:109-120``)."""
    gx1 = 2.0 * (x - _gather_rows(y, i1)) * g1[..., None]
    gy2 = 2.0 * (y - _gather_rows(x, i2)) * g2[..., None]
    return gx1 + _scatter_rows(x.shape[1], i2, -gy2), _scatter_rows(y.shape[1], i1, -gx1) + gy2


class GatherRows(torch.autograd.Function):
    """``x[b, idx[b, i]]``, ``(B, N, C)`` from ``x (B, M, C)`` and ``idx
    (B, N)``: ``take_along_axis``, whose gradient adds each row's terms
    through the ordered row scatter."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[1]
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_rows(ctx.rows, idx, g), None


class NNDistance(torch.autograd.Function):
    """``d1, i1, d2, i2`` with the analytic gradients of the distances, the
    indices held constant (``pallas_chamfer.py:57-123``, ``nn_distance_tpu``)."""

    @staticmethod
    def forward(ctx, x, y):
        d1, i1, d2, i2 = _forward(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _, g2, __):
        x, y, i1, i2 = ctx.saved_tensors
        return nn_distance_grads(x, y, i1, i2, g1, g2)


class Chamfer(torch.autograd.Function):
    """Chamfer distance ``(B,)``, the mean over the points of each direction
    (``pallas_chamfer.py:126-156``, ``reduction='mean'``, the reduction every
    objective of the JAX package uses)."""

    @staticmethod
    def forward(ctx, x, y):
        d1, i1, d2, i2 = _forward(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        return torch.mean(d1, dim=1) + torch.mean(d2, dim=1)

    @staticmethod
    def backward(ctx, g):
        x, y, i1, i2 = ctx.saved_tensors
        return nn_distance_grads(x, y, i1, i2, g[:, None] / x.shape[1], g[:, None] / y.shape[1])
