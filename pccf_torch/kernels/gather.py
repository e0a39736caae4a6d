"""Neighbour gather and graph pools: the CUDA kernels ``csrc/graph_max_pool.cu``
and ``csrc/gather_scatter.cu``, their plain versions, and the autograd
functions that train through them.

Replaces, in ``pccf/kernels/pallas_gather.py``: the forward of
``graph_max_pool_tpu:218`` (``_pool_forward:80``; eval), its training forward
``_pool_src_forward:121`` and backward ``_scatter_add_slots:200``,
``graph_sum_pool_tpu:275`` (``_sum_pool_forward:256``), and
``gather_neighbors_tpu:329`` (``_gather_forward:309``); the backward of the
last two is ``_scatter_add_rows:182``.  The plain versions are in
:mod:`pccf_torch.kernels.ops`.  Each autograd function runs the kernels in its
forward and backward on a CUDA tensor and the plain versions on a CPU tensor.

The two pools read their rows from a channel slice of the sample held in
shared memory (``csrc/slice_pool.cuh``); :func:`pool_plan` mirrors how the
kernel picks the slice width and the centre ranges, and bounds the cloud at
:data:`MAX_POOL_ROWS` points.

The row scatter (the backward of sum-pool and gather) sums over the
transposed graph in ascending edge order, the order of ``index_add_`` on the
CPU: its result equals the plain version run on the CPU bit for bit, on every
run.  The slot scatter (the max-pool backward) adds with fp32 atomics, in an
order that changes from run to run: its sums agree with the plain version to
fp32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pccf_torch.kernels import _build, ops
from pccf_torch.kernels.knn import H100_SMS

plain = ops.graph_max_pool

# from slice_plan in csrc/slice_pool.cuh
SLICE_WIDTHS = (16, 8, 4)  # channels of a slice, widest first
MAX_SMEM = 232448  # shared memory a block can use on an H100 (kPoolMaxSmem)
PASS_CENTRES = 256  # centres a block reduces at once (kPoolPassCentres)
MAX_RANGES = 8  # centre ranges a slice is loaded for, at most (kPoolMaxRanges)


def pool_smem(n: int, w: int) -> int:
    """Dynamic shared memory of a block (``slice_smem``): the slice, a chunk
    of neighbour indices for its 256 centres (``2w + 1`` words each) and the
    mbarrier."""
    return n * w * 4 + PASS_CENTRES * (2 * w + 1) * 4 + 8


MAX_POOL_ROWS = (MAX_SMEM - pool_smem(0, 4)) // 16  # 13951: the points of the narrowest slice


class PoolPlan(NamedTuple):
    slice_width: int  # channels a block holds in shared memory
    ranges: int  # centre ranges per (sample, slice): blocks that load the same slice
    smem: int  # dynamic shared memory of a block, bytes (pool_smem)


def _pool_covers(b: int, n: int, c: int) -> bool:
    """Whether some slice width covers ``x (B, N, C)``: the 4-channel slice
    fits whenever ``N <= MAX_POOL_ROWS``."""
    return 1 <= b <= 65535 and 1 <= n <= MAX_POOL_ROWS and c >= 4 and c % 4 == 0


def pool_plan(b: int, n: int, c: int, slice_width: int | None = None, sms: int = H100_SMS) -> PoolPlan:
    """The plan of ``pccf_graph_max_pool`` and ``pccf_graph_sum_pool`` for
    ``x (B, N, C)`` (``slice_plan`` in ``csrc/slice_pool.cuh``): the widest
    slice that fits in shared memory, divides ``C`` and gives at least a
    third of the SMs a block, else the narrowest that fits; ``ranges`` the largest
    power of two that keeps ``B·(C/S)·ranges`` within one block an SM, with
    ranges of at least 256 centres and at most :data:`MAX_RANGES` of them.
    ``slice_width`` fixes the width (to time the others).  Raises
    ``ValueError`` past ``N <= 13951`` (:data:`MAX_POOL_ROWS`) or ``C % 4``."""
    def fits(w: int) -> bool:
        return c % w == 0 and pool_smem(n, w) <= MAX_SMEM

    def plan(w: int) -> PoolPlan:
        cap = max(1, min(MAX_RANGES, n // PASS_CENTRES))
        r = 1
        while 2 * r <= cap and b * (c // w) * 2 * r <= sms:
            r *= 2
        return PoolPlan(w, r, pool_smem(n, w))

    if not _pool_covers(b, n, c):
        raise ValueError(f'the graph pools\' kernel does not cover x ({b}, {n}, {c}): it takes N <= {MAX_POOL_ROWS} '
                         f'points (a 4-channel slice in {MAX_SMEM} bytes of shared memory), B <= 65535 and C % 4 == 0')
    if slice_width is not None:
        if slice_width not in SLICE_WIDTHS or not fits(slice_width):
            raise ValueError(f'the graph pools\' kernel does not cover x ({b}, {n}, {c}) in slices of {slice_width} '
                             f'channels: the width must be one of {SLICE_WIDTHS}, divide C and fit {MAX_SMEM} bytes')
        return plan(slice_width)
    for w in SLICE_WIDTHS:
        if fits(w):
            p = plan(w)
            if 3 * b * (c // w) * p.ranges >= sms:
                return p
    return p  # the narrowest slice, which always fits here: the most blocks


def kernel_pool_plan(b: int, n: int, c: int, slice_width: int | None = None) -> PoolPlan:
    """The plan the kernel library takes on the current card (``pccf_pool_plan``),
    to hold :func:`pool_plan` to it."""
    out = (ctypes.c_int * 3)()
    err = _build.lib().pccf_pool_plan(b, n, c, slice_width or 0, out)
    _build.check('pccf_pool_plan', err, f'({b}, {n}, {c}), slice width {slice_width}')
    return PoolPlan(*out)


def _launch_pool(name: str, x: torch.Tensor, idx: torch.Tensor, slice_width: int | None) -> torch.Tensor:
    b, n, c, k = _require_graph(x, idx)
    if slice_width is not None or not _pool_covers(b, n, c):
        pool_plan(b, n, c, slice_width)  # raises past the kernel's limits, before any launch
    out = torch.empty_like(x)
    err = getattr(_build.lib(), name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, k, slice_width or 0,
                                      _build.stream())
    _build.check(name, err, f'x {tuple(x.shape)}, k={k}, slice width {slice_width or "of the plan"}')
    return out


def _require_graph(x: torch.Tensor, idx: torch.Tensor) -> tuple[int, int, int, int]:
    """Validate ``x (B, N, C)`` float32 and ``idx (B, N, k)`` int32 on the card."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, C), got {tuple(x.shape)}')
    if idx.dim() != 3:
        raise ValueError(f'idx: expected (B, N, k), got {tuple(idx.shape)}')
    b, n, c = x.shape
    _build.require(idx, 'idx', torch.int32, (b, n, idx.shape[-1]))
    return b, n, c, idx.shape[-1]


def graph_max_pool_cuda(x: torch.Tensor, idx: torch.Tensor, slice_width: int | None = None) -> torch.Tensor:
    """``x (B, N, F)`` float32, ``idx (B, N, k)`` int32 with entries in
    ``[0, N)`` -> ``(B, N, F)``; ``F % 4 == 0``, ``k >= 1`` and ``N <= 13951``
    points (the guard of ``pccf_graph_max_pool``), past which it raises
    ``ValueError``.  ``slice_width`` overrides :func:`pool_plan`'s width, to
    time the others."""
    out = _launch_pool('pccf_graph_max_pool', x, idx, slice_width)
    graph_max_pool_cuda.launches += 1
    return out


def graph_max_pool_src_cuda(x: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-pool and the winning slot per channel: ``(B, N, F)`` float32 and
    ``(B, N, F)`` uint8; ``F % 4 == 0``, ``k <= 255``."""
    b, n, f, k = _require_graph(x, idx)
    out = torch.empty_like(x)
    slots = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    err = _build.lib().pccf_graph_max_pool_src(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), slots.data_ptr(), b, n, f, k, _build.stream()
    )
    _build.check('pccf_graph_max_pool_src', err, f'x {tuple(x.shape)}, k={k}')
    graph_max_pool_src_cuda.launches += 1
    return out, slots


def scatter_add_slots_cuda(g: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor, n: int) -> torch.Tensor:
    """Max-pool backward: ``g (B, M, F)`` onto the winning rows, ``(B, n, F)``."""
    b, m, f, k = _require_graph(g, idx)
    _build.require(slots, 'slots', torch.uint8, g.shape)
    dx = torch.empty((b, n, f), dtype=torch.float32, device=g.device)
    err = _build.lib().pccf_scatter_add_slots(
        g.data_ptr(), idx.data_ptr(), slots.data_ptr(), dx.data_ptr(), b, m, n, f, k, _build.stream()
    )
    _build.check('pccf_scatter_add_slots', err, f'g {tuple(g.shape)}, k={k}, n={n}')
    scatter_add_slots_cuda.launches += 1
    return dx


def graph_sum_pool_cuda(x: torch.Tensor, idx: torch.Tensor, slice_width: int | None = None) -> torch.Tensor:
    """``x (B, N, C)``, ``idx (B, N, k)`` with entries in ``[0, N)`` ->
    ``(B, N, C)`` neighbour sums, added in slot order from slot 0's row
    (:func:`ops.graph_sum_pool_slot_order` on the CPU, bit for bit);
    ``C % 4 == 0``, ``k >= 1`` and ``N <= 13951`` points (the guard of
    ``pccf_graph_sum_pool``), past which it raises ``ValueError``.
    ``slice_width`` overrides :func:`pool_plan`'s width, to time the others."""
    out = _launch_pool('pccf_graph_sum_pool', x, idx, slice_width)
    graph_sum_pool_cuda.launches += 1
    return out


def gather_neighbors_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, C)``, ``idx (B, N, k)`` -> ``(B, N, k, C)``; any ``C``."""
    b, n, c, k = _require_graph(x, idx)
    out = torch.empty((b, n, k, c), dtype=torch.float32, device=x.device)
    err = _build.lib().pccf_gather_neighbors(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, k, _build.stream()
    )
    _build.check('pccf_gather_neighbors', err, f'x {tuple(x.shape)}, k={k}')
    gather_neighbors_cuda.launches += 1
    return out


def scatter_add_rows_cuda(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``dx[b, idx[b, i, j]] += g[b, i]``: ``g (B, M, C)``, ``idx (B, M, k)``
    -> ``(B, n, C)``; each row's terms added in ascending ``(i, j)``.  The
    transposed graph (``2·B·M·k + B·(n+1)`` int32 and a few per chunk) is
    scratch of this call.  On the card it covers ``n <= 65536`` rows and
    ``M·k < 2^23`` edges a sample and raises ``ValueError`` past them."""
    b, m, c, k = _require_graph(g, idx)
    dx = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    words = _build.lib().pccf_scatter_add_rows_scratch(b, m, n, k)
    if words < 0:
        raise ValueError(f'pccf_scatter_add_rows: the kernel does not cover g {tuple(g.shape)}, k={k}, n={n}')
    scratch = torch.empty(words, dtype=torch.int32, device=g.device)
    err = _build.lib().pccf_scatter_add_rows(
        g.data_ptr(), idx.data_ptr(), dx.data_ptr(), scratch.data_ptr(), b, m, n, c, k, _build.stream()
    )
    _build.check('pccf_scatter_add_rows', err, f'g {tuple(g.shape)}, k={k}, n={n}')
    scatter_add_rows_cuda.launches += 1
    return dx


for _fn in (graph_max_pool_cuda, graph_max_pool_src_cuda, scatter_add_slots_cuda, graph_sum_pool_cuda,
            gather_neighbors_cuda, scatter_add_rows_cuda):
    _fn.launches = 0


def _scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    g = g.contiguous()
    return scatter_add_rows_cuda(g, idx, n) if _build.on_cuda(g) else ops.scatter_add_rows(g, idx, n)


class GraphMaxPool(torch.autograd.Function):
    """Max over the k neighbours; the gradient goes to the first winning slot
    of each channel (``pallas_gather.py:223-237``)."""

    @staticmethod
    def forward(ctx, x, idx):
        out, slots = graph_max_pool_src_cuda(x, idx) if _build.on_cuda(x) else ops.graph_max_pool_slots(x, idx)
        ctx.save_for_backward(idx, slots)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, slots = ctx.saved_tensors
        g = g.contiguous()
        n = idx.shape[1]
        if _build.on_cuda(g):
            return scatter_add_slots_cuda(g, idx, slots, n), None
        return ops.scatter_add_slots(g, idx, slots, n), None


class GraphSumPool(torch.autograd.Function):
    """Sum over the k neighbours; the backward is the row scatter-add
    (``pallas_gather.py:280-292``), which on the card takes clouds of at most
    65536 points and ``N·k < 2^23`` (:func:`scatter_add_rows_cuda`)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        return graph_sum_pool_cuda(x, idx) if _build.on_cuda(x) else ops.graph_sum_pool(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_rows(g, idx, idx.shape[1]), None


class GatherNeighbors(torch.autograd.Function):
    """Row gather ``(B, N, k, C)``; the backward flattens (centre, slot) into
    ``N·k`` rows of one neighbour each and scatter-adds them
    (``pallas_gather.py:341-352``), which on the card takes clouds of at most
    65536 points and ``N·k < 2^23`` (:func:`scatter_add_rows_cuda`)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        return gather_neighbors_cuda(x, idx) if _build.on_cuda(x) else ops.gather_neighbors(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, n, k, c = g.shape
        return _scatter_rows(g.reshape(b, n * k, c), idx.reshape(b, n * k, 1), n), None
