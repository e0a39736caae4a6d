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

The row scatter (the backward of sum-pool and gather) sums over the
transposed graph in ascending edge order, the order of ``index_add_`` on the
CPU: its result equals the plain version run on the CPU bit for bit, on every
run.  The slot scatter (the max-pool backward) adds with fp32 atomics, in an
order that changes from run to run: its sums agree with the plain version to
fp32 rounding.
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, ops

plain = ops.graph_max_pool


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


def graph_max_pool_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, F)`` float32, ``idx (B, N, k)`` int32 -> ``(B, N, F)``;
    ``F % 4 == 0`` (the guard of ``pccf_graph_max_pool``)."""
    b, n, f, k = _require_graph(x, idx)
    out = torch.empty_like(x)
    err = _build.lib().pccf_graph_max_pool(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, f, k, _build.stream())
    _build.check('pccf_graph_max_pool', err, f'x {tuple(x.shape)}, k={k}')
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


def graph_sum_pool_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, C)``, ``idx (B, N, k)`` -> ``(B, N, C)`` neighbour sums;
    ``C % 4 == 0``."""
    b, n, c, k = _require_graph(x, idx)
    out = torch.empty_like(x)
    err = _build.lib().pccf_graph_sum_pool(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, k, _build.stream())
    _build.check('pccf_graph_sum_pool', err, f'x {tuple(x.shape)}, k={k}')
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
