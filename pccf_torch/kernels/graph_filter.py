"""Graph filtering as one fused pass: the CUDA kernels ``csrc/graph_filter.cu``
and their plain versions, which the ``graph_filter`` op and its gradient,
the ``graph_filter_backward`` op (:mod:`pccf_torch.kernels.library`), run
behind ``api.graph_filtering``.

Replaces what ``pccf/kernels/api.py:178-181`` composes for graph filtering:
``knn_tpu`` at k = 4 (``pallas_knn.py:183``), ``gather_neighbors_tpu``
(``pallas_gather.py:329``, ``_gather_forward:309``) and the XLA fusion of
``pccf/kernels/ops.py:207-219``, forward and backward.  One wrapper call
finds each point's 4 nearest points (self included, the lists
``knn.knn_cuda(x, 4)`` gives, index for index), weights the three after slot
0 by ``exp(-dist / sigma)`` under the per-cloud bandwidth and writes the
sharpened cloud, the indices and the cloud's mean slot-1 distance, which the
backward reads.  The backward launches its kernel, then the row scatter
(``gather.scatter_add_rows_cuda``) over ``N·4`` rows of one neighbour: slot 0
carries the point's own term, slots 1..3 its neighbours'.

The plain versions: the forward is ``knn.plain`` then
``ops.graph_filtering_with_idx``; the backward (:func:`plain_backward`) is
the closed form in the kernel's order of operations, held against autograd
of the plain forward in the tests.  :func:`filter_plan` mirrors how the
kernel splits the search (``filter_plan`` in ``csrc/graph_filter.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pccf_torch.kernels import _build, gather, knn, ops
from pccf_torch.kernels.knn import H100_SMS

K = 4  # neighbours, self included (pccf/kernels/api.py:178)
MIN_SIGMA = 0.005  # the bandwidth's clamp (pccf/kernels/ops.py:216)
EPS = 1e-12  # the distance's guard (ops.py:215)

# from the guard and constants of csrc/graph_filter.cu
MAX_POINTS = 65536  # kMaxN: the row scatter's rows
SEARCH_THREADS = 256  # kSearchThreads: a search block
MAX_SPLITS = 32  # kMaxSplits: lanes a centre
POINT_THREADS = 256  # kPointThreads: the per-point launches


class FilterPlan(NamedTuple):
    splits: int  # lanes that share a centre's candidates
    centres: int  # centres a search block
    blocks: int  # search blocks a cloud


def _plan(splits: int, n: int) -> FilterPlan:
    centres = SEARCH_THREADS // splits
    return FilterPlan(splits, centres, -(-n // centres))


def filter_plan(b: int, n: int, sms: int = H100_SMS) -> FilterPlan:
    """The search's plan for ``x (B, N, 3)`` (``filter_plan`` in
    ``csrc/graph_filter.cu``): the fewest splits, a power of two up to
    :data:`MAX_SPLITS`, that give every SM a block.  2 splits at serving's
    batch 16, 4 at stage 1's 8 and at batch 5, 32 at batch 1."""
    p = _plan(1, n)
    while p.splits < MAX_SPLITS and b * p.blocks < sms:
        p = _plan(2 * p.splits, n)
    return p


def kernel_filter_plan(b: int, n: int, sms: int) -> FilterPlan:
    """The same plan from the kernel library (``pccf_graph_filter_plan``)."""
    out = (ctypes.c_int * 3)()
    err = _build.lib().pccf_graph_filter_plan(b, n, sms, out)
    _build.check('pccf_graph_filter_plan', err, f'b={b}, n={n}, {sms} SMs')
    return FilterPlan(*out)


# ------------------------------------------------------------ plain versions


def _terms(x: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``neigh (B, N, 3, 3)`` (slots 1..3), ``diff = x - neigh``, the squared
    sums ``s`` and ``dist = sqrt(|s| + 1e-12)`` ``(B, N, 3)``, as
    :func:`ops.graph_filtering_with_idx` computes them."""
    neigh = ops.gather_neighbors(x, idx)[:, :, 1:, :]
    diff = x[:, :, None, :] - neigh
    s = torch.sum(diff * diff, dim=-1)
    return neigh, diff, s, torch.sqrt(torch.abs(s) + EPS)


def plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``out (B, N, 3)``, ``idx (B, N, 4)`` int32 and the unclamped mean
    slot-1 distance ``(B,)``: ``knn.plain`` then ``ops.graph_filtering_with_idx``."""
    idx = knn.plain(x, K)
    return ops.graph_filtering_with_idx(x, idx), idx, torch.mean(_terms(x, idx)[3][:, :, 0], dim=1)


def _rows(x: torch.Tensor, idx: torch.Tensor, mean: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What the backward kernels write: ``rows (B, N·4, 3)`` and ``row_idx
    (B, N·4, 1)``, slot 0 the point's own term (row ``i``), slots 1..3 the
    neighbours' (rows ``idx[..., 1:]``), each term in the kernel's order of
    operations."""
    b, n, _ = x.shape
    neigh, diff, s, dist = _terms(x, idx)
    sigma = torch.clamp_min(mean, MIN_SIGMA)[:, None, None]
    w = torch.exp(-dist / sigma)
    a = (g[:, :, None, 0] * diff[..., 0] + g[:, :, None, 1] * diff[..., 1]) + g[:, :, None, 2] * diff[..., 2]
    aw = a * w
    t = aw * dist
    total = torch.sum((t[..., 0] + t[..., 1]) + t[..., 2], dim=1)
    # dL/dsigma through the clamp (a tie passes, as torch.clamp_min's
    # gradient does), then dL/dmean / N onto every slot-1 distance
    dsigma = torch.where(mean >= MIN_SIGMA, total / (sigma[:, 0, 0] * sigma[:, 0, 0]), 0.0)
    ddist = -(aw / sigma)
    ddist[..., 0] += (dsigma / n)[:, None]
    ds = torch.where(s > 0, ddist / (2.0 * dist), 0.0)
    ddiff = (2.0 * diff) * ds[..., None]
    one_plus = 1.0 + ((w[..., 0] + w[..., 1]) + w[..., 2])
    own = one_plus[..., None] * g + ((ddiff[:, :, 0] + ddiff[:, :, 1]) + ddiff[:, :, 2])
    dneigh = -(w[..., None] * g[:, :, None, :]) - ddiff
    rows = torch.cat([own[:, :, None, :], dneigh], dim=2).reshape(b, n * K, 3)
    centre = torch.arange(n, dtype=torch.int32, device=x.device).expand(b, n)[..., None]
    row_idx = torch.cat([centre, idx[..., 1:]], dim=2).reshape(b, n * K, 1)
    return rows.contiguous(), row_idx.contiguous()


def plain_backward(x: torch.Tensor, idx: torch.Tensor, mean: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dL/dx (B, N, 3)`` of graph filtering given ``g = dL/dout``, the
    indices and the mean the forward kept: the backward kernel's rows, then
    the row scatter's plain version (ascending edge order)."""
    rows, row_idx = _rows(x, idx, mean, g)
    return ops.scatter_add_rows(rows, row_idx, x.shape[1])


# ----------------------------------------------------------- the CUDA kernels


def graph_filter_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x (B, N, 3)`` float32 on the card -> ``out (B, N, 3)``, ``idx (B, N,
    4)`` int32 and the mean ``(B,)``, as :func:`plain` returns them; ``4 <= N
    <= 65536`` and ``B <= 65535`` (the guard of ``pccf_graph_filter``), past
    which it raises ``ValueError`` before any launch.  The partial sums of
    the mean (one a search block, at most ``N / 8`` a cloud) are scratch."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, 3), got {tuple(x.shape)}')
    b, n, c = x.shape
    out = torch.empty_like(x)
    idx = torch.empty((b, n, K), dtype=torch.int32, device=x.device)
    mean = torch.empty(b, dtype=torch.float32, device=x.device)
    partial = torch.empty(b * -(-n // (SEARCH_THREADS // MAX_SPLITS)), dtype=torch.float32, device=x.device)
    err = _build.lib().pccf_graph_filter(x.data_ptr(), out.data_ptr(), idx.data_ptr(), mean.data_ptr(),
                                         partial.data_ptr(), b, n, c, K, _build.stream())
    _build.check('pccf_graph_filter', err, f'x {tuple(x.shape)}, k={K}')
    graph_filter_cuda.launches += 1
    return out, idx, mean


def graph_filter_backward_cuda(x: torch.Tensor, idx: torch.Tensor, mean: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dL/dx (B, N, 3)`` from ``x``, ``idx`` and ``mean`` as
    :func:`graph_filter_cuda` returned them and ``g (B, N, 3)``: the backward
    kernel's rows, then ``gather.scatter_add_rows_cuda`` (counted there).
    The same guard as the forward."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, 3), got {tuple(x.shape)}')
    b, n, c = x.shape
    _build.require(idx, 'idx', torch.int32, (b, n, K))
    _build.require(mean, 'mean', torch.float32, (b,))
    _build.require(g, 'g', torch.float32, x.shape)
    rows = torch.empty((b, n * K, c), dtype=torch.float32, device=x.device)
    row_idx = torch.empty((b, n * K, 1), dtype=torch.int32, device=x.device)
    partial = torch.empty(b * -(-n // POINT_THREADS), dtype=torch.float32, device=x.device)
    err = _build.lib().pccf_graph_filter_backward(x.data_ptr(), idx.data_ptr(), mean.data_ptr(), g.data_ptr(),
                                                  rows.data_ptr(), row_idx.data_ptr(), partial.data_ptr(), b, n, c,
                                                  K, _build.stream())
    _build.check('pccf_graph_filter_backward', err, f'x {tuple(x.shape)}, k={K}')
    graph_filter_backward_cuda.launches += 1
    return gather.scatter_add_rows_cuda(rows, row_idx, n)


graph_filter_cuda.launches = 0
graph_filter_backward_cuda.launches = 0
