"""ApproxMatch EMD and Chamfer from one launch: the CUDA kernel ``csrc/emd.cu``,
its plain version, and the autograd functions of the reconstruction losses.

Replaces ``pccf/kernels/pallas_emd.py:218`` ``_call_emd_kernel``, which serves
``match_cost_tpu:302`` (EMD alone) and ``chamfer_match_cost_tpu:326`` (EMD and
Chamfer).  The forward returns the cost, both match-constant EMD gradients
and, with Chamfer, the bidirectional nearest-neighbour minima and argmins; the
backward scales the saved EMD gradients and adds the Chamfer gradients with
plain tensor operations, as JAX does outside its kernel
(``pallas_emd.py:353-371``).
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, ops


def plain(x1: torch.Tensor, x2: torch.Tensor, with_chamfer: bool = True) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, from the golden operations on the kernel's
    exact squared distances: ``cost, grad1, grad2`` and, with Chamfer,
    ``d1, i1, d2, i2``."""
    d = ops.pair_square_distance(x1, x2)
    out = ops.emd_forward(x1, x2, d)
    return out + ops.nn_distance(x1, x2, d) if with_chamfer else out


def chamfer_match_cost_cuda(x1: torch.Tensor, x2: torch.Tensor, with_chamfer: bool = True) -> tuple[torch.Tensor, ...]:
    """``x1 (B, N, 3)``, ``x2 (B, M, 3)`` float32 on the card -> ``cost (B,),
    grad1 (B, N, 3), grad2 (B, M, 3)`` [, ``d1 (B, N), i1 (B, N) int32,
    d2 (B, M), i2 (B, M) int32``]."""
    _build.require(x1, 'x1', torch.float32)
    if x1.dim() != 3 or x1.shape[-1] != 3:
        raise ValueError(f'x1: expected (B, N, 3), got {tuple(x1.shape)}')
    b, n, _ = x1.shape
    if x2.dim() != 3:
        raise ValueError(f'x2: expected (B, M, 3), got {tuple(x2.shape)}')
    m = x2.shape[1]
    _build.require(x2, 'x2', torch.float32, (b, m, 3))
    mult_l, mult_r = ops.emd_marginal_multipliers(n, m)
    dev = x1.device
    cost = torch.empty(b, dtype=torch.float32, device=dev)
    grad1, grad2 = torch.empty_like(x1), torch.empty_like(x2)
    scratch = torch.empty(b * (3 * n + 2 * m), dtype=torch.float32, device=dev)
    if with_chamfer:
        nn = (torch.empty((b, n), dtype=torch.float32, device=dev), torch.empty((b, n), dtype=torch.int32, device=dev),
              torch.empty((b, m), dtype=torch.float32, device=dev), torch.empty((b, m), dtype=torch.int32, device=dev))
        nn_ptrs = [t.data_ptr() for t in nn]
    else:
        nn, nn_ptrs = (), [None] * 4
    err = _build.lib().pccf_chamfer_match_cost(
        x1.data_ptr(), x2.data_ptr(), b, n, m, mult_l, mult_r, cost.data_ptr(), grad1.data_ptr(), grad2.data_ptr(),
        *nn_ptrs, scratch.data_ptr(), _build.stream(),
    )
    _build.check('pccf_chamfer_match_cost', err, f'x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}')
    chamfer_match_cost_cuda.launches += 1
    return (cost, grad1, grad2, *nn)


chamfer_match_cost_cuda.launches = 0


def _forward(x1: torch.Tensor, x2: torch.Tensor, with_chamfer: bool) -> tuple[torch.Tensor, ...]:
    if _build.on_cuda(x1):
        return chamfer_match_cost_cuda(x1.contiguous(), x2.contiguous(), with_chamfer)
    return plain(x1, x2, with_chamfer)


class MatchCost(torch.autograd.Function):
    """EMD ``(B,)`` with the plan held constant in the backward
    (``pallas_emd.py:301-322``)."""

    @staticmethod
    def forward(ctx, x1, x2):
        cost, g1, g2 = _forward(x1, x2, with_chamfer=False)
        ctx.save_for_backward(g1, g2)
        return cost

    @staticmethod
    def backward(ctx, g):
        g1, g2 = ctx.saved_tensors
        return g1 * g[:, None, None], g2 * g[:, None, None]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _scatter_rows(like: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like).scatter_add_(1, idx.long()[..., None].expand(-1, -1, like.shape[-1]), g)


class ChamferMatchCost(torch.autograd.Function):
    """``(chamfer (B,), emd (B,))`` of one cloud pair from one launch
    (``pallas_emd.py:325-374``); Chamfer takes the mean over the points of
    each direction, the reduction every objective of the JAX package uses."""

    @staticmethod
    def forward(ctx, x1, x2):
        cost, g1, g2, d1, i1, d2, i2 = _forward(x1, x2, with_chamfer=True)
        ctx.save_for_backward(x1, x2, i1, i2, g1, g2)
        return torch.mean(d1, dim=1) + torch.mean(d2, dim=1), cost

    @staticmethod
    def backward(ctx, g_cham, g_emd):
        x1, x2, i1, i2, eg1, eg2 = ctx.saved_tensors
        ge = g_emd[:, None, None]
        gc = g_cham[:, None, None]
        gx1 = (2.0 / x1.shape[1]) * (x1 - _gather_rows(x2, i1)) * gc
        gy2 = (2.0 / x2.shape[1]) * (x2 - _gather_rows(x1, i2)) * gc
        gx = eg1 * ge + gx1 + _scatter_rows(x1, i2, -gy2)
        gy = eg2 * ge + _scatter_rows(x2, i1, -gx1) + gy2
        return gx, gy
