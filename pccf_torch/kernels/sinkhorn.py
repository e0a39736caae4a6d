"""The Sinkhorn transport cost with Chamfer from the same launch: the CUDA
kernel ``csrc/sinkhorn.cu``, its plain version, and the autograd function of
the ChamferSinkhorn objective.

Replaces ``pccf/kernels/pallas_sinkhorn.py:163`` ``_call_sinkhorn_kernel`` as
``chamfer_sinkhorn_cost_tpu:257`` calls it, with Chamfer on (its other caller,
``sinkhorn_cost_tpu:234``, serves the Sinkhorn-alone loss, which no objective
of the JAX package composes).  The forward returns the cost, both
plan-constant gradients and the bidirectional nearest-neighbour minima and
argmins; the backward is the one of :mod:`~pccf_torch.kernels.emd`, whose
fused loss keeps the same residuals (``pallas_sinkhorn.py:276-289``).
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, emd, ops


def plain(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, from the golden operations on the kernel's
    exact squared distances: ``cost, grad1, grad2, d1, i1, d2, i2``."""
    d = ops.pair_square_distance(x1, x2)
    return ops.sinkhorn_forward(x1, x2, d) + ops.nn_distance(x1, x2, d)


def sinkhorn_cost_cuda(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``x1 (B, N, 3)``, ``x2 (B, M, 3)`` float32 on the card -> ``cost (B,),
    grad1 (B, N, 3), grad2 (B, M, 3), d1 (B, N), i1 (B, N) int32, d2 (B, M),
    i2 (B, M) int32``."""
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
    out = (torch.empty(b, dtype=torch.float32, device=dev), torch.empty_like(x1), torch.empty_like(x2),
           torch.empty((b, n), dtype=torch.float32, device=dev), torch.empty((b, n), dtype=torch.int32, device=dev),
           torch.empty((b, m), dtype=torch.float32, device=dev), torch.empty((b, m), dtype=torch.int32, device=dev))
    scratch = torch.empty(b * (3 * n + m), dtype=torch.float32, device=dev)
    err = _build.lib().pccf_sinkhorn_cost(
        x1.data_ptr(), x2.data_ptr(), b, n, m, mult_l, mult_r, ops.SINKHORN_EPS, ops.SINKHORN_ITERS,
        *(t.data_ptr() for t in out), scratch.data_ptr(), _build.stream(),
    )
    _build.check('pccf_sinkhorn_cost', err, f'x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}')
    sinkhorn_cost_cuda.launches += 1
    return out


sinkhorn_cost_cuda.launches = 0


class ChamferSinkhornCost(torch.autograd.Function):
    """``(chamfer (B,), sinkhorn (B,))`` of one cloud pair from one launch
    (``pallas_sinkhorn.py:256-289``), Chamfer the mean over the points of
    each direction."""

    @staticmethod
    def forward(ctx, x1, x2):
        if _build.on_cuda(x1):
            cost, g1, g2, d1, i1, d2, i2 = sinkhorn_cost_cuda(x1.contiguous(), x2.contiguous())
        else:
            cost, g1, g2, d1, i1, d2, i2 = plain(x1, x2)
        ctx.save_for_backward(x1, x2, i1, i2, g1, g2)
        return torch.mean(d1, dim=1) + torch.mean(d2, dim=1), cost

    backward = staticmethod(emd.ChamferMatchCost.backward)
