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

The kernel recomputes the Gibbs kernel in each of 25 pair sweeps
(:func:`schedule`) as the TPU kernel's folded ``exp2``, with the scalings
added in its exponent (``K v = 2^(s2 d2 - s2 rowmin + log2 v)``) and, in the
middle sweeps, the exponent from the expansion ``|x|² - 2 x·y + |y|²`` of the
JAX golden; every sweep after the first is launched programmatically
dependent on the one before.  Its cost and gradients are held to the plain
version within 1e-4 relative and 1e-3 relative L2, its Chamfer outputs bit
for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pccf_torch.kernels import _build, emd, ops


def plain(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, from the golden operations on the kernel's
    exact squared distances: ``cost, grad1, grad2, d1, i1, d2, i2``."""
    d = ops.pair_square_distance(x1, x2)
    return ops.sinkhorn_forward(x1, x2, d) + ops.nn_distance(x1, x2, d)


OWN = 4  # points of one side a thread of a sweep holds
SWEEP_THREADS = (512, 256)


class SweepPlan(NamedTuple):
    """The grids of ``csrc/sinkhorn.cu``'s sweeps (``shape_for``): blocks a
    sample and threads a block of the rows and the columns sweeps, and
    whether the sweeps are launched programmatically (both grids the same)."""
    row_blocks: int
    row_threads: int
    col_blocks: int
    col_threads: int
    pdl: bool


def _shape(points: int, b: int, sms: int) -> tuple[int, int]:
    for threads in SWEEP_THREADS:  # 16 warps a block where every SM still gets one, else 8
        blocks = -(-points // (threads // 32 * OWN))
        if threads == SWEEP_THREADS[-1] or blocks * b >= sms:
            return blocks, threads
    raise AssertionError


def sweep_plan(b: int, n: int, m: int, sms: int) -> SweepPlan:
    """The plan the kernel takes for ``(B, N, 3)`` against ``(B, M, 3)`` on a
    card of ``sms`` SMs."""
    rows, cols = _shape(n, b, sms), _shape(m, b, sms)
    return SweepPlan(*rows, *cols, rows == cols)


def kernel_sweep_plan(b: int, n: int, m: int, sms: int) -> SweepPlan:
    """The same plan from the kernel library (``pccf_sinkhorn_plan``)."""
    out = (ctypes.c_int * 5)()
    _build.check('pccf_sinkhorn_plan', _build.lib().pccf_sinkhorn_plan(b, n, m, sms, out), f'b={b}, n={n}, m={m}')
    return SweepPlan(*out[:4], bool(out[4]))


def schedule(iters: int = ops.SINKHORN_ITERS) -> list[tuple[str, str]]:
    """The pair sweeps of one kernel call in launch order, ``(side, what)``:
    the build (rows: the minima, Chamfer's row side and u), then a v pass
    (columns) and a u pass (rows) in turn, the first v pass taking Chamfer's
    column side and the last grad2, then the final rows sweep (the cost and
    grad1).  ``csrc/sinkhorn.cu`` launches one kernel a sweep in this order,
    then the per-sample sum."""
    out = [('rows', 'build')]
    for it in range(1, iters + 1):
        out.append(('cols', 'chamfer' if it == 1 else 'final' if it == iters else 'middle'))
        if it < iters:
            out.append(('rows', 'middle'))
    return out + [('rows', 'final')]


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
    scratch = torch.empty(b * (7 * n + 5 * m), dtype=torch.float32, device=dev)  # each side's packs and state
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
