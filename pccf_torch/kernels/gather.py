"""Graph max-pool: the CUDA kernel ``csrc/graph_max_pool.cu`` and its plain
version.

Replaces the forward of ``pccf/kernels/pallas_gather.py:218``
``graph_max_pool_tpu``; the slot-scatter backward comes with training.  The
plain version is :func:`pccf_torch.kernels.ops.graph_max_pool`."""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, ops

plain = ops.graph_max_pool


def graph_max_pool_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, F)`` float32, ``idx (B, N, k)`` int32 -> ``(B, N, F)``;
    ``F % 4 == 0`` (the guard of ``pccf_graph_max_pool``)."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, F), got {tuple(x.shape)}')
    b, n, f = x.shape
    if idx.dim() != 3:
        raise ValueError(f'idx: expected (B, N, k), got {tuple(idx.shape)}')
    _build.require(idx, 'idx', torch.int32, (b, n, idx.shape[-1]))
    out = torch.empty_like(x)
    err = _build.lib().pccf_graph_max_pool(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, f, idx.shape[-1], _build.stream()
    )
    _build.check('pccf_graph_max_pool', err, f'x {tuple(x.shape)}, k={idx.shape[-1]}')
    graph_max_pool_cuda.launches += 1
    return out


graph_max_pool_cuda.launches = 0
