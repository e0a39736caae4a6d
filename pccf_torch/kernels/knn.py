"""Exact self-kNN: the CUDA kernel ``csrc/knn.cu`` and its plain version.

Replaces ``pccf/kernels/pallas_knn.py:183`` ``knn_tpu``.  The plain version is
:func:`pccf_torch.kernels.ops.knn` (distance matrix + stable sort)."""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, ops

plain = ops.knn


def knn_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, N, C)`` float32 on the card -> ``(B, N, k)`` int32 indices;
    ``1 <= k <= min(32, N)`` (the guard of ``pccf_knn``)."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, C), got {tuple(x.shape)}')
    b, n, c = x.shape
    out = torch.empty((b, n, max(k, 0)), dtype=torch.int32, device=x.device)
    err = _build.lib().pccf_knn(x.data_ptr(), out.data_ptr(), b, n, c, k, _build.stream())
    _build.check('pccf_knn', err, f'x {tuple(x.shape)}, k={k}')
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0
