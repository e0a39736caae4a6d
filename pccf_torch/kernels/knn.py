"""Exact self-kNN: the CUDA kernel ``csrc/knn.cu`` and its plain version.

Replaces ``pccf/kernels/pallas_knn.py:183`` ``knn_tpu``.  The plain version is
:func:`pccf_torch.kernels.ops.knn` (distance matrix + stable sort)."""

from __future__ import annotations

import functools

import torch

from pccf_torch.kernels import _build, ops

plain = ops.knn

# from the guard of pccf_knn (csrc/knn.cu): kTile, kMaxK, kMaxSplits
TILE = 64  # centres per block, candidates per tile
MAX_K = 32
MAX_SPLITS = 16
H100_SMS = 132


def splits(b: int, n: int, sms: int = H100_SMS) -> int:
    """How many blocks share each cloud's candidates: the largest power of
    two that keeps the grid within one block an SM, at most
    :data:`MAX_SPLITS` and at most the cloud's tiles.  4 at serving's batch
    1, 1 from batch 5 up.  On an H100 a grid past one block an SM lost more
    to the merge than it gained (``chip_smoke.py`` times each choice beside
    half and twice as many splits; PERF.md)."""
    tiles = -(-n // TILE)
    s = 1
    while b * tiles * 2 * s <= sms and 2 * s <= min(MAX_SPLITS, tiles):
        s *= 2
    return s


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_cuda(x: torch.Tensor, k: int, n_splits: int | None = None) -> torch.Tensor:
    """``(B, N, C)`` float32 on the card -> ``(B, N, k)`` int32 indices;
    ``1 <= k <= min(32, N)`` and ``C <= 256`` (the guard of ``pccf_knn``): the
    encoder's 25, the classifier's 20 and graph filtering's 4.  The squared
    norms and, when the candidates are split (:func:`splits`), the partial
    lists go to scratch tensors allocated here.  ``n_splits`` overrides
    :func:`splits` (the card tests hold the lists to be the same whatever it
    is)."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, N, C), got {tuple(x.shape)}')
    b, n, c = x.shape
    s = n_splits or splits(b, n, _sms(x.device.index if x.device.index is not None else torch.cuda.current_device()))
    out = torch.empty((b, n, max(k, 0)), dtype=torch.int32, device=x.device)
    sq = torch.empty((b, n), dtype=torch.float32, device=x.device)
    part_d = part_i = None
    if s > 1 and 0 < k <= MAX_K:
        part_d = torch.empty((b, s, n, k), dtype=torch.float32, device=x.device)
        part_i = torch.empty((b, s, n, k), dtype=torch.int32, device=x.device)
    err = _build.lib().pccf_knn(x.data_ptr(), sq.data_ptr(), part_d.data_ptr() if part_d is not None else None,
                                part_i.data_ptr() if part_i is not None else None, out.data_ptr(), b, n, c, k, s,
                                _build.stream())
    _build.check('pccf_knn', err, f'x {tuple(x.shape)}, k={k}, {s} split(s)')
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0
