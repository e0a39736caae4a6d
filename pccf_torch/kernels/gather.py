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

The three pools (the eval max-pool, the training max-pool with its winning
slot, and the sum-pool) read their rows from a channel slice of the sample
held in shared memory (``csrc/slice_pool.cuh``); :func:`pool_plan` mirrors
how the kernel picks the slice width and the centre ranges, and bounds the
cloud at :data:`MAX_POOL_ROWS` points.  The training max-pool keeps the TPU
kernel's rule, strict ``>`` (:func:`ops.graph_max_pool_slots_strict`); its CPU
plain version takes ``argmax``, as ``pccf/kernels/ops.py`` does, and the two
differ only where a NaN lies past slot 0.

Neither scatter uses atomics, and each adds an element's terms in the order of
the TPU kernel, which is the order of ``index_add_`` / ``scatter_add_`` on the
CPU: its result equals the plain version run on the CPU bit for bit, on every
run.  The row scatter (the backward of sum-pool and gather) sums over the
transposed graph in ascending edge order.  The slot scatter (the max-pool
backward) holds a ``dx`` slice in shared memory and walks the centres in
ascending order; :func:`slot_scatter_plan` mirrors its slice width and row
ranges (``slot_scatter_plan`` in ``csrc/gather_scatter.cu``).

The pools' kernels and the slot scatter read channels in groups of four; a
width that is not a multiple of four (the LDGCNN's pools run at its
configured widths) is padded with zero channels in the wrapper and the
output cropped, which is exact: every channel is reduced on its own.
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


# from slot_scatter_plan in csrc/gather_scatter.cu
SLOT_CHUNK = 256  # centres a staged chunk a walking warp
SLOT_MAX_RANGES = 8  # row ranges a slice at most


def _slot_rows_pad(rows: int, w: int) -> int:
    """A held column: the rows rounded up to 8, and ``32 / w`` more (banks)."""
    return -(-rows // 8) * 8 + 32 // w


def _slot_staging(w: int) -> int:
    """``slot_staging``: two staging buffers of a chunk's winning rows (int32)
    and ``g`` values a channel, padded by ``32 / w``, and the sort's counts, an
    int a lane of each warp (``16 / w`` warps a channel, 512 threads a block;
    a chunk is ``SLOT_CHUNK`` centres at 16 channels, twice that below)."""
    chunk = SLOT_CHUNK * (1 if w == 16 else 2)
    return 16 * w * (chunk + 32 // w) + 128 * w * (16 // w)


def slot_scatter_smem(rows: int, w: int) -> int:
    """Dynamic shared memory of a slot-scatter block (``slot_smem``): the held
    ``dx`` slice, ``w`` padded columns of ``rows`` (fp32), and the staging."""
    return 4 * w * _slot_rows_pad(rows, w) + _slot_staging(w)


def slot_scatter_max_rows(w: int) -> int:
    """The most rows a block of ``w`` channels holds (``slot_max_rows``), a multiple of 8."""
    return ((MAX_SMEM - _slot_staging(w)) // (4 * w) - 32 // w) // 8 * 8


MAX_SLOT_SCATTER_ROWS = SLOT_MAX_RANGES * slot_scatter_max_rows(4)  # 98496


class SlotScatterPlan(NamedTuple):
    slice_width: int  # channels a block holds in shared memory, 16 / slice_width warps each
    ranges: int  # row ranges per (sample, slice): blocks that walk the same centres
    rows: int  # rows a range, a multiple of 8 (the last range may be shorter)
    smem: int  # dynamic shared memory of a block, bytes (slot_scatter_smem)


def _slot_scatter_covers(b: int, n: int, f: int) -> bool:
    """Whether some plan covers ``dx (B, N, F)``: the 4-channel slice in at most
    :data:`SLOT_MAX_RANGES` row ranges whenever ``N <= MAX_SLOT_SCATTER_ROWS``."""
    return 1 <= b <= 65535 and 1 <= n <= MAX_SLOT_SCATTER_ROWS and f >= 4 and f % 4 == 0


def slot_scatter_plan(b: int, n: int, f: int, slice_width: int | None = None, ranges: int | None = None,
                      sms: int = H100_SMS) -> SlotScatterPlan:
    """The plan of ``pccf_scatter_add_slots`` for ``dx (B, N, F)``
    (``slot_scatter_plan`` in ``csrc/gather_scatter.cu``): for each width, the
    fewest row ranges whose rows fit in shared memory; the widest slice whose
    ``B·(F/S)·ranges`` blocks fill three quarters of the SMs, else the
    narrowest that fits.  Every block walks all of its sample's centres, so
    more ranges add work where narrower slices do not.  ``slice_width`` and
    ``ranges`` fix the width and the ranges (at least the fewest), to time the
    others.
    Raises ``ValueError`` past ``N <= 98496`` (:data:`MAX_SLOT_SCATTER_ROWS`),
    ``F % 4`` or :data:`SLOT_MAX_RANGES`."""
    def plan(w: int) -> SlotScatterPlan | None:
        if f % w:
            return None
        least = -(-n // slot_scatter_max_rows(w))
        r = least if ranges is None else ranges
        if not least <= r <= SLOT_MAX_RANGES:
            return None
        rows = -(-n // r)
        rows = -(-rows // 8) * 8
        return SlotScatterPlan(w, r, rows, slot_scatter_smem(rows, w))

    if not _slot_scatter_covers(b, n, f):
        raise ValueError(f'the slot scatter\'s kernel does not cover dx ({b}, {n}, {f}): it takes N <= '
                         f'{MAX_SLOT_SCATTER_ROWS} rows ({SLOT_MAX_RANGES} ranges of a 4-channel slice in {MAX_SMEM} '
                         f'bytes of shared memory), B <= 65535 and F % 4 == 0')
    p = plan(slice_width) if slice_width in SLICE_WIDTHS else None
    if slice_width is None:
        for w in SLICE_WIDTHS:
            if (q := plan(w)) is not None:
                p = q
                if 4 * b * (f // w) * q.ranges >= 3 * sms:
                    break
    if p is None:
        raise ValueError(f'the slot scatter\'s kernel does not cover dx ({b}, {n}, {f}) in slices of {slice_width} '
                         f'channels and {ranges} row ranges: the width must be one of {SLICE_WIDTHS} and divide F, '
                         f'the ranges enough for the rows to fit and at most {SLOT_MAX_RANGES}')
    return p


def kernel_slot_scatter_plan(b: int, n: int, f: int, slice_width: int | None = None,
                             ranges: int | None = None) -> SlotScatterPlan:
    """The plan the kernel library takes on the current card
    (``pccf_slot_scatter_plan``), to hold :func:`slot_scatter_plan` to it."""
    out = (ctypes.c_int * 4)()
    err = _build.lib().pccf_slot_scatter_plan(b, n, f, slice_width or 0, ranges or 0, out)
    _build.check('pccf_slot_scatter_plan', err, f'({b}, {n}, {f}), slice width {slice_width}, {ranges} ranges')
    return SlotScatterPlan(*out)


def kernel_pool_plan(b: int, n: int, c: int, slice_width: int | None = None) -> PoolPlan:
    """The plan the kernel library takes on the current card (``pccf_pool_plan``),
    to hold :func:`pool_plan` to it."""
    out = (ctypes.c_int * 3)()
    err = _build.lib().pccf_pool_plan(b, n, c, slice_width or 0, out)
    _build.check('pccf_pool_plan', err, f'({b}, {n}, {c}), slice width {slice_width}')
    return PoolPlan(*out)


def _pad4(t: torch.Tensor) -> torch.Tensor:
    """``t`` with zero channels appended up to a multiple of four."""
    return t if t.shape[-1] % 4 == 0 else torch.nn.functional.pad(t, (0, -t.shape[-1] % 4))


def _crop(t: torch.Tensor, c: int) -> torch.Tensor:
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def _launch_pool(name: str, x: torch.Tensor, idx: torch.Tensor, slice_width: int | None) -> torch.Tensor:
    c_in = x.shape[-1]
    x = _pad4(x)
    b, n, c, k = _require_graph(x, idx)
    if slice_width is not None or not _pool_covers(b, n, c):
        pool_plan(b, n, c, slice_width)  # raises past the kernel's limits, before any launch
    out = torch.empty_like(x)
    err = getattr(_build.lib(), name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, k, slice_width or 0,
                                      _build.stream())
    _build.check(name, err, f'x {tuple(x.shape)}, k={k}, slice width {slice_width or "of the plan"}')
    return _crop(out, c_in)


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
    ``[0, N)`` -> ``(B, N, F)``; any ``F`` (padded to a multiple of 4),
    ``k >= 1`` and ``N <= 13951`` points (the guard of
    ``pccf_graph_max_pool``), past which it raises ``ValueError``.
    ``slice_width`` overrides :func:`pool_plan`'s width, to time the others."""
    out = _launch_pool('pccf_graph_max_pool', x, idx, slice_width)
    graph_max_pool_cuda.launches += 1
    return out


def graph_max_pool_src_cuda(x: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-pool and the winning slot per channel, ``(B, N, F)`` float32 and
    ``(B, N, F)`` uint8, by the TPU kernel's strict ``>``
    (:func:`ops.graph_max_pool_slots_strict` bit for bit); any ``F`` (padded
    to a multiple of 4), ``k <= 255`` and ``N <= 13951`` points (the pools'
    slice plan, :func:`pool_plan`), past which it raises ``ValueError``
    before any launch."""
    f_in = x.shape[-1]
    x = _pad4(x)
    b, n, f, k = _require_graph(x, idx)
    if not _pool_covers(b, n, f):
        pool_plan(b, n, f)  # raises past the kernel's limits, before any launch
    out = torch.empty_like(x)
    slots = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    err = _build.lib().pccf_graph_max_pool_src(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), slots.data_ptr(), b, n, f, k, _build.stream()
    )
    _build.check('pccf_graph_max_pool_src', err, f'x {tuple(x.shape)}, k={k}')
    graph_max_pool_src_cuda.launches += 1
    return _crop(out, f_in), _crop(slots, f_in)


def scatter_add_slots_cuda(g: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor, n: int,
                           slice_width: int | None = None, ranges: int | None = None) -> torch.Tensor:
    """Max-pool backward: ``g (B, M, F)`` onto the winning rows, ``(B, n, F)``,
    each element's terms added in ascending centre from 0.0
    (:func:`ops.scatter_add_slots` on the CPU, bit for bit); any ``F``
    (padded to a multiple of 4), ``k <= 255`` and ``n <= 98496`` rows
    (:func:`slot_scatter_plan`), past which it raises ``ValueError`` before
    any launch.  ``slice_width`` and ``ranges`` override the plan's, to time
    the others."""
    f_in = g.shape[-1]
    g, slots = _pad4(g), _pad4(slots)
    b, m, f, k = _require_graph(g, idx)
    _build.require(slots, 'slots', torch.uint8, g.shape)
    if slice_width is not None or ranges is not None or not _slot_scatter_covers(b, n, f):
        slot_scatter_plan(b, n, f, slice_width, ranges)  # raises past the kernel's limits, before any launch
    dx = torch.empty((b, n, f), dtype=torch.float32, device=g.device)
    args = (g.data_ptr(), idx.data_ptr(), slots.data_ptr(), dx.data_ptr(), b, m, n, f, k)
    if slice_width is None and ranges is None:
        err = _build.lib().pccf_scatter_add_slots(*args, _build.stream())
    else:
        err = _build.lib().pccf_scatter_add_slots_split(*args, slice_width or 0, ranges or 0, _build.stream())
    _build.check('pccf_scatter_add_slots', err, f'g {tuple(g.shape)}, k={k}, n={n}')
    scatter_add_slots_cuda.launches += 1
    return _crop(dx, f_in)


def graph_sum_pool_cuda(x: torch.Tensor, idx: torch.Tensor, slice_width: int | None = None) -> torch.Tensor:
    """``x (B, N, C)``, ``idx (B, N, k)`` with entries in ``[0, N)`` ->
    ``(B, N, C)`` neighbour sums, added in slot order from slot 0's row
    (:func:`ops.graph_sum_pool_slot_order` on the CPU, bit for bit); any
    ``C`` (padded to a multiple of 4), ``k >= 1`` and ``N <= 13951`` points (the guard of
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


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row scatter (:func:`ops.scatter_add_rows`) by device: the kernel
    on the card, the plain version on the CPU."""
    g = g.contiguous()
    return scatter_add_rows_cuda(g, idx, n) if _build.on_cuda(g) else ops.scatter_add_rows(g, idx, n)


class GraphMaxPool(torch.autograd.Function):
    """Max over the k neighbours; the gradient goes to the first winning slot
    of each channel (``pallas_gather.py:223-237``).  Where a NaN lies past
    slot 0, the card's slot is the TPU kernel's (strict ``>``) and the CPU's
    is ``argmax``'s, as in ``pccf/kernels/ops.py:126``."""

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
        return scatter_rows(g, idx, idx.shape[1]), None


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
        return scatter_rows(g.reshape(b, n * k, c), idx.reshape(b, n * k, 1), n), None
