"""The graph pools' resident-slice schedule, rehearsed on the CPU.

The card's max- and sum-pool (``csrc/slice_pool.cuh``) cut each sample's
``(N, C)`` block into channel slices of S in {16, 8, 4} channels and each
slice's centres into ranges; a block copies its slice, all N rows, into
shared memory and reduces its centres' k rows from there.
``gather.pool_plan`` mirrors how the kernel picks S and the ranges; here it
is held, at every shape the paths and ``chip_smoke.py`` give it, to fit the
shared memory, to cover every (b, i, c) exactly once and to reload fewer
bytes than a kernel gathering from device memory reads, and to refuse a
cloud past the narrowest slice.  The schedule written out in torch, each
block reading only its slice, equals ``ops.graph_max_pool`` bit for bit (NaN
and ties included) and the sum in slot order
(``ops.graph_sum_pool_slot_order``), and both equal the JAX package's Pallas
pools run in interpret mode bit for bit.  Inputs are made with numpy from a
seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf_torch.kernels import gather, ops

torch.set_num_threads(1)

N = 2048  # the clouds' points


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def blocks(plan: gather.PoolPlan, b: int, n: int, c: int):
    """``(sample, channel slice, centre range)`` of every block the kernel
    launches: grid (C / S, ranges, B), ranges of ``ceil(N / ranges)`` centres."""
    s, span = plan.slice_width, -(-n // plan.ranges)
    for bb in range(b):
        for c0 in range(0, c, s):
            for r in range(plan.ranges):
                yield bb, slice(c0, c0 + s), range(r * span, min(n, (r + 1) * span))


def tiled(x: torch.Tensor, idx: torch.Tensor, reduce: str, slice_width: int | None = None) -> torch.Tensor:
    """The kernel's schedule: each block copies its slice of its sample and
    reduces its centres' rows of that copy in slot order, with the kernel's
    max (v wins when v > m or v is NaN) or plain fp32 adds."""
    b, n, c = x.shape
    out = torch.full_like(x, float('inf'))
    for bb, cs, centres in blocks(gather.pool_plan(b, n, c, slice_width), b, n, c):
        held = x[bb, :, cs].clone()
        rows = idx[bb, centres.start:centres.stop].long()
        acc = held[rows[:, 0]]
        for j in range(1, idx.shape[-1]):
            v = held[rows[:, j]]
            acc = torch.where((v > acc) | torch.isnan(v), v, acc) if reduce == 'max' else acc + v
        out[bb, centres.start:centres.stop, cs] = acc
    return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit where neither is NaN, and NaN at the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def graph_case(b: int, n: int, c: int, k: int, seed: int, nans: bool = False):
    """Random rows and neighbours with exact ties (row 40 a copy of row 7,
    both in every list), a hub row in 3/4 of the lists, and optionally NaNs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    x[:, 40] = x[:, 7]
    if nans:
        x[:, 11, ::3] = np.nan
        x[:, 12, 1::5] = np.nan
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[..., 1], idx[..., k - 1] = 7, 40
    idx[:, : 3 * n // 4, k // 2] = 11 if nans else 77
    if nans:
        idx[:, ::7, 0] = 12
    return torch.from_numpy(x), torch.from_numpy(idx)


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize('k', [20, 25])
@pytest.mark.parametrize('c', [64, 128, 256, 512])
@pytest.mark.parametrize('b', [1, 5, 8, 16, 32])
def test_pool_plan_at_the_paths_shapes(b, c, k):
    plan = gather.pool_plan(b, N, c)
    w = plan.slice_width
    # the slice, the staged indices (2w + 1 words for each of 256 centres) and the mbarrier
    assert plan.smem == N * w * 4 + 256 * (2 * w + 1) * 4 + 8 <= gather.MAX_SMEM == 232448
    assert c % w == 0 and 1 <= plan.ranges <= gather.MAX_RANGES
    cover = np.zeros((b, N, c), np.int32)
    for bb, cs, centres in blocks(plan, b, N, c):
        cover[bb, centres.start:centres.stop, cs] += 1
    assert (cover == 1).all()
    # slice reloads (each block loads all N rows of its slice) against what a
    # kernel that gathers each centre's k rows from device memory reads
    assert plan.ranges * b * N * c * 4 < b * N * k * c * 4


@pytest.mark.parametrize('b,c,want', [
    (16, 256, (16, 1)),  # the batch-16 request's widest max-pool: 256 blocks
    (8, 512, (16, 1)),  # stage 1's widest sum-pool
    (8, 128, (16, 2)),
    (1, 256, (16, 8)),
    (1, 128, (16, 8)),
    (1, 64, (8, 8)),  # batch 1 narrows the slice to reach a third of the SMs
    (1, 32, (4, 8)),
])
def test_pool_plan_choices(b, c, want):
    assert tuple(gather.pool_plan(b, N, c)[:2]) == want


def test_pool_plan_refuses_what_the_kernel_does_not_cover():
    assert gather.MAX_POOL_ROWS == 13951
    plan = gather.pool_plan(1, 13951, 64)
    assert plan.slice_width == 4 and plan.smem == 232440
    assert gather.pool_plan(16, 3103, 64).slice_width == 16  # the widest slice's last N
    assert gather.pool_plan(16, 3104, 64).slice_width == 8
    for shape in ((1, 13952, 64), (1, 2048, 6), (0, 2048, 64), (65536, 16, 64)):
        with pytest.raises(ValueError, match='does not cover'):
            gather.pool_plan(*shape)
    for width in (16, 8, 2, 32):
        with pytest.raises(ValueError, match='does not cover'):
            gather.pool_plan(1, 13951, 64, slice_width=width)
    with pytest.raises(ValueError, match='does not cover'):
        gather.pool_plan(1, 2048, 72, slice_width=16)  # 72 channels are not slices of 16


@pytest.mark.parametrize('n', [1, 255, 2048, 13951, 13952])
def test_the_launch_check_is_the_plans(n):
    """The wrappers check ``_pool_covers`` before each launch, not the whole
    plan: it holds exactly where the plan takes the shape without raising."""
    for b in (0, 1, 16, 65535, 65536):
        for c in (0, 3, 4, 6, 64, 72, 512):
            try:
                gather.pool_plan(b, n, c)
                planned = True
            except ValueError:
                planned = False
            assert gather._pool_covers(b, n, c) == planned, (b, n, c)


# --------------------------------------------------- the schedule, rehearsed


@pytest.mark.parametrize('width', [None, 16, 8, 4])
@pytest.mark.parametrize('b,n,c,k', [(2, 512, 64, 25), (3, 300, 48, 20), (1, 2048, 16, 4)])
def test_tiled_max_pool_is_bit_exact(b, n, c, k, width):
    x, idx = graph_case(b, n, c, k, seed=b * n + c, nans=True)
    got = tiled(x, idx, 'max', width)
    want = ops.graph_max_pool(x, idx)
    assert torch.isnan(want).any() and bits_equal(got, want)
    assert bits_equal(got, ops.graph_max_pool_slots(x, idx)[0])


@pytest.mark.parametrize('width', [None, 16, 8, 4])
@pytest.mark.parametrize('b,n,c,k', [(2, 512, 64, 25), (3, 300, 48, 20), (1, 2048, 16, 4)])
def test_tiled_sum_pool_adds_in_slot_order(b, n, c, k, width):
    x, idx = graph_case(b, n, c, k, seed=b * n + c + 1)
    rows = x[torch.arange(b)[:, None, None], idx.long()]  # (B, N, k, C)
    want = rows[:, :, 0].clone()
    for j in range(1, k):
        want = want + rows[:, :, j]
    got = tiled(x, idx, 'sum', width)
    assert torch.equal(got, want) and torch.equal(ops.graph_sum_pool_slot_order(x, idx), want)
    torch.testing.assert_close(got, ops.graph_sum_pool(x, idx), rtol=1e-5, atol=1e-5)  # torch.sum's own order


# ------------------------------------------------------ against the JAX kernels


@pytest.mark.parametrize('nans', [False, True])
def test_tiled_pools_match_pallas_interpret(interpret_pallas, nans):
    from pccf.kernels.pallas_gather import graph_max_pool_tpu, graph_sum_pool_tpu

    x, idx = graph_case(2, 256, 16, 5, seed=31 + nans, nans=nans)
    xj, ij = jnp.asarray(x.numpy()), jnp.asarray(idx.numpy())
    want_max = torch.from_numpy(np.asarray(graph_max_pool_tpu(xj, ij)).copy())
    assert bits_equal(tiled(x, idx, 'max'), want_max) and bits_equal(tiled(x, idx, 'max', 4), want_max)
    if not nans:
        # the Pallas kernel adds row by row in slot order (pallas_gather.py:246-249),
        # and XLA on the CPU keeps that order: bit-equal
        want_sum = torch.from_numpy(np.asarray(graph_sum_pool_tpu(xj, ij)).copy())
        assert torch.equal(tiled(x, idx, 'sum'), want_sum)
        assert torch.equal(ops.graph_sum_pool_slot_order(x, idx), want_sum)
