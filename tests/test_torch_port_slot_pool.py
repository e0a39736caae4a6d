"""The training max-pool and its slot scatter, their schedules rehearsed on the CPU.

The card's ``graph_max_pool_src`` is the resident-slice pool of
``csrc/slice_pool.cuh`` with the TPU kernel's rule (``pallas_gather.py:111``):
slot 0 seeds the max and the slot, and a later slot takes over only where it
is strictly greater, so ties keep the earliest slot and a NaN past slot 0
never wins.  Its schedule, written out in torch block by block, is bit-exact
to ``ops.graph_max_pool_slots_strict`` (NaNs, ties and a hub row included)
and, without NaNs, to the CPU plain version ``ops.graph_max_pool_slots``.

The card's ``scatter_add_slots`` (``csrc/gather_scatter.cu``) holds a ``dx``
slice in shared memory: a block owns ``dx[b, r0:r1, c0:c0+S]``
(``gather.slot_scatter_plan``, held here to fit the shared memory and to own
every (b, row, channel) once), walks all of the sample's centres in chunks of
256, sorts each channel's terms of a chunk into lists by row (the placement
arithmetic mirrored here in numpy) and adds each list in ascending centre
order.  Its schedule equals ``ops.scatter_add_slots`` (``scatter_add_`` on the
CPU) with ``torch.equal``, terms whose sum depends on the order of adds
included, and both schedules equal the JAX package's Pallas kernels run in
interpret mode bit for bit.  The two JAX routes of the max-pool gradient
disagree on a NaN: the Pallas forward keeps the strict rule, ``ops._gmp_fwd``
takes ``argmax``; each matches its port counterpart.  Inputs are made with
numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf_torch.kernels import gather, ops
from tests.test_torch_port_slice_pool import bits_equal, blocks, graph_case, interpret_pallas  # noqa: F401 (a fixture)

torch.set_num_threads(1)

N = 2048  # the clouds' points
CHUNK = gather.SLOT_CHUNK


def slot_blocks(plan: gather.SlotScatterPlan, b: int, n: int, f: int):
    """``(sample, channel slice, rows r0:r1)`` of every block the slot scatter
    launches: grid (F / S, ranges, B), ranges of ``plan.rows`` rows."""
    s = plan.slice_width
    for bb in range(b):
        for c0 in range(0, f, s):
            for r in range(plan.ranges):
                yield bb, slice(c0, c0 + s), range(r * plan.rows, min(n, (r + 1) * plan.rows))


def tiled_slots(x: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot pool's schedule: each block of the pools' plan reduces its
    centres' rows of its slice in slot order, slot 0 seeding the max and the
    slot, a later slot taking over only where it is strictly greater."""
    b, n, c = x.shape
    out = torch.full_like(x, float('inf'))
    slots = torch.full(x.shape, 255, dtype=torch.uint8)
    for bb, cs, centres in blocks(gather.pool_plan(b, n, c), b, n, c):
        held = x[bb, :, cs].clone()
        rows = idx[bb, centres.start:centres.stop].long()
        best = held[rows[:, 0]]
        slot = torch.zeros(best.shape, dtype=torch.uint8)
        for j in range(1, idx.shape[-1]):
            cand = held[rows[:, j]]
            take = cand > best
            best = torch.where(take, cand, best)
            slot = torch.where(take, j, slot)
        out[bb, centres.start:centres.stop, cs] = best
        slots[bb, centres.start:centres.stop, cs] = slot
    return out, slots


def scatter_schedule(g: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor, n: int, width=None,
                     ranges=None) -> torch.Tensor:
    """The slot scatter's schedule: each block zeroes its rows of its slice,
    walks the sample's centres chunk by chunk in ascending order and, within a
    chunk, adds each (row, channel)'s terms in ascending centre order (the
    kernel's lists by row; a row's k-th term of the chunk goes in step k, where
    no two terms share a (row, channel)), then writes its rows once."""
    b, m, f = g.shape
    plan = gather.slot_scatter_plan(b, n, f, width, ranges)
    winners = torch.gather(idx.long(), 2, slots.long())  # (B, M, F)
    dx = torch.full((b, n, f), float('nan'))
    for bb, cs, rows in slot_blocks(plan, b, n, f):
        held = torch.zeros((len(rows), cs.stop - cs.start))
        for i0 in range(0, m, CHUNK):
            r = winners[bb, i0:i0 + CHUNK, cs] - rows.start
            v = g[bb, i0:i0 + CHUNK, cs]
            inside = (r >= 0) & (r < len(rows))
            col = torch.arange(r.shape[1]).expand_as(r)
            cell = torch.where(inside, r * r.shape[1] + col, -1).reshape(-1)  # centre-major: ascending i
            # a term's place among the chunk's earlier terms of its (row, channel)
            order = torch.sort(cell, stable=True)
            ranked = torch.arange(cell.numel()) - torch.searchsorted(order.values, order.values)
            rank = torch.empty_like(ranked).scatter_(0, order.indices, ranked)
            for step in range(int(rank.max()) + 1 if cell.numel() else 0):
                pick = (rank == step) & (cell >= 0)
                held.view(-1).index_put_((cell[pick],), held.view(-1)[cell[pick]] + v.reshape(-1)[pick])
        dx[bb, rows.start:rows.stop, cs] = held
    return dx


def slot_case(b: int, m: int, n: int, f: int, k: int, seed: int):
    """``g``, neighbours into n rows with a hub row (row 7 in half the lists)
    and random winning slots; four centres send every channel to row 5 with
    terms 1e8, 1, -1e8, 1 (within one batch of 32), four more to row 9
    across batches and chunks: in ascending order each row sums to 1."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, m, f)).astype(np.float32)
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    slots = rng.integers(0, k, (b, m, f)).astype(np.uint8)
    idx[:, : m // 2, 3] = 7 % n
    idx[np.isin(idx, (5 % n, 9 % n))] = 11 % n
    for centres, row in (((0, 1, 2, 3), 5 % n), ((31, 32, 255, 256), 9 % n)):
        for i, v in zip((c % m for c in centres), (1e8, 1.0, -1e8, 1.0)):
            idx[:, i, 0], slots[:, i], g[:, i] = row, 0, v
    return torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(slots)


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize('f', [64, 128, 256])
@pytest.mark.parametrize('b', [1, 8, 16])
def test_slot_scatter_plan_at_the_paths_shapes(b, f):
    for width, ranges in ((None, None), *((w, r) for w in gather.SLICE_WIDTHS for r in (1, 2, 4))):
        plan = gather.slot_scatter_plan(b, N, f, width, ranges)
        w = plan.slice_width
        parts = 16 // w  # warps a channel: 512 threads a block
        pad = -(-plan.rows // 8) * 8 + 32 // w
        # the held slice, two staging buffers of rows and g, the sort's counts
        chunk = CHUNK * (1 if w == 16 else 2)
        assert plan.smem == 4 * w * pad + 16 * w * (chunk + 32 // w) + 128 * w * parts <= gather.MAX_SMEM
        assert f % w == 0 and 1 <= plan.ranges <= gather.SLOT_MAX_RANGES and plan.rows % 8 == 0
        cover = np.zeros((b, N, f), np.int32)
        for bb, cs, rows in slot_blocks(plan, b, N, f):
            cover[bb, rows.start:rows.stop, cs] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize('b,f,want', [
    (8, 64, (4, 1)),  # stage 1's EdgeConv widths: 128 blocks each
    (8, 128, (8, 1)),
    (8, 256, (16, 1)),
    (16, 256, (16, 1)),
    (16, 64, (8, 1)),
    (1, 64, (4, 1)),  # too few blocks at any width: the narrowest, the most blocks
])
def test_slot_scatter_plan_choices(b, f, want):
    assert tuple(gather.slot_scatter_plan(b, N, f)[:2]) == want


def test_slot_scatter_plan_refuses_what_the_kernel_does_not_cover():
    assert gather.MAX_SLOT_SCATTER_ROWS == 8 * gather.slot_scatter_max_rows(4) == 98496
    assert gather.slot_scatter_plan(1, gather.MAX_SLOT_SCATTER_ROWS, 4) == (4, 8, 12312, gather.MAX_SMEM)  # full
    assert gather.slot_scatter_plan(1, 13951, 64).ranges == 2  # the pools' last cloud: two row ranges
    for shape in ((1, gather.MAX_SLOT_SCATTER_ROWS + 1, 4), (1, 2048, 6), (0, 2048, 64), (65536, 16, 64)):
        with pytest.raises(ValueError, match='does not cover'):
            gather.slot_scatter_plan(*shape)
    for width, ranges in ((2, None), (32, None), (16, None), (None, 9), (4, 0)):
        with pytest.raises(ValueError, match='does not cover'):
            gather.slot_scatter_plan(1, 2048, 72, width, ranges)  # 72 channels are not slices of 16
    with pytest.raises(ValueError, match='does not cover'):
        gather.slot_scatter_plan(1, 2561, 64, 16, 1)  # 2561 rows of 16 channels need two ranges


@pytest.mark.parametrize('n', [1, 2048, 13951, 98496, 98497])
def test_the_slot_launch_check_is_the_plans(n):
    """The wrapper checks ``_slot_scatter_covers`` before each launch, not the
    whole plan: it holds exactly where the plan takes the shape."""
    for b in (0, 1, 16, 65535, 65536):
        for f in (0, 3, 4, 6, 64, 72, 512):
            try:
                gather.slot_scatter_plan(b, n, f)
                planned = True
            except ValueError:
                planned = False
            assert gather._slot_scatter_covers(b, n, f) == planned, (b, n, f)


# --------------------------------------------------- the schedules, rehearsed


@pytest.mark.parametrize('b,n,c,k', [(2, 512, 64, 25), (3, 300, 48, 20), (1, 2048, 16, 4), (2, 256, 256, 25)])
def test_slot_pool_schedule_is_bit_exact(b, n, c, k):
    x, idx = graph_case(b, n, c, k, seed=b * n + c, nans=True)
    out, slots = tiled_slots(x, idx)
    want, want_slots = ops.graph_max_pool_slots_strict(x, idx)
    assert torch.isnan(want).any() and bits_equal(out, want) and torch.equal(slots, want_slots)
    x, idx = graph_case(b, n, c, k, seed=b * n + c + 1)
    out, slots = tiled_slots(x, idx)
    want, want_slots = ops.graph_max_pool_slots(x, idx)
    assert torch.equal(out, want) and torch.equal(slots, want_slots)


@pytest.mark.parametrize('width,ranges', [(None, None), (16, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize('b,m,n,f', [(2, 512, 512, 64), (1, 300, 2048, 16), (2, 600, 100, 32)])
def test_slot_scatter_schedule_adds_in_centre_order(b, m, n, f, width, ranges):
    if width is not None and f % width:
        pytest.skip(f'{f} channels are not slices of {width}')
    g, idx, slots = slot_case(b, m, n, f, 25, seed=m + n + f)
    got = scatter_schedule(g, idx, slots, n, width, ranges)
    want = ops.scatter_add_slots(g, idx, slots, n)
    assert torch.equal(got, want)
    assert (want[:, 5 % n] == 1.0).all()  # 1e8, 1, -1e8, 1 in this order


def test_the_order_of_adds_shows():
    """1e8, 1, -1e8, 1 into one row: 1 in ascending order, 0 added the other
    way round; the schedule and ``scatter_add_`` on the CPU give 1."""
    terms = torch.tensor([1e8, 1.0, -1e8, 1.0])
    assert float(((terms[0] + terms[1]) + terms[2]) + terms[3]) == 1.0
    assert float(((terms[3] + terms[2]) + terms[1]) + terms[0]) == 0.0
    g, idx, slots = slot_case(1, 300, 64, 8, 5, seed=3)
    assert torch.equal(scatter_schedule(g, idx, slots, 64), ops.scatter_add_slots(g, idx, slots, 64))


def place_lists(keys: np.ndarray, parts: int) -> list[list[int]]:
    """The kernel's stable counting sort of one channel's chunk (keys of 256
    centres, -1 out of range) into 32 * parts lists by key % (32 parts),
    written out as the kernel computes it: part p sorts batches [p * 8 /
    parts, +8 / parts); per batch, lane L's mask of the lanes whose key % 32
    == L (5 ballots) and the ballot of bit 5; counts packed at bit 16 * h;
    a scan of the totals over the lanes, the upper lists after the lower; a
    term's place is its list's start, the earlier parts' counts and its rank
    among the batch's lanes of its list.  Returns the lists' centres."""
    batches = keys.reshape(8, 32)
    lanes = np.arange(32)
    per = 8 // parts

    def ballot(bits):
        return int(sum(1 << int(i) for i in np.flatnonzero(bits)))

    owns, uppers, counts = [], [], np.zeros((parts, 32), np.int64)
    for p in range(parts):
        for t in range(p * per, (p + 1) * per):
            key = batches[t]
            m = np.full(32, ballot(key >= 0), np.int64)
            for bit in range(5):
                s = ballot((key >> bit) & 1)
                m &= np.where((lanes >> bit) & 1, s, ~s & 0xffffffff)
            up = ballot((key >> 5) & 1) if parts == 2 else 0
            owns.append(m)
            uppers.append(up)
            counts[p] += [bin(x & ~up & 0xffffffff).count('1') | bin(x & up).count('1') << 16 for x in m]
    total = counts.sum(0)
    start = np.cumsum(total) - total
    start += (int(np.sum(total)) & 0xffff) << 16
    place = np.full(256, -1)
    for p in range(parts):
        at = start + counts[:p].sum(0)
        for t in range(p * per, (p + 1) * per):
            key, m, up = batches[t], owns[t], uppers[t]
            for lane in range(32):
                if key[lane] < 0:
                    continue
                d, high = key[lane] & 31, bool((key[lane] >> 5) & 1) and parts == 2
                group = int(m[d]) & (up if high else ~up & 0xffffffff)
                base = int(at[d]) >> 16 if high else int(at[d]) & 0xffff
                place[t * 32 + lane] = base + bin(group & ((1 << lane) - 1)).count('1')
            at = at + [bin(x & ~up & 0xffffffff).count('1') | bin(x & up).count('1') << 16 for x in m]
    order = np.full(256, -1)
    inside = place >= 0
    assert len(set(place[inside])) == inside.sum()  # one place a term
    order[place[inside]] = np.flatnonzero(inside)
    lists, at = [], 0
    for h in range(parts):
        for lane in range(32):
            size = int(total[lane]) >> 16 * h & 0xffff
            lists.append(order[at:at + size].tolist())
            at += size
    return lists


@pytest.mark.parametrize('parts', [1, 2])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_the_lists_keep_each_rows_centres_in_order(parts, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2048 if seed else 40, 256)  # seed 0: few rows, many repeats
    keys[rng.random(256) < 0.1] = -1  # rows of another range
    lists = place_lists(keys, parts)
    assert len(lists) == 32 * parts
    for d, centres in enumerate(lists):
        assert centres == sorted(centres)  # ascending i
        assert all(keys[i] % (32 * parts) == d for i in centres)
    assert sorted(i for centres in lists for i in centres) == np.flatnonzero(keys >= 0).tolist()


# ------------------------------------------------------ against the JAX kernels


@pytest.mark.parametrize('nans', [False, True])
def test_schedules_match_pallas_interpret(interpret_pallas, nans):
    from pccf.kernels.pallas_gather import _pool_src_forward, _scatter_add_slots

    x, idx = graph_case(2, 256, 16, 5, seed=41 + nans, nans=nans)
    out, src = _pool_src_forward(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()))
    got_out, got_slots = tiled_slots(x, idx)
    assert bits_equal(got_out, torch.from_numpy(np.asarray(out).copy()))
    assert torch.equal(got_slots.long(), torch.from_numpy(np.asarray(src).astype(np.int64)))
    g = torch.from_numpy(np.random.default_rng(43).standard_normal((2, 256, 16)).astype(np.float32))
    g[:, :4] = torch.tensor([1e8, 1.0, -1e8, 1.0])[:, None]
    want = _scatter_add_slots(jnp.asarray(g.numpy()), jnp.asarray(idx.numpy()),
                              jnp.asarray(got_slots.numpy().astype(np.int32)), 256)
    assert torch.equal(scatter_schedule(g, idx, got_slots, 256), torch.from_numpy(np.asarray(want).copy()))


def test_the_two_jax_routes_part_on_a_nan(interpret_pallas):
    """The Pallas forward (strict >) and ``ops._gmp_fwd`` (``argmax``) give a
    NaN's gradient to different slots; the card's schedule follows the first,
    the CPU plain version the second."""
    from pccf.kernels import ops as jops
    from pccf.kernels.pallas_gather import _pool_src_forward

    x, idx = graph_case(1, 256, 16, 5, seed=44, nans=True)
    xj, ij = jnp.asarray(x.numpy()), jnp.asarray(idx.numpy())
    out, src = _pool_src_forward(xj, ij)
    best, (_, arg) = jops._gmp_fwd(xj, ij)
    src, arg = np.asarray(src), np.asarray(arg)
    assert (src != arg).any()  # a NaN past slot 0 wins argmax, never the strict >
    got_out, got_slots = tiled_slots(x, idx)
    assert np.array_equal(got_slots.numpy(), src) and bits_equal(got_out, torch.from_numpy(np.asarray(out).copy()))
    plain_out, plain_slots = ops.graph_max_pool_slots(x, idx)
    assert np.array_equal(plain_slots.numpy(), arg)
    assert bits_equal(plain_out, torch.from_numpy(np.asarray(best).copy()))
