"""The Sinkhorn and nearest-neighbour kernels' schedules, rehearsed on the CPU.

``csrc/sinkhorn.cu`` runs 25 pair sweeps (``sinkhorn.schedule``): a rows
build (the row minima, Chamfer's row side and u in one pass), then a v pass
(columns) and a u pass (rows) in turn, the first v pass on exact squared
distances with Chamfer's column side, the last with grad2, then the final
rows sweep.  Each sweep reads the other side's packs as the sweep before
wrote them and writes its own side's scaling and packs.  Written out here in
torch with the kernel's arithmetic: the folded scale s2 = fl32(-log2(e) /
eps), the exponent from the expansion (3 FMAs and an add on packs
``(-2 s2 q, s2 |q|² + t)``) in the middle sweeps and from the differences
in the others, ``ex2.approx``'s error (2 ulp, drawn at random) and flush to
zero below 2^-126; FMAs round once.  Its cost and gradients stay within the
card's tolerances (cost 1e-4 relative, gradients rel-L2 1e-3) of
``ops.sinkhorn_forward`` on exact distances, of the jnp golden
``pccf.kernels.ops.sinkhorn_cost`` with its VJP and of
``_call_sinkhorn_kernel`` in interpret mode with Chamfer on, at N = M and
N != M, and do not equal the plain version's bits; its Chamfer outputs
equal the plain version's.

``csrc/nn_distance.cu`` computes each distance once and folds it into the
row's and the column's running minimum: blocks of 64 rows (8 warps of 8) per
(row tile, sample, column split), the lanes of a warp striding over the
split's columns staged 512 at a time, the column's minimum over a warp's rows
as a tree of adjacent ranges, over the block's warps in rising row, then
a second launch over the splits (rows) and the row tiles (columns).  Written
out in that grouping with strict < everywhere, it equals ``chamfer.plain``
bit for bit and ``_nn_distance_raw`` in interpret mode in every index, its
distances within 2 ulp (XLA contracts that kernel's multiply-adds on the
CPU, which the card's and the plain version's rounding does not), with exact
duplicates (ties), a hub point, N != M and N not a multiple of the tile.
``chamfer.nn_plan`` and ``sinkhorn.sweep_plan`` cover every pair or point
once.  Inputs are made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf.kernels import ops as jops
from pccf_torch.kernels import chamfer, ops, sinkhorn

torch.set_num_threads(1)

SINKHORN_COST_RTOL = 1e-4  # chip_smoke.py's card tolerances
SINKHORN_GRAD_REL_L2 = 1e-3
LOG2E = 1.4426950408889634
EX2_REL_ERR = 2.0**-22  # ex2.approx.f32: at most 2 ulp


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


# ------------------------------------------------------------------ Sinkhorn


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def norm2(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return fma(z, z, fma(y, y, x * x))


def card_ex2(seed: int):
    """``ex2.approx.ftz.f32``: 2^x with its relative error drawn at random
    within its bound, results below 2^-126 flushed to zero."""
    gen = torch.Generator().manual_seed(seed)

    def ex2(x: torch.Tensor) -> torch.Tensor:
        y = torch.exp2(x.double())
        y = (y * (1.0 + EX2_REL_ERR * (2.0 * torch.rand(y.shape, generator=gen, dtype=torch.float64) - 1.0))).float()
        return torch.where(y < 2.0**-126, torch.zeros_like(y), y)

    return ex2


def folded_scale(eps: float) -> torch.Tensor:
    """s2 as the kernel's host code forms it from the float eps it is given."""
    return torch.tensor(-LOG2E / float(np.float32(eps)), dtype=torch.float32)


def make_pack(p: torch.Tensor, s2: torch.Tensor, t: torch.Tensor, expanded: bool) -> torch.Tensor:
    """A side's packs: expanded ``(-2 s2 p, s2 |p|² + t)``, differences ``(p, t)``."""
    if expanded:
        return torch.cat([(-2.0 * s2) * p, fma(s2, norm2(*p.unbind(-1)), t)[..., None]], -1)
    return torch.cat([p, t[..., None]], -1)


def exponent(own: torch.Tensor, pack: torch.Tensor, c: torch.Tensor, s2: torch.Tensor, expanded: bool):
    """``(B, P, Q)`` exponents of each own point against each staged pack, c
    the own point's term (s2 |p|² folded in for the expanded form)."""
    a = [pack[:, None, :, k] for k in range(4)]
    p = [own[:, :, None, k] for k in range(3)]
    w = a[3] + c[:, :, None]
    if expanded:
        return fma(p[0], a[0], fma(p[1], a[1], fma(p[2], a[2], w)))
    return fma(s2, norm2(p[0] - a[0], p[1] - a[1], p[2] - a[2]), w)


def first_min(d: torch.Tensor, dim: int):
    return ops._first_min(d, dim)


def sweep_schedule(x1: torch.Tensor, x2: torch.Tensor, ex2):
    """ChamferSinkhorn as ``csrc/sinkhorn.cu`` runs it.  Returns the seven
    outputs and the sweeps in order, ``(side, what)``; each sweep reads only
    the packs the sweep before wrote on the other side."""
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    mult_l, mult_r = ops.emd_marginal_multipliers(n, m)
    s2 = folded_scale(ops.SINKHORN_EPS)
    d = ops.pair_square_distance(x1, x2)  # sqdist's rounding: the sweeps on exact d2
    rows = {'points': x1, 'mult': mult_l}
    cols = {'points': x2, 'mult': mult_r}
    done, last_writer = [], None

    def sweep(side: str, what: str, state: dict, k_sums: torch.Tensor, term: torch.Tensor, out_expanded: bool):
        nonlocal last_writer
        assert last_writer != side  # the other side wrote the packs this sweep read
        state['scale'] = state['mult'] / torch.clamp_min(k_sums, 1e-30)
        state['pack'] = make_pack(state['points'], s2, torch.log2(state['scale']) + term, out_expanded)
        last_writer = side
        done.append((side, what))

    # build: the row minima (Chamfer's row side, the stabiliser) and u, on exact d2
    d1, i1 = first_min(d, -1)
    row_term = -(s2 * d1)
    sweep('rows', 'build', rows, ex2(fma(s2, d, row_term[:, :, None])).sum(-1), row_term, False)
    zero = torch.zeros((b, m))
    for it in range(1, ops.SINKHORN_ITERS + 1):
        staged = rows['pack']
        if it == 1:  # exact d2, the columns' minima: the build's differences packs
            d2, i2 = first_min(d, -2)
            e = fma(s2, d.transpose(1, 2), staged[:, None, :, 3])
            sweep('cols', 'chamfer', cols, ex2(e).sum(-1), zero, True)
        elif it == ops.SINKHORN_ITERS:  # the last u pass handed over differences packs
            e = exponent(x2, staged, zero, s2, False)
            k = ex2(e)
            sweep('cols', 'final', cols, k.sum(-1), zero, False)
            dd = norm2(*(x2[:, :, None, c] - staged[:, None, :, c] for c in range(3)))
            wi = k * torch.rsqrt(torch.clamp_min(dd, 1e-20))
            grad2 = cols['scale'][..., None] * (x2 * wi.sum(-1, keepdim=True) - wi @ x1)
        else:
            c = fma(s2, norm2(*x2.unbind(-1)), zero)
            sweep('cols', 'middle', cols, ex2(exponent(x2, staged, c, s2, True)).sum(-1), zero, True)
        if it < ops.SINKHORN_ITERS:
            c = fma(s2, norm2(*x1.unbind(-1)), row_term)
            k_sums = ex2(exponent(x1, cols['pack'], c, s2, True)).sum(-1)
            sweep('rows', 'middle', rows, k_sums, row_term, it + 1 < ops.SINKHORN_ITERS)
    # final rows: each row's cost and grad1 with the last u and v
    kv = ex2(exponent(x1, cols['pack'], row_term, s2, False))
    dd = norm2(*(x1[:, :, None, c] - x2[:, None, :, c] for c in range(3)))
    wi = kv * torch.rsqrt(torch.clamp_min(dd, 1e-20))
    done.append(('rows', 'final'))
    u = rows['scale']
    cost = (u * (wi * dd).sum(-1)).sum(-1)
    grad1 = u[..., None] * (x1 * wi.sum(-1, keepdim=True) - wi @ x2)
    return (cost, grad1, grad2, d1, i1, d2, i2), done


def _sinkhorn_clouds(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, n, 3)) * 0.5).astype(np.float32)
    y = (x[:, rng.integers(0, n, m)] + 0.05 * rng.standard_normal((1, m, 3))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_sweep_schedule_is_the_kernels():
    x1, x2 = _sinkhorn_clouds(64, 48, 0)
    _, done = sweep_schedule(x1, x2, card_ex2(0))
    assert done == sinkhorn.schedule() and len(done) == 25
    assert done[:3] == [('rows', 'build'), ('cols', 'chamfer'), ('rows', 'middle')]
    assert done[-2:] == [('cols', 'final'), ('rows', 'final')]
    assert all(a[0] != b[0] for a, b in zip(done, done[1:]))  # rows and columns in turn


def _sinkhorn_reference(kind: str, x1: torch.Tensor, x2: torch.Tensor):
    if kind == 'ops':
        return ops.sinkhorn_forward(x1, x2, ops.pair_square_distance(x1, x2))
    a, b = jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy())
    if kind == 'jnp':
        cost, vjp = jax.vjp(jops.sinkhorn_cost, a, b)
        g1, g2 = vjp(jnp.ones_like(cost))
        return [torch.from_numpy(np.array(v)) for v in (cost, g1, g2)]
    from pccf.kernels.pallas_sinkhorn import _call_sinkhorn_kernel

    out = _call_sinkhorn_kernel(a, b, jops.SINKHORN_EPS, jops.SINKHORN_ITERS, True)
    return [torch.from_numpy(np.array(v)) for v in (out[0][:, 0, 0], out[1], out[2])]


@pytest.mark.parametrize('n,m', [(512, 512), (512, 256)])
@pytest.mark.parametrize('reference', ['ops', 'jnp', 'pallas'])
def test_sweep_schedule_within_card_tolerances(reference, n, m, request):
    if reference == 'pallas':
        request.getfixturevalue('interpret_pallas')
    x1, x2 = _sinkhorn_clouds(n, m, n + m)
    got, _ = sweep_schedule(x1, x2, card_ex2(1))
    want = _sinkhorn_reference(reference, x1, x2)
    assert float(((got[0] - want[0]).abs() / want[0].abs()).max()) <= SINKHORN_COST_RTOL
    assert _rel_l2(got[1], want[1]) <= SINKHORN_GRAD_REL_L2 and _rel_l2(got[2], want[2]) <= SINKHORN_GRAD_REL_L2
    plain = sinkhorn.plain(x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(got[3:], plain[3:]))  # Chamfer's minima and argmins
    assert not torch.equal(got[0], plain[0])  # the rounding is real: exp2 moves the cost off the plain bits


@pytest.mark.parametrize('b,n,m', [(8, 2048, 2048), (8, 2048, 1024), (2, 512, 512), (2, 300, 77), (1, 33, 4100)])
@pytest.mark.parametrize('sms', [132, 114])
def test_sweep_plan_covers_every_point_once(b, n, m, sms):
    plan = sinkhorn.sweep_plan(b, n, m, sms)
    for points, blocks, threads in ((n, plan.row_blocks, plan.row_threads), (m, plan.col_blocks, plan.col_threads)):
        per_block = threads // 32 * sinkhorn.OWN
        owner = torch.zeros(points, dtype=torch.int64)
        for blk in range(blocks):  # a warp's lanes hold its OWN points; the block's warps follow each other
            first = blk * per_block
            owner[first:first + per_block] += 1
        assert bool((owner == 1).all())
        assert threads in sinkhorn.SWEEP_THREADS and (threads == 256 or blocks * b >= sms)
    assert plan.pdl == ((plan.row_blocks, plan.row_threads) == (plan.col_blocks, plan.col_threads))
    if (b, n, m, sms) == (8, 2048, 2048, 132):
        assert plan == (32, 512, 32, 512, True)


# ------------------------------------------------------- nearest neighbours

ROWS, WARPS, TILE = chamfer.ROWS_PER_WARP, chamfer.ROWS_PER_BLOCK // chamfer.ROWS_PER_WARP, 512


def lex_fold(best, best_i, d, i):
    """One strict-< step: (d, i) replaces (best, best_i) where d < best."""
    take = d < best
    return torch.where(take, d, best), torch.where(take, i, best_i)


def nn_fold_schedule(x: torch.Tensor, y: torch.Tensor, splits: int):
    """The kernel's two launches in its grouping: returns ``d1, i1, d2, i2``."""
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    tiles, cs = -(-n // chamfer.ROWS_PER_BLOCK), -(-m // splits)
    rows_p = tiles * chamfer.ROWS_PER_BLOCK
    xp = torch.full((b, rows_p, 3), float('inf'))  # rows past n at infinity
    xp[:, :n] = x
    d = ops.pair_square_distance(xp, y)  # (B, rows_p, M), sqdist's rounding; +inf past n
    col_i_all = torch.arange(m).expand(b, rows_p, m)
    row_d = torch.empty((b, splits, n))
    row_i = torch.empty((b, splits, n), dtype=torch.int64)
    col_d = torch.empty((b, tiles, m))
    col_i = torch.empty((b, tiles, m), dtype=torch.int64)
    for s in range(splits):
        c_begin, c_end = s * cs, min(m, (s + 1) * cs)
        # rows: per lane, its columns in rising index (c - c_begin = lane (mod 32)), strict <
        best = torch.full((b, rows_p, 32), float('inf'))
        best_i = torch.zeros((b, rows_p, 32), dtype=torch.int64)
        for c0 in range(c_begin, c_end, TILE):
            for t in range(min(TILE, c_end - c0)):
                lane, c = t % 32, c0 + t
                best[..., lane], best_i[..., lane] = lex_fold(best[..., lane], best_i[..., lane], d[..., c],
                                                              col_i_all[..., c])
        for o in (16, 8, 4, 2, 1):  # the butterfly: lexicographic (distance, index)
            ob, oi = best[..., torch.arange(32) ^ o], best_i[..., torch.arange(32) ^ o]
            take = (ob < best) | ((ob == best) & (oi < best_i))
            best, best_i = torch.where(take, ob, best), torch.where(take, oi, best_i)
        row_d[:, s], row_i[:, s] = best[:, :n, 0], best_i[:, :n, 0]
        # columns: a tree over each warp's 8 rows, then the block's warps in rising row
        dc = d[..., c_begin:c_end].reshape(b, tiles, WARPS, ROWS, -1)
        ic = torch.arange(rows_p).reshape(1, tiles, WARPS, ROWS, 1).expand_as(dc)
        w = 1
        while w < ROWS:
            lo, hi = dc[:, :, :, 0::2 * w], dc[:, :, :, w::2 * w]
            nd, ni = lex_fold(lo, ic[:, :, :, 0::2 * w], hi, ic[:, :, :, w::2 * w])
            dc, ic = dc.clone(), ic.clone()
            dc[:, :, :, 0::2 * w], ic[:, :, :, 0::2 * w] = nd, ni
            w *= 2
        cb, ci = dc[:, :, 0, 0], ic[:, :, 0, 0]
        for wp in range(1, WARPS):
            cb, ci = lex_fold(cb, ci, dc[:, :, wp, 0], ic[:, :, wp, 0])
        col_d[..., c_begin:c_end], col_i[..., c_begin:c_end] = cb, ci
    out = []
    for pd, pi in ((row_d, row_i), (col_d, col_i)):  # the second launch, in rising index
        best, best_i = pd[:, 0], pi[:, 0]
        for k in range(1, pd.shape[1]):
            best, best_i = lex_fold(best, best_i, pd[:, k], pi[:, k])
        out += [best, best_i.to(torch.int32)]
    return tuple(out)


def _nn_clouds(case: str, seed: int):
    rng = np.random.default_rng(seed)
    n, m = {'ties': (256, 256), 'hub': (200, 300), 'rect': (512, 96), 'ragged': (300, 77)}[case]
    x = (rng.standard_normal((2, n, 3)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((2, m, 3)) * 0.5).astype(np.float32)
    if case == 'ties':  # exact duplicates on both sides: distances tie, the lowest index wins
        y[:, 40] = y[:, 3]
        y[:, 41] = x[:, 7]
        x[:, 100] = x[:, 7]
        x[:, 130:140] = x[:, 120:130]
        y[:, 60:70] = y[:, 50:60]
    elif case == 'hub':  # one point of y nearest to most of x, and its duplicate later
        y[:, 5] = 0.0
        y[:, 250] = 0.0
        x[:, ::2] *= 0.01
    return torch.from_numpy(x), torch.from_numpy(y)


CASES = ['ties', 'hub', 'rect', 'ragged']


@pytest.mark.parametrize('splits', [1, 3, 8])
@pytest.mark.parametrize('case', CASES)
def test_nn_fold_schedule_is_the_plain_version(case, splits):
    x, y = _nn_clouds(case, CASES.index(case))
    got = nn_fold_schedule(x, y, splits)
    want = chamfer.plain(x, y)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    if case == 'ties':
        assert not bool((got[1] == 40).any()) and bool((got[3][:, 41] == 7).all())
    if case == 'hub':
        assert int((got[1] == 5).sum()) >= 100 and not bool((got[1] == 250).any())


@pytest.mark.parametrize('case', CASES)
def test_nn_fold_schedule_matches_pallas(case, interpret_pallas):
    from pccf.kernels.pallas_chamfer import _nn_distance_raw

    x, y = _nn_clouds(case, CASES.index(case))
    got = nn_fold_schedule(x, y, chamfer.nn_plan(x.shape[0], x.shape[1], 132))
    want = [torch.from_numpy(np.array(v)) for v in _nn_distance_raw(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))]
    for a, w in zip(got, want):
        if a.dtype == torch.int32:
            assert torch.equal(a, w)
        else:  # XLA contracts the Pallas kernel's multiply-adds on the CPU: within 2 ulp
            torch.testing.assert_close(a, w, rtol=2.0**-22, atol=0.0)


@pytest.mark.parametrize('b,n,m', [(8, 2048, 2048), (8, 2048, 1024), (2, 512, 512), (2, 300, 77), (1, 64, 900)])
def test_nn_plan_covers_every_pair_once(b, n, m):
    splits = chamfer.nn_plan(b, n, 132)
    assert splits == {(8, 2048): 1, (2, 512): 8, (2, 300): 8, (1, 64): 16}[(b, n)]
    tiles, cs = -(-n // chamfer.ROWS_PER_BLOCK), -(-m // splits)
    assert 2 * b * tiles * splits >= 132 or splits == chamfer.MAX_SPLITS
    seen = torch.zeros((n, m), dtype=torch.int64)  # one sample: the grid's y axis is the sample
    for tile in range(tiles):
        for s in range(splits):
            for warp in range(WARPS):
                row0 = tile * chamfer.ROWS_PER_BLOCK + warp * ROWS
                rows = slice(row0, min(n, row0 + ROWS))
                for lane in range(32):  # every lane holds the warp's 8 rows
                    seen[rows, s * cs + lane:min(m, (s + 1) * cs):32] += 1
    assert bool((seen == 1).all())
