"""The orders of summation that the card's row scatter and ApproxMatch EMD
keep, rehearsed on the CPU.

The row scatter (``csrc/gather_scatter.cu``) sums each destination row's
terms over the transposed graph in ascending edge order e = i·k + j; the
plain version ``ops.scatter_add_rows`` (``index_add_`` on the CPU) is held
here to a sequential fp32 sum in that order, bit for bit, on graphs with a
hub row, unreached rows, a neighbour repeated in one centre's list and the
k = 1 layout of ``GatherNeighbors.backward``; the same inputs through JAX's
``_scatter_add_rows`` (``pccf/kernels/pallas_gather.py:182``, interpret
mode) agree within 1e-6.

The EMD kernel (``csrc/emd.cu``) runs 19 pair sweeps: rows P1 of the first
level, then for each level the columns P2 and a rows sweep that holds P3 of
that level and P1 of the next (P3 alone at the last).  Written out in torch
with each sweep reading the other side's state as it stood before the sweep,
the schedule equals ``ops.emd_forward`` bit for bit.  The kernel's
exponential, 2^(level·log2(e)·d²) with the folded level rounded once to
float32 and ``ex2.approx.ftz``'s error (2 ulp, drawn at random) and flush to
zero, and the fused sweep's K of a level as the fourth power of the next
level's, stays within the card's tolerances (cost 1e-4 relative, gradients
rel-L2 1e-3) of ``ops.emd_forward`` and of JAX's golden
(``pccf/kernels/ops.py:277-342``).  Inputs are made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf.kernels import ops as jops
from pccf_torch.kernels import gather, ops

torch.set_num_threads(1)

EMD_COST_RTOL = 1e-4  # chip_smoke.py's card tolerances, which the exp2 change must meet
EMD_GRAD_REL_L2 = 1e-3
LOG2E = 1.4426950408889634
EX2_REL_ERR = 2.0**-22  # ex2.approx.f32: at most 2 ulp


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


# ------------------------------------------------------------ the row scatter


def sequential_scatter(g: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """``dx[b, r] = (((0 + g[i0]) + g[i1]) + ...)`` in fp32 over the edges
    ``e = i·k + j`` with ``idx[b, i, j] = r``, in ascending e: the r-th term of
    every row is added in round r."""
    b, m, c = g.shape
    k = idx.shape[-1]
    dx = np.zeros((b, n, c), np.float32)
    for s in range(b):
        flat = idx[s].reshape(-1)
        order = np.argsort(flat, kind='stable')  # ascending e within each row
        dst, src = flat[order], order // k
        heads = np.r_[0, np.flatnonzero(np.diff(dst)) + 1]
        rank = np.arange(len(dst)) - np.repeat(heads, np.diff(np.r_[heads, len(dst)]))
        for r in range(rank.max() + 1):
            sel = rank == r
            dx[s, dst[sel]] = dx[s, dst[sel]] + g[s, src[sel]]
    return dx


def _graph(case: str, seed: int):
    """``(g (B, M, C), idx (B, M, k), n)`` with the feature under test."""
    rng = np.random.default_rng(seed)
    b, n = 2, 512
    if case == 'k1_flat':  # graph filtering's gather backward: (centre, slot) -> N·4 rows of one neighbour
        idx = rng.integers(0, n, (b, n, 4)).astype(np.int32).reshape(b, n * 4, 1)
        return rng.standard_normal((b, n * 4, 3)).astype(np.float32), idx, n
    m, c, k = n, 24, 25
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    if case == 'hub':
        idx[:, : 2 * m // 3, 7] = 11  # row 11 reached from 341 centres, and by chance
    elif case == 'empty_rows':
        idx[np.isin(idx, np.arange(100, 180))] = 99  # rows 100-179 reached by no edge
    elif case == 'repeat':
        idx[:, :, 3] = idx[:, :, 1]  # every centre lists one neighbour twice
        idx[:, 5, 10:20] = 42
    scale = 10.0 ** rng.integers(-3, 4, (b, m, 1))  # rows of many magnitudes: the order of the adds shows
    return (rng.standard_normal((b, m, c)) * scale).astype(np.float32), idx, n


CASES = ['hub', 'empty_rows', 'repeat', 'k1_flat']


@pytest.mark.parametrize('case', CASES)
def test_scatter_rows_is_the_sequential_sum_in_edge_order(case):
    g, idx, n = _graph(case, CASES.index(case))
    degree = np.stack([np.bincount(i.reshape(-1), minlength=n) for i in idx])
    feature = {'hub': lambda: degree.max() >= 300, 'empty_rows': lambda: (degree == 0).sum() >= 2 * 80,
               'repeat': lambda: (idx[:, :, 3] == idx[:, :, 1]).all(), 'k1_flat': lambda: idx.shape[-1] == 1}
    assert feature[case]()
    want = sequential_scatter(g, idx, n)
    got = ops.scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), n)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 'k1_flat':  # the same through the gather's autograd backward
        b = g.shape[0]
        x = torch.zeros((b, n, 3), requires_grad=True)
        gather.GatherNeighbors.apply(x, torch.from_numpy(idx.reshape(b, n, 4))).backward(
            torch.from_numpy(g.reshape(b, n, 4, 3)))
        np.testing.assert_array_equal(x.grad.numpy(), want)
    if case == 'empty_rows':
        assert not want[:, 100:180].any()


@pytest.mark.parametrize('case', CASES)
def test_listed_scatter_rows_is_the_sequential_sum_in_edge_order(case):
    """The plain row scatter's form off the CPU (each row's edges listed in
    ascending order, added one list slot at a time), run here on the CPU:
    bit-equal to the sequential sum and to ``index_add_``'s."""
    g, idx, n = _graph(case, CASES.index(case))
    gt, it = torch.from_numpy(g), torch.from_numpy(idx)
    rows = (it.long() + n * torch.arange(g.shape[0])[:, None, None]).reshape(-1)
    got = ops.scatter_add_rows_listed(gt, rows, idx.shape[-1], n)
    np.testing.assert_array_equal(got.numpy(), sequential_scatter(g, idx, n))
    assert torch.equal(got, ops.scatter_add_rows(gt, it, n))


@pytest.mark.parametrize('case', CASES)
def test_scatter_rows_matches_jax_pallas(case, interpret_pallas):
    from pccf.kernels.pallas_gather import _scatter_add_rows

    g, idx, n = _graph(case, CASES.index(case))
    got = ops.scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), n).numpy()
    want = np.asarray(_scatter_add_rows(jnp.asarray(g), jnp.asarray(idx), n))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale


# ---------------------------------------------------------- ApproxMatch EMD


def _clouds(seed: int, n: int = 256, m: int = 384):
    rng = np.random.default_rng(seed)
    x1 = (rng.standard_normal((2, n, 3)) * 0.5).astype(np.float32)
    x2 = (x1[:, rng.integers(0, n, m)] + 0.05 * rng.standard_normal((2, m, 3))).astype(np.float32)
    return torch.from_numpy(x1), torch.from_numpy(x2)


def torch_exp(level: float, d: torch.Tensor) -> torch.Tensor:
    return torch.exp(level * d)


def folded_exp2(seed: int):
    """The kernel's exponential: 2^(fl32(level·log2 e)·d) with ex2.approx's
    relative error drawn at random within its bound, results below 2^-126
    flushed to zero."""
    gen = torch.Generator().manual_seed(seed)

    def kexp(level: float, d: torch.Tensor) -> torch.Tensor:
        level2 = torch.tensor(level * LOG2E, dtype=torch.float32)
        k = torch.exp2(level2 * d)
        k = k * (1.0 + EX2_REL_ERR * (2.0 * torch.rand(k.shape, generator=gen) - 1.0))
        return torch.where(k < 2.0**-126, torch.zeros_like(k), k)

    return kexp


def sweep_schedule(x1: torch.Tensor, x2: torch.Tensor, kexp=torch_exp, k4: bool = False):
    """ApproxMatch as the card runs it: 19 sweeps, each a rows or a columns
    sweep that reads the other side's state as it stood before the sweep and
    writes only its own side's.  With ``k4`` a rows sweep that holds P3 of
    level L and P1 of the next takes K of L as (K of the next)^4, as the
    kernel does.  Returns ``(cost, grad1, grad2)`` and the sweeps in order."""
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    mult_l, mult_r = ops.emd_marginal_multipliers(n, m)
    d = ops.pair_square_distance(x1, x2)
    rows = {'remain': torch.full((b, n), mult_l), 'ratio': None, 'match': torch.zeros_like(d)}
    cols = {'remain': torch.full((b, m), mult_r), 'ratio': None}
    levels = ops.APPROX_MATCH_LEVELS

    def p1(kernel, state, other):
        state['ratio'] = state['remain'] / (torch.einsum('bnm,bm->bn', kernel, other['remain']) + 1e-9)

    def p3(kernel, state, other):
        w = kernel * state['ratio'][:, :, None] * other['ratio'][:, None, :]
        state['match'] = state['match'] + w
        state['remain'] = torch.clamp_min(state['remain'] - torch.sum(w, dim=2), 0.0)

    def p2(kernel, state, other):
        demand = torch.einsum('bnm,bn->bm', kernel, other['ratio']) * state['remain']
        state['ratio'] = torch.clamp_max(state['remain'] / (demand + 1e-9), 1.0) * state['remain']
        state['remain'] = torch.clamp_min(state['remain'] - demand, 0.0)

    sweeps = [('rows', [(p1, levels[0])])]
    for i, level in enumerate(levels):
        sweeps.append(('cols', [(p2, level)]))
        sweeps.append(('rows', [(p3, level)] + ([(p1, levels[i + 1])] if i + 1 < len(levels) else [])))
    for side, phases in sweeps:
        state, other = (rows, cols) if side == 'rows' else (cols, rows)
        before = dict(other)
        frozen = {k: None if v is None else v.clone() for k, v in other.items() if k != 'match'}
        kernels = [kexp(level, d) for _, level in phases]
        if k4 and len(phases) == 2:
            assert phases[0][1] == 4.0 * phases[1][1]
            kernels[0] = (kernels[1] * kernels[1]) * (kernels[1] * kernels[1])
        for (phase, _), kernel in zip(phases, kernels):
            phase(kernel, state, frozen)
        assert all(other[k] is before[k] for k in other)  # the other side untouched
    match = rows['match']
    cost = torch.sum(match * torch.sqrt(torch.clamp_min(d, 0.0)), dim=(1, 2))
    return (cost, *ops.match_cost_grads(x1, x2, match)), [(s, [(p.__name__, lv) for p, lv in ph]) for s, ph in sweeps]


def test_fused_sweep_schedule_equals_emd_forward():
    x1, x2 = _clouds(0)
    got, sweeps = sweep_schedule(x1, x2)
    assert len(sweeps) == 19 and sum(len(ph) for _, ph in sweeps) == 27
    assert sweeps[0] == ('rows', [('p1', -4.0**7)]) and sweeps[-1] == ('rows', [('p3', -0.25)])
    assert sweeps[2] == ('rows', [('p3', -4.0**7), ('p1', -4.0**6)])
    want = ops.emd_forward(x1, x2, ops.pair_square_distance(x1, x2))
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _jax_golden(x1: torch.Tensor, x2: torch.Tensor):
    a, b = jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy())
    match = jops.approx_match(a, b)
    return [torch.from_numpy(np.array(v)) for v in (jops._match_cost_from_match(a, b, match),
                                                       *jops._match_cost_grads(a, b, match))]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


@pytest.mark.parametrize('reference', ['ops', 'jax'])
def test_folded_exp2_within_card_tolerances(reference):
    x1, x2 = _clouds(1)
    got, _ = sweep_schedule(x1, x2, folded_exp2(2), k4=True)
    if reference == 'ops':
        want = ops.emd_forward(x1, x2, ops.pair_square_distance(x1, x2))
    else:
        want = _jax_golden(x1, x2)
    assert float(((got[0] - want[0]).abs() / want[0].abs()).max()) <= EMD_COST_RTOL
    assert _rel_l2(got[1], want[1]) <= EMD_GRAD_REL_L2 and _rel_l2(got[2], want[2]) <= EMD_GRAD_REL_L2
    # the rounding is real: exp2 moves the result off the plain version's bits
    assert not torch.equal(got[0], ops.emd_forward(x1, x2, ops.pair_square_distance(x1, x2))[0])
