"""Graph filtering's fused pass (``pccf_torch/kernels/graph_filter.py``) on the CPU.

``api.graph_filtering`` runs the ``pccf::graph_filter`` op and its gradient,
the ``pccf::graph_filter_backward`` op (``pccf_torch/kernels/library.py``),
whose CPU implementations are the plain forward (``knn.plain``, then
``ops.graph_filtering_with_idx``) and the
closed-form backward written in the order of ``csrc/graph_filter.cu``'s
backward kernels (four rows a point, then the row scatter).  Its value and
gradient are held against ``pccf.kernels.api.graph_filtering`` and
``jax.vjp`` through it; on a cloud with exact duplicates the JAX backends
differ in which copy slot 0 holds, so there the reference is
``pccf.kernels.ops.graph_filtering_with_idx`` with the port's indices.  The
closed-form backward is held against autograd of the plain forward.  The
kernel's search is rehearsed in numpy: each lane of a centre group takes
every S-th candidate in rising index, marks a batch of 32 against a
threshold (its fourth best, -inf once that is 0, at most a bound the
group's lanes share) and enters the marked ones on a strict <, the lanes'
lists meet in a butterfly keeping the 4 smallest by (distance, index); it
must give the stable sort's first 4 whatever S.  ``graph_filter.filter_plan`` (the grid of
the search, mirrored from ``filter_plan`` in ``csrc/graph_filter.cu``) covers
every centre once.

Tolerances: the value 1e-5 relative and 1e-6 absolute (float32 chains in
another order; the same as ``tests/test_torch_port_train.py``'s graph
filtering test), the gradient 1e-4 relative and 1e-5 absolute against JAX;
the closed-form backward against autograd of the same plain forward 1e-5
relative (rel-L2, and each element within 1e-5 of itself or of the largest:
the two differ only in rounding, ~1e-7 rel-L2 here, but autograd takes
``dL/dw`` as ``g·x - g·y`` where the closed form takes ``g·(x - y)``).
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pccf.kernels import api as japi, ops as jops
from pccf_torch.kernels import api, graph_filter, library, ops

torch.set_num_threads(1)

N = 256
BATCH = 32  # kBatch of csrc/graph_filter.cu: candidates a lane marks before it enters them
SCALES = {'spread': 0.5, 'tight': 0.005, 'duplicates': 0.5}  # 'tight': the mean slot-1 distance below 0.005


def _cloud(b: int, kind: str, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((b, N, 3)) * SCALES[kind]).astype(np.float32)
    if kind == 'duplicates':  # three copies of one point, and a pair in every cloud
        x[0, 100] = x[0, 9]
        x[0, 200] = x[0, 9]
        x[:, 17] = x[:, 3]
    return x


def _port_value_and_grad(fn, x, cot):
    t = torch.tensor(x, requires_grad=True)
    out = fn(t)
    torch.sum(out * torch.from_numpy(cot)).backward()
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize('kind', ['spread', 'tight', 'duplicates'])
@pytest.mark.parametrize('b', [1, 3])
def test_graph_filtering_matches_jax(b, kind):
    x = _cloud(b, kind, 40 + b)
    cot = np.random.default_rng(50 + b).standard_normal((b, N, 3)).astype(np.float32)
    _, idx, mean = graph_filter.plain(torch.from_numpy(x))
    assert bool((mean < graph_filter.MIN_SIGMA).all()) == (kind == 'tight')
    assert bool((mean > graph_filter.MIN_SIGMA).all()) == (kind != 'tight')
    if kind == 'duplicates':
        # slot 0 of the later copies is the lowest-index copy, not the point itself
        assert idx[0, 100, 0] == 9 and idx[0, 200, 0] == 9 and bool((idx[:, 17, 0] == 3).all())
        jidx = jnp.asarray(idx.numpy())
        out, vjp = jax.vjp(lambda a: jops.graph_filtering_with_idx(a, jidx), jnp.asarray(x))
    else:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jops.knn(jnp.asarray(x), graph_filter.K)))
        out, vjp = jax.vjp(japi.graph_filtering, jnp.asarray(x))
    want, (wgrad,) = np.asarray(out), vjp(jnp.asarray(cot))
    got, ggrad = _port_value_and_grad(api.graph_filtering, x, cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(ggrad).all()
    np.testing.assert_allclose(ggrad, np.asarray(wgrad), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('kind', ['spread', 'tight', 'duplicates'])
def test_closed_form_backward_matches_autograd(kind):
    x = torch.from_numpy(_cloud(3, kind, 60))
    g = torch.from_numpy(np.random.default_rng(61).standard_normal((3, N, 3)).astype(np.float32))
    _, idx, mean = graph_filter.plain(x)
    xr = x.clone().requires_grad_(True)
    torch.sum(ops.graph_filtering_with_idx(xr, idx) * g).backward()
    want, got = xr.grad, graph_filter.plain_backward(x, idx, mean, g)
    assert torch.equal(library.graph_filter_backward(x, idx, mean, g), got)  # the op's CPU implementation
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_mean_is_the_bandwidth_before_its_clamp():
    """The forward's third output is the mean slot-1 distance that sets
    sigma = max(mean, 0.005): sigma recomputed from it gives the plain
    output."""
    x = torch.from_numpy(_cloud(2, 'spread', 62))
    out, idx, mean = graph_filter.plain(x)
    neigh = ops.gather_neighbors(x, idx)[:, :, 1:, :]
    dist = torch.sqrt(torch.abs(torch.sum((x[:, :, None, :] - neigh) ** 2, dim=-1)) + 1e-12)
    torch.testing.assert_close(mean, dist[:, :, 0].mean(1), rtol=0, atol=0)
    w = torch.exp(-dist / torch.clamp_min(mean, 0.005)[:, None, None])
    torch.testing.assert_close(out, (1 + w.sum(-1, keepdim=True)) * x - (w[..., None] * neigh).sum(2))


def _above(d) -> np.float32:
    return np.nextafter(np.float32(d), np.float32(np.inf))


def _search(v: np.ndarray, splits: int) -> np.ndarray:
    """The kernel's search over one cloud's expanded values ``v (N, N)``
    (rows: centres).  Lane s of a centre's group takes candidates s, s + S,
    ... (the cloud padded with candidates no centre takes).  The group's
    bound starts just above the smallest, over the lanes, of the 4th
    smallest distance among each lane's first 8 candidates.  In batches of
    32, a lane marks those where ``not v >= thr`` with the threshold as the
    batch found it, then enters the marked ones in rising index,
    ``(max(v, 0), j)`` on a strict < where ``not v >= thr`` still holds, thr
    being its list's fourth best (-inf once 0) at most the bound; after each
    batch the bound falls to just above the smallest fourth best of the
    lanes.  Then the lanes' lists meet in a butterfly of lexicographic
    4-smallest merges."""
    n = v.shape[0]
    span = BATCH * splits
    padded = -(-n // span) * span
    out = np.empty((n, 4), np.int64)
    for i in range(n):
        vi = np.concatenate([v[i], np.full(padded - n, np.inf, np.float32)])
        d = np.maximum(vi, np.float32(0.0))
        bound = _above(min(np.sort(d[s: s + 8 * splits: splits])[3] for s in range(splits)))
        lists = [[(np.inf, 2**31 - 1)] * 4 for _ in range(splits)]
        thr = [bound] * splits
        for p0 in range(0, padded, span):
            for s in range(splits):
                lst = lists[s]
                for j in [j for j in range(p0 + s, p0 + span, splits) if not vi[j] >= thr[s]]:
                    if not vi[j] >= thr[s] and d[j] < lst[3][0]:
                        lst = sorted(lst[:3] + [(d[j], j)], key=lambda e: e[0])  # stable: a tie keeps the listed
                        thr[s] = min(lst[3][0] if lst[3][0] > 0 else -np.inf, bound)
                lists[s] = lst
            bound = min(bound, _above(min(lst[3][0] for lst in lists)))
            thr = [min(t, bound) for t in thr]
        mask = 1
        while mask < splits:
            lists = [sorted(lists[s] + lists[s ^ mask])[:4] for s in range(splits)]
            mask <<= 1
        assert all(lst == lists[0] for lst in lists)
        out[i] = [j for _, j in lists[0]]
    return out


@pytest.mark.parametrize('splits', [1, 2, 8, 32])
def test_search_keeps_the_stable_sorts_first_four(splits):
    """Values with many exact ties, zeros and negatives (duplicates and the
    expansion's rounding below 0): the rehearsed search against the stable
    sort of ``max(v, 0)``, the plain version's order."""
    rng = np.random.default_rng(70 + splits)
    n = 96
    v = np.round(rng.standard_normal((n, n)) * 4).astype(np.float32) / 4
    v[rng.random((n, n)) < 0.1] = 0.0
    v[:, 40] = -1e-7
    d = np.maximum(v, np.float32(0.0))
    want = np.argsort(d, axis=1, kind='stable')[:, :4]
    np.testing.assert_array_equal(_search(v, splits), want)


@pytest.mark.parametrize('b,n', [(1, 2048), (5, 2048), (8, 2048), (16, 2048), (2, 512), (3, 300), (1, 4),
                                 (1, 65536)])
def test_filter_plan_covers_every_centre_once(b, n):
    """Every centre in one block, as many splits as give each of 132 SMs a
    block, or the most there are."""
    p = graph_filter.filter_plan(b, n, 132)
    assert p.splits & (p.splits - 1) == 0 and 1 <= p.splits <= graph_filter.MAX_SPLITS
    assert p.centres == 256 // p.splits
    assert (p.blocks - 1) * p.centres < n <= p.blocks * p.centres
    assert b * p.blocks >= 132 or p.splits == graph_filter.MAX_SPLITS
    assert p.splits == 1 or b * -(-n // (2 * p.centres)) < 132  # and no fewer would do
    if n == 2048:
        assert p.splits == {1: 32, 5: 4, 8: 4, 16: 2}[b]
