"""The sharded-point-axis losses of pccf_torch (``pccf_torch/dist/sp.py``) and
the ``(dp, mp)`` grid (``pccf_torch/dist/sharding.py``) against JAX's
``pccf/dist/sp.py``, on the CPU.

One spawn of four gloo ranks (what each runs is
``tests/torch_dist_ranks.py``'s ``sp_cases``, which imports no JAX) lays
them out as a 1-D grid of four and as a 2 x 2 grid, checks the grid's
errors and its row-major layout, and runs ``sp_chamfer`` (mean and sum),
``sp_match_cost`` and ``sp_knn`` on each rank's slab of the global clouds.
The reference is JAX's ``sp.py`` on ``Mesh(jax.devices()[:4], ('mp',))``
and ``make_2d_mesh(4, mp=2)`` of the conftest's virtual devices, from the
same inputs, with ``tests/test_sp.py``'s tolerances: values rtol 1e-5;
gradients rtol 1e-4, atol 1e-6, each rank's slab gradient placed into the
global layout (the slabs are disjoint), where it must equal ``jax.grad`` of
the global loss; kNN indices equal.  The match cost's gradients take as
atol the larger of 1e-6 and the largest difference between JAX's own two
routes at the same clouds (``sp.py`` on the mesh against
``ops.match_cost``; 3.8e-6 on the 1-D grid).  In process: a one-rank grid equals
the single-device operations, the nearest-neighbour dispatch never sees a
tensor that requires grad, and the grid's errors without a process group.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pccf.dist.sharding import make_2d_mesh
from pccf.dist.sp import sp_chamfer as jsp_chamfer, sp_knn as jsp_knn, sp_match_cost as jsp_match_cost
from pccf.kernels import ops as jops
from pccf_torch.dist import launch, make_2d_grid, slab, sp_chamfer, sp_knn, sp_match_cost
from pccf_torch.kernels import api, ops

from tests import torch_dist_ranks as ranks

torch.set_num_threads(1)

RANKS = 4
VALUE = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _clouds(b=4, n=64, m=64, seed=0):
    """``tests/test_sp.py``'s clouds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3)).astype(np.float32) / 2
    y = rng.standard_normal((b, m, 3)).astype(np.float32) / 2
    return x, y


def _jax_mesh(grid):
    return Mesh(np.asarray(jax.devices()[:RANKS]), ('mp',)) if grid == '1d' else make_2d_mesh(RANKS, mp=2)


# name -> (kind, grid, batch_axis, reduction, clouds)
CASES = {
    'chamfer_1d': ('chamfer', '1d', None, 'mean', _clouds()),
    'chamfer_2x2': ('chamfer', '2x2', 'dp', 'mean', _clouds()),
    'chamfer_sum': ('chamfer', '1d', None, 'sum', _clouds(b=2, n=32, m=64, seed=3)),
    'match_1d': ('match', '1d', None, None, _clouds(b=2, n=64, m=32, seed=1)),
    'match_2x2': ('match', '2x2', 'dp', None, _clouds(b=2, n=64, m=32, seed=1)),
    'knn_1d': ('knn', '1d', None, None, _clouds(b=3, n=64, seed=2)),
}
KNN_K = 8


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    """One spawn of four gloo ranks over every case; each rank's results."""
    out = tmp_path_factory.mktemp('sp')
    payload = [dict(kind=kind, grid=grid, batch_axis=batch_axis, reduction=reduction, x=x, y=y, k=KNN_K)
               for kind, grid, batch_axis, reduction, (x, y) in CASES.values()]
    torch.save(payload, out / 'cases.pt')
    launch(ranks.sp_cases, RANKS, 'gloo', str(out / 'cases.pt'), str(out))
    got = [torch.load(out / f'sp{r}.pt', weights_only=False) for r in range(RANKS)]
    return {'ranks': got, 'results': dict(zip(CASES, zip(*(g['results'] for g in got))))}


def _place(shape, parts, grid, batch_axis):
    """The ranks' slabs ``parts[r]`` summed into a zero global array."""
    out = np.zeros(shape, np.float32)
    for r, part in enumerate(parts):
        view = slab(torch.from_numpy(out), _RankGrid(r, grid), batch_axis=batch_axis)
        view += part
    return out


class _RankGrid:
    """Rank ``r``'s coordinates on the test's grids, as ``slab`` reads them."""

    def __init__(self, r: int, grid: str) -> None:
        self.r, self.mp = r, RANKS if grid == '1d' else 2

    def size(self, axis):
        return self.mp if axis == 'mp' else RANKS // self.mp

    def index(self, axis):
        return self.r % self.mp if axis == 'mp' else self.r // self.mp


def _jax_loss(kind, mesh, batch_axis, reduction):
    """The global loss and, beside it, the per-cloud values."""

    def loss(a, b):
        if kind == 'chamfer':
            value = jsp_chamfer(a, b, mesh, batch_axis=batch_axis, reduction=reduction)
        else:
            value = jsp_match_cost(a, b, mesh, batch_axis=batch_axis)
        return jnp.sum(value), value

    return loss


@pytest.mark.parametrize('name', ['chamfer_1d', 'chamfer_2x2', 'chamfer_sum', 'match_1d', 'match_2x2'])
def test_sp_losses_match_jax(spawned, name):
    kind, grid, batch_axis, reduction, (x, y) = CASES[name]
    mesh = _jax_mesh(grid)
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(kind, mesh, batch_axis, reduction), argnums=(0, 1),
                                                has_aux=True))
    (_, want), (gx, gy) = value_and_grad(jnp.asarray(x), jnp.asarray(y))
    want = np.asarray(want)
    results = spawned['results'][name]
    for r, res in enumerate(results):
        rows = want
        if batch_axis is not None:
            place = _RankGrid(r, grid)
            b_loc = len(want) // place.size(batch_axis)
            rows = want[place.index(batch_axis) * b_loc:(place.index(batch_axis) + 1) * b_loc]
        np.testing.assert_allclose(res['value'].numpy(), rows, **VALUE)
    atol = GRAD['atol']
    if kind == 'match':
        # the plan's top level, exp(-4^7 d), turns the rounding of d and of
        # each sum into relative errors of ~1e-3: JAX's own two routes (sp.py
        # on these four devices, ops.match_cost on one) part by up to 3.8e-6
        # at an element of these clouds whose terms cancel to 3e-3; the port
        # is held to JAX's sp.py within that spread where it passes 1e-6
        golden = jax.grad(lambda a, b: jnp.sum(jops.match_cost(a, b)), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        atol = max(atol, *(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip((gx, gy), golden)))
    np.testing.assert_allclose(_place(x.shape, [r['gx'] for r in results], grid, batch_axis), np.asarray(gx),
                               rtol=GRAD['rtol'], atol=atol)
    np.testing.assert_allclose(_place(y.shape, [r['gy'] for r in results], grid, batch_axis), np.asarray(gy),
                               rtol=GRAD['rtol'], atol=atol)


def test_sp_knn_matches_jax(spawned):
    _, grid, batch_axis, _, (x, _) = CASES['knn_1d']
    want = np.asarray(jsp_knn(jnp.asarray(x), KNN_K, _jax_mesh(grid)))
    got = np.concatenate([r['idx'].numpy() for r in spawned['results']['knn_1d']], axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jops.knn(jnp.asarray(x), KNN_K)))


def test_grid_is_row_major_with_its_row_and_column_groups(spawned):
    for r, res in enumerate(spawned['ranks']):
        one = res['layout']['1d']
        assert one['dp'] == (0, 1) and one['mp'] == (r, RANKS)
        assert one['groups'] == {'dp': None, 'mp': list(range(RANKS))}
        two = res['layout']['2x2']
        assert two['dp'] == (r // 2, 2) and two['mp'] == (r % 2, 2)
        assert two['groups'] == {'dp': [r % 2, r % 2 + 2], 'mp': [r - r % 2, r - r % 2 + 1]}


def test_ranks_raise_the_grid_and_divisibility_errors(spawned):
    """``make_2d_mesh``'s errors (``RuntimeError`` for too few devices,
    ``ValueError`` when ``mp`` does not divide) and ``_check_points``'s."""
    for res in spawned['ranks']:
        errors = res['errors']
        assert errors['indivisible'][0] == 'ValueError' and '4 % 3 != 0' in errors['indivisible'][1]
        assert errors['too_few'][0] == 'RuntimeError' and 'requested a 8-rank grid' in errors['too_few'][1]
        assert errors['points'][0] == 'ValueError' and 'not divisible' in errors['points'][1]


def test_grid_errors_without_a_process_group():
    with pytest.raises(RuntimeError, match='requested a 2-rank grid'):
        make_2d_grid(2, mp=1)
    with pytest.raises(ValueError, match='1 % 2 != 0'):
        make_2d_grid(1, mp=2)
    grid = make_2d_grid(1, mp=1)
    with pytest.raises(ValueError, match='unknown grid axis'):
        sp_chamfer(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3), grid, axis='tp')
    with pytest.raises(ValueError, match='one grid axis'):
        sp_knn(torch.zeros(1, 4, 3), 2, grid, batch_axis='mp')


def _grads(fn, x, y):
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    value = fn(tx, ty)
    value.sum().backward()
    return value.detach().numpy(), tx.grad.numpy(), ty.grad.numpy()


def test_one_rank_grid_equals_the_single_device_ops():
    """With one rank no collective runs: each SP function is the port's and
    JAX's single-device operation."""
    grid = make_2d_grid(1, mp=1)
    x, y = _clouds(b=2, n=64, m=32, seed=4)
    got = _grads(lambda a, b: sp_chamfer(a, b, grid), x, y)
    want = _grads(ops.chamfer, x, y)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD)
    got = _grads(lambda a, b: sp_match_cost(a, b, grid), x, y)
    cost, g1, g2 = ops.emd_forward(torch.from_numpy(x), torch.from_numpy(y))
    for a, b in zip(got, (cost, g1, g2)):
        np.testing.assert_allclose(a, b.numpy(), **GRAD)
    np.testing.assert_allclose(got[0], np.asarray(jops.match_cost(jnp.asarray(x), jnp.asarray(y))), **VALUE)
    idx = sp_knn(torch.from_numpy(x), KNN_K, grid)
    np.testing.assert_array_equal(idx.numpy(), ops.knn(torch.from_numpy(x), KNN_K).numpy())


def test_sp_chamfer_hands_the_nn_dispatch_no_grad_tensor(monkeypatch):
    """The counterpart of ``tests/test_sp.py``'s AD-less kernel: the
    dispatch stands in for a kernel wrapper that refuses a tensor that
    requires grad and returns plain results; the gradient still equals the
    single-device Chamfer's."""
    seen = []

    def kernel_like(a, b):
        seen.append((a.requires_grad, b.requires_grad, torch.is_grad_enabled()))
        if a.requires_grad or b.requires_grad:
            raise AssertionError('the nearest-neighbour kernel was handed a tensor that requires grad')
        return tuple(t.detach().clone() for t in ops.nn_distance(a, b))

    monkeypatch.setattr(api, 'nn_distance', kernel_like)
    x, y = _clouds(b=2, n=32, m=32, seed=5)
    grid = make_2d_grid(1, mp=1)
    got = _grads(lambda a, b: sp_chamfer(a, b, grid), x, y)
    want = _grads(ops.chamfer, x, y)
    assert seen == [(False, False, False)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD)
