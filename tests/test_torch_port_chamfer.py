"""The nearest-neighbour kernel's plain version and the Chamfer loss of
pccf_torch against the JAX package, on the CPU.

The plain version (what a CPU tensor runs, through the same autograd
functions that launch ``csrc/nn_distance.cu`` on a CUDA tensor) against
``pccf.kernels.ops.nn_distance`` and against the Pallas kernel
``pallas_chamfer.nn_distance_tpu`` in interpret mode, with exact duplicate
points so that distances tie; the shared backward of the distances against
the Pallas kernel's; then the Chamfer loss (the mean over the points, as
every objective takes it) and its gradients against ``chamfer_tpu``
(interpret mode, ``jax.grad``), with N != M.  Inputs are made with numpy from a seed.

Tolerances: argmins exact (ties go to the lowest index on every side, and
the random points leave no near-ties at these sizes); distances 1e-6
absolute against the Pallas kernel, which takes differences as the port does,
and 1e-5 relative against the jnp golden, which expands ``|x|² - 2 x·y +
|y|²``; the loss and its gradients 1e-5 relative.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.kernels import ops as jops
from pccf_torch.kernels import api, chamfer

torch.set_num_threads(1)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _clouds(n, m, seed, b=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 3)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((b, m, 3)) * 0.5).astype(np.float32)
    y[:, 40] = y[:, 3]  # exact ties: y3 and y40 are equally near to every x
    y[:, 41] = x[:, 7]  # a coincident pair: distance 0
    x[:, 100] = x[:, 7]
    return x, y


def _assert_nn_equal(got, want, **tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize('backend', ['jnp', 'pallas'])
def test_nn_distance_plain_matches_jax(backend, request):
    x, y = _clouds(256, 256, 0)
    got = chamfer.plain(torch.from_numpy(x), torch.from_numpy(y))
    assert not (got[1].numpy() == 40).any() and (got[1].numpy()[:, [7, 100]] == 41).all()
    assert (got[3].numpy()[:, 41] == 7).all()  # the lowest of the two coincident x
    if backend == 'pallas':
        request.getfixturevalue('interpret_pallas')
        from pccf.kernels.pallas_chamfer import nn_distance_tpu

        _assert_nn_equal(got, nn_distance_tpu(jnp.asarray(x), jnp.asarray(y)), rtol=0.0, atol=1e-6)
    else:
        _assert_nn_equal(got, jops.nn_distance(jnp.asarray(x), jnp.asarray(y)), rtol=1e-5, atol=1e-6)


def test_nn_distance_gradients_match_pallas(interpret_pallas):
    """The distances' gradients with the indices held (``_nnd_bwd``):
    ``nn_distance_grads``, the backward of every loss that holds Chamfer's
    argmins, under per-point cotangents."""
    from pccf.kernels.pallas_chamfer import nn_distance_tpu

    x, y = _clouds(256, 192, 1)
    rng = np.random.default_rng(2)
    c1, c2 = rng.standard_normal((2, 256)).astype(np.float32), rng.standard_normal((2, 192)).astype(np.float32)

    def jloss(a, b):
        d1, _, d2, _ = nn_distance_tpu(a, b)
        return jnp.sum(d1 * c1) + jnp.sum(d2 * c2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    _, i1, _, i2 = chamfer.plain(xs, ys)
    got = chamfer.nn_distance_grads(xs, ys, i1, i2, torch.from_numpy(c1), torch.from_numpy(c2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('n,m', [(256, 256), (256, 384)])
def test_chamfer_matches_pallas(interpret_pallas, n, m):
    from pccf.kernels.pallas_chamfer import chamfer_tpu

    x, y = _clouds(n, m, 3 + m)
    cot = np.asarray([0.7, 1.3], np.float32)

    def jloss(a, b):
        return jnp.sum(chamfer_tpu(a, b) * cot)

    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want, want_grads = chamfer_tpu(jx, jy), jax.grad(jloss, argnums=(0, 1))(jx, jy)
    xs, ys = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    got = api.chamfer(xs, ys)
    torch.sum(got * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    for g, w in zip((xs.grad, ys.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the golden, with its gradients through the gathered neighbours
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jops.chamfer(jx, jy)),
                               rtol=1e-5)
