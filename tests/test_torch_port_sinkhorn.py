"""The Sinkhorn kernel's plain version and the ChamferSinkhorn loss of
pccf_torch against the JAX package, on the CPU.

The plain version (what a CPU tensor runs, through the same autograd
functions that launch ``csrc/sinkhorn.cu`` on a CUDA tensor) against the jnp
golden ``pccf.kernels.ops.sinkhorn_cost`` and its plan-constant VJP, and
against the Pallas kernel ``pallas_sinkhorn._call_sinkhorn_kernel`` in
interpret mode with Chamfer on, at N = M and N != M; then the
gradients of the fused ChamferSinkhorn pair against ``jax.grad`` of
``chamfer_sinkhorn_cost_tpu`` in interpret mode.  Inputs are made with numpy
from a seed.

Tolerances: the cost 1e-5 relative and the gradients 1e-5 of their largest
entry.  Both sides run the same float32 algorithm; the sums over the pairs
add in other orders, the golden expands ``|x|² - 2 x·y + |y|²`` where the
port takes differences, and the Pallas kernel computes ``exp`` as ``exp2``:
float32 rounding, well inside these bounds.  The Chamfer outputs: argmins
exact, minima 1e-7 absolute (XLA may fuse the distance's multiply-adds).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pccf.kernels import ops as jops
from pccf_torch.kernels import api, ops, sinkhorn

torch.set_num_threads(1)

COST_RTOL = 1e-5
GRAD_REL_MAX = 1e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _clouds(n, m, seed, b=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)) * 0.5).astype(np.float32), (rng.standard_normal((b, m, 3)) * 0.5).astype(
        np.float32)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0.0, atol=GRAD_REL_MAX * np.abs(w).max())


@pytest.mark.parametrize('distances', ['expanded', 'differences'])
def test_sinkhorn_matches_jnp(distances):
    """The port's cost and gradients against ops.sinkhorn_cost and its
    plan-constant custom VJP: ``ops.sinkhorn_forward`` on the golden's own
    expanded distances, and the kernel's plain version (distances from
    coordinate differences)."""
    x, y = _clouds(256, 256, 0)
    cot = np.asarray([1.3], np.float32)
    want, vjp = jax.vjp(jops.sinkhorn_cost, jnp.asarray(x), jnp.asarray(y))
    want_grads = vjp(jnp.asarray(cot))
    forward = ops.sinkhorn_forward if distances == 'expanded' else sinkhorn.plain
    cost, g1, g2 = forward(torch.from_numpy(x), torch.from_numpy(y))[:3]
    grads = (g1.numpy() * cot[0], g2.numpy() * cot[0])
    np.testing.assert_allclose(cost.numpy(), np.asarray(want), rtol=COST_RTOL)
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize('m', [512, 256])
def test_sinkhorn_plain_matches_pallas_kernel(interpret_pallas, m):
    """Every output of the kernel, against the Pallas kernel's."""
    from pccf.kernels.pallas_sinkhorn import _call_sinkhorn_kernel

    x, y = _clouds(512, m, m)
    want = [np.asarray(a) for a in _call_sinkhorn_kernel(jnp.asarray(x), jnp.asarray(y), jops.SINKHORN_EPS,
                                                         jops.SINKHORN_ITERS, True)]
    got = [a.numpy() for a in sinkhorn.plain(torch.from_numpy(x), torch.from_numpy(y))]
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(got[0], want[0][:, 0, 0], rtol=COST_RTOL)
    _assert_grads_close(got[1:3], want[1:3])
    d1, i1, d2, i2 = want[3][:, :, 0], want[4][:, :, 0], want[5][:, 0, :], want[6][:, 0, :]
    np.testing.assert_allclose(got[3], d1, rtol=0.0, atol=1e-7)
    np.testing.assert_array_equal(got[4], i1)
    np.testing.assert_allclose(got[5], d2, rtol=0.0, atol=1e-7)
    np.testing.assert_array_equal(got[6], i2)


def test_chamfer_sinkhorn_gradients_match_pallas(interpret_pallas):
    """The fused pair's values and its backward (Chamfer's analytic gradient
    plus the plan-constant one) against jax.grad of chamfer_sinkhorn_cost_tpu."""
    from pccf.kernels.pallas_sinkhorn import chamfer_sinkhorn_cost_tpu

    x, y = _clouds(512, 512, 5)
    cot_c, cot_s = 0.7, 1.9

    def jloss(a, b):
        cham, cost = chamfer_sinkhorn_cost_tpu(a, b)
        return cot_c * jnp.sum(cham) + cot_s * jnp.sum(cost), (cham, cost)

    (_, (jcham, jcost)), want = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                                                        jnp.asarray(y))
    xs, ys = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    cham, cost = api.chamfer_sinkhorn_cost(xs, ys)
    (cot_c * torch.sum(cham) + cot_s * torch.sum(cost)).backward()
    np.testing.assert_allclose(cham.detach().numpy(), np.asarray(jcham), rtol=COST_RTOL)
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(jcost), rtol=COST_RTOL)
    _assert_grads_close((xs.grad.numpy(), ys.grad.numpy()), want)
