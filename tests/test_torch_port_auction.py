"""The auction EMD of pccf_torch (``pccf_torch/kernels/auction_emd.py``) and
``api.nn_distance`` against the JAX package, on the CPU.

Every case of ``tests/test_auction_emd.py`` has its counterpart here, run
through ``api.auction_emd`` (on the CPU the plain version, on the port's own
squared distances).  Fed JAX's own ``square_distance`` matrix through ``d``,
the plain version reproduces JAX's assignment bit for bit and ``dis`` to
1e-6 (JAX's jitted loop fuses its distances) at the train and eval
contracts, an explicit ``k_active``, a batch of two and N < M; a batch that
mixes a cloud that converges with one that does not gives each cloud's
single-cloud result (the fact that lets the kernel run each cloud's loop
on its own).  The gradient of ``sum(dis)`` is held to ``jax.grad`` at rtol
1e-4, atol 1e-6 (JAX differentiates ``|x|² - 2 x·y + |y|²``, the port
``(x - y)²``) on clouds whose two assignments the test first asserts equal.
``api.nn_distance`` and its gradient are held to
``pccf.kernels.api.nn_distance`` inside the kernel's gate and outside it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from pccf.kernels import api as japi, ops as jops
from pccf.kernels.auction_emd import auction_emd as jauction_emd
from pccf_torch.kernels import api, auction_emd as auction, roofline

torch.set_num_threads(1)

TRAIN = dict(eps=0.005, iters=50)
EVAL = dict(eps=0.002, iters=10000)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _clouds(b=2, n=48, seed=0, m=None):
    """``tests/test_auction_emd.py``'s clouds (``m`` points in the second)."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, n, 3)).astype(np.float32)
    y = rng.random((b, m or n, 3)).astype(np.float32)
    return x, y


def _run(x, y, **kw):
    dis, assignment = api.auction_emd(torch.from_numpy(x), torch.from_numpy(y), **kw)
    return dis.numpy(), assignment.numpy()


def _optimum(x, y):
    d2 = ((x[:, None] - y[None]) ** 2).sum(-1)
    rows, cols = linear_sum_assignment(d2)
    return d2[rows, cols].sum()


def test_near_optimal_cost():
    x, y = _clouds()
    dis, assignment = _run(x, y, eps=0.002, iters=500)
    assert (assignment >= 0).all(), 'auction did not converge'
    for b in range(x.shape[0]):
        assert len(set(assignment[b].tolist())) == x.shape[1]
        assert dis[b].sum() <= _optimum(x[b], y[b]) * 1.15 + 1e-4


def test_identity_assignment():
    x, _ = _clouds(b=1)
    dis, _ = _run(x, x, eps=0.0005, iters=800)
    np.testing.assert_allclose(dis.sum(), 0.0, atol=1e-3)


def test_eval_operating_point():
    x, y = _clouds(b=1, n=512, seed=7)
    dis, assignment = _run(x, y, **EVAL)
    assert (assignment >= 0).all(), 'auction did not converge under cap'
    assert len(set(assignment[0].tolist())) == x.shape[1]
    assert dis.sum() <= _optimum(x[0], y[0]) * 1.10 + 1e-4


def test_train_operating_point_partial():
    x, y = _clouds(b=1, n=256, seed=11)
    dis, assignment = _run(x, y, **TRAIN)
    d2 = ((x[0][:, None] - y[0][None]) ** 2).sum(-1)
    assert (assignment < 0).any()  # the case this test is about
    for i, j in enumerate(assignment[0]):
        if j < 0:
            assert abs(dis[0, i] - d2[i].min()) < 1e-5


def test_default_bidder_cap_not_worse_than_uncapped():
    x, y = _clouds(b=2, n=512, seed=13)
    _, a_default = _run(x, y, **TRAIN)
    _, a_full = _run(x, y, **TRAIN, k_active=512)
    assert auction.bidder_cap(512, None) == 256 and auction.bidder_cap(2048, None) == 512
    assert int((a_default < 0).sum()) <= int((a_full < 0).sum()) + int(0.005 * 2 * 512)


def test_dis_matches_assignment():
    x, y = _clouds(b=1, n=32, seed=3)
    dis, assignment = _run(x, y, eps=0.005, iters=200)
    d2 = ((x[0][:, None] - y[0][None]) ** 2).sum(-1)
    for i, j in enumerate(assignment[0]):
        if j >= 0:
            assert abs(dis[0, i] - d2[i, j]) < 1e-5


def test_bf16_clouds_supported():
    x, y = _clouds(n=24)
    dis, assignment = api.auction_emd(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16(), iters=200)
    assert dis.dtype == torch.float32 and int(assignment.min()) >= 0
    assert torch.isfinite(dis).all()


def test_n_greater_than_m_rejected():
    x, y = _clouds(n=32)
    with pytest.raises(ValueError, match='N <= M'):
        api.auction_emd(torch.from_numpy(x), torch.from_numpy(y[:, :16]))
    with pytest.raises(ValueError, match='N <= M'):
        auction.plain(torch.from_numpy(x), torch.from_numpy(y[:, :16]))


@pytest.mark.parametrize('b,n,m,seed,contract,k_active', [
    (1, 256, 256, 21, TRAIN, None),
    (1, 256, 256, 22, EVAL, None),
    (1, 300, 300, 23, TRAIN, 40),
    (2, 128, 128, 24, EVAL, None),
    (2, 200, 256, 25, TRAIN, None),
])
def test_plain_reproduces_jax_rounds(b, n, m, seed, contract, k_active):
    """JAX's own distance matrix through ``d``: the same rounds, the same
    assignment bit for bit."""
    x, y = _clouds(b=b, n=n, m=m, seed=seed)
    want_dis, want = jauction_emd(jnp.asarray(x), jnp.asarray(y), **contract, k_active=k_active)
    d = torch.from_numpy(np.array(jops.square_distance(jnp.asarray(x), jnp.asarray(y))))
    dis, assignment, near, counts = auction.plain(torch.from_numpy(x), torch.from_numpy(y), **contract,
                                                  k_active=k_active, d=d)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(want))
    np.testing.assert_allclose(dis.numpy(), np.asarray(want_dis), rtol=0, atol=1e-6)
    assert torch.equal(near[assignment >= 0], assignment[assignment >= 0])
    rounds, bids = counts[:, 0], counts[:, 1]
    assert int(rounds.max()) <= contract['iters'] and (contract is TRAIN or (assignment >= 0).all())
    assert (bids >= rounds).all() and (bids <= rounds * auction.bidder_cap(n, k_active)).all()


def test_each_cloud_stops_on_its_own():
    """A converged cloud places no bid: a batch of a cloud that converges in
    a few rounds and one that does not gives each cloud's own result."""
    x, y = _clouds(b=2, n=128, seed=26)
    x[0] = y[0] + 1e-3 * x[0]  # each point's own match is far the best: a few rounds
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dis, assignment, near, counts = auction.plain(xt, yt, **TRAIN)
    assert int(counts[0, 0]) < TRAIN['iters'] == int(counts[1, 0]) and (assignment[0] >= 0).all()
    for c in range(2):
        one = auction.plain(xt[c:c + 1], yt[c:c + 1], **TRAIN)
        for got, want in zip((dis, assignment, near, counts), one):
            assert torch.equal(got[c:c + 1], want)
    want_dis, want = jauction_emd(jnp.asarray(x), jnp.asarray(y), **TRAIN)
    d = torch.from_numpy(np.array(jops.square_distance(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(auction.plain(xt, yt, **TRAIN, d=d)[1].numpy(), np.asarray(want))


@pytest.mark.parametrize('n,seed,contract', [(64, 31, TRAIN), (48, 32, dict(eps=0.005, iters=8)),
                                             (48, 33, dict(eps=0.002, iters=2000))])
def test_gradient_matches_jax(n, seed, contract):
    x, y = _clouds(b=2, n=n, seed=seed)
    _, want_a = jauction_emd(jnp.asarray(x), jnp.asarray(y), **contract)
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    dis, assignment = api.auction_emd(tx, ty, **contract)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(want_a))  # the premise: one assignment
    if contract['iters'] == 8:
        assert (assignment < 0).any()  # unassigned rows take the nearest point's gradient
    dis.sum().backward()
    gx, gy = jax.grad(lambda a, b: jnp.sum(jauction_emd(a, b, **contract)[0]), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **GRAD)


def test_emd_module_call_surface():
    x, y = _clouds(b=1, n=32, seed=34)
    dis, assignment = auction.emdModule()(torch.from_numpy(x), torch.from_numpy(y), 0.005, 50.0)
    want = api.auction_emd(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(dis, want[0]) and torch.equal(assignment, want[1])


def test_state_fits_shared_memory_up_to_a_few_thousand_points():
    """The kernel keeps a cloud's state in shared memory at 2048 points (72 KB)
    and in global scratch at 16384."""
    assert auction.smem_bytes(2048, 2048, 512) == 28 * 2048 + 4 * 2048 + 12 * 512 == 71680
    assert auction.smem_bytes(1536, 2048, 384) > 0
    assert auction.smem_bytes(16384, 16384, 4096) == 0
    assert auction.state_bytes(16384, 16384, 4096, False) == 28 * 16384 + 12 * 4096


def test_bound_counts_the_bids_placed():
    """``bound_ms`` counts the bids this run's data placed, each over every
    item, not the rounds times the cap."""
    x, y = _clouds(b=2, n=64, seed=35)
    counts = auction.plain(torch.from_numpy(x), torch.from_numpy(y), **TRAIN)[3]
    bids = int(counts[:, 1].sum())
    work = roofline.auction_work(torch.from_numpy(x), torch.from_numpy(y), bids)
    assert bids < int(counts[:, 0].sum()) * 64
    assert work.ops == roofline.AUCTION_OPS_PER_PAIR * bids * 64 and work.peak == roofline.FP32
    assert work.bytes == 2 * 2 * 64 * 3 * 4 + 2 * 64 * 8


@pytest.mark.parametrize('n,m', [(256, 512), (60, 70)])
def test_nn_distance_matches_jax(n, m):
    """Inside the gate (both counts multiples of 256) the kernel's autograd
    function, outside it the plain operations; values, indices and the
    gradient of a weighted sum of both directions."""
    rng = np.random.default_rng(n)
    x, y = rng.standard_normal((2, n, 3)).astype(np.float32), rng.standard_normal((2, m, 3)).astype(np.float32)
    w1, w2 = rng.standard_normal((2, n)).astype(np.float32), rng.standard_normal((2, m)).astype(np.float32)

    def jloss(a, b):
        d1, _, d2, _ = japi.nn_distance(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    want = japi.nn_distance(jnp.asarray(x), jnp.asarray(y))
    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    got = api.nn_distance(tx, ty)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    (torch.sum(got[0] * torch.from_numpy(w1)) + torch.sum(got[2] * torch.from_numpy(w2))).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **GRAD)
