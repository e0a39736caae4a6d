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
from pccf_torch.kernels import api, auction_emd as auction, ops, roofline

import chip_smoke

torch.set_num_threads(1)

TRAIN = dict(eps=0.005, iters=50)
EVAL = dict(eps=0.002, iters=10000)
GRAD = dict(rtol=1e-4, atol=1e-6)
HELD = (132, 66, 30, 15, 7)  # clusters of 1, 2, 4, 8, 16 blocks an H100 SXM holds at once (pccf_auction_resident)


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
    """The kernel keeps a cloud's state in the shared memory of a cluster of
    16 blocks at 2048 points (a block's share 24656 bytes, its list k rows,
    beside it the leader's copy for the tail: every item's float4, key and
    owner, every row's assignment) and at 16384 (196688 bytes a block, no
    room for the tail); in global scratch once a block's share passes
    227 KB."""
    p = auction.plan(1, 2048, 2048, 512, HELD)
    assert (p.cluster, p.items, p.rows, p.handled, p.shared, p.tail) == (16, 128, 128, 32, 1, 32)
    assert p.region == 28 * 128 + 4 * 128 + 4 * 512 + 4 * 16 + 4 * 512 + 2 * 16 * 32 * 16 + 16 == 24656
    assert p.smem == p.region + auction.tail_bytes(2048, 2048) == 24656 + 28 * 2048 + 4 * 2048 + 1536 == 91728
    assert auction.plan(1, 1536, 2048, 384, HELD).shared and auction.plan(1, 1536, 2048, 384, HELD).tail
    big = auction.plan(1, 16384, 16384, 4096, HELD)
    assert (big.cluster, big.shared, big.tail, big.smem) == (16, 1, 0, 196688)
    assert auction.scratch_bytes(1, big) == 0
    past = auction.plan(1, 32768, 32768, 8192, HELD)
    assert not past.shared and past.smem == 0 and past.region > auction.MAX_SMEM
    assert auction.scratch_bytes(3, past) == 3 * 16 * past.region


@pytest.mark.parametrize('n,m,k', [(5, 40, 5), (40, 40, 40), (64, 64, 64), (300, 512, 256), (700, 700, 64),
                                   (1024, 1024, 256), (1536, 2048, 384), (2048, 2048, 512), (2048, 2048, 2048),
                                   (4096, 4096, 1024), (6000, 6144, 1536), (16384, 16384, 4096),
                                   (5216, 5216, 1304), (5224, 5224, 1306), (19264, 19264, 4816),
                                   (19272, 19272, 4818), (100000, 100000, 25000)])
def test_plan_splits_every_cloud_over_its_cluster(n, m, k):
    """The plan's mirror: a power-of-two cluster up to 16 whose blocks share
    the items (each owns at least one, together all of them) and the rows,
    every bytes count within 227 KB, a tail only where one block can hold
    the gathered state, and one warp's worth of tail bidders at most."""
    p = auction.plan(1, n, m, k, HELD)
    c = p.cluster
    assert c in (1, 2, 4, 8, 16) and (c == 16 or m < 2 * c * auction.MIN_ITEMS)
    assert p.items * c >= m and (c - 1) * p.items < m and p.rows * c >= n and p.handled * c >= k
    assert p.region == auction.region_bytes(p, k) and p.region % 16 == 0
    assert p.shared == (p.region <= auction.MAX_SMEM) and p.smem <= auction.MAX_SMEM
    if p.tail:
        assert p.shared and p.tail == auction.TAIL_BIDDERS <= auction.WARPS
        assert p.smem == p.region + auction.tail_bytes(n, m)
    else:
        assert p.smem == (p.region if p.shared else 0)
        assert not p.shared or p.region + auction.tail_bytes(n, m) > auction.MAX_SMEM
    assert p.shared == (n <= 19264) and bool(p.tail) == (n <= 5216)  # the boundaries at N = M, k = N / 4
    for b in (8, 40, 200):  # narrowed for a batch, the state stays where the widest plan puts it (the scratch)
        assert auction.plan(b, n, m, k, HELD).shared == auction.plan(b, n, m, k, (b,) * auction.CLUSTER_SIZES).shared


@pytest.mark.parametrize('m', [2048, 16384])
def test_plan_takes_clusters_of_8_past_seven_clouds(m):
    """On a card that holds ``HELD`` clusters at once, a batch takes the
    widest cluster of which the card holds one a cloud: 16 blocks up to 7
    clouds, 8 past seven and up to 15, 4 up to 30, 2 up to 66, then one
    block a cloud; never halved out of shared memory (at 16384 points,
    clusters of 8 from 8 clouds on); halved in global scratch too."""
    k = m // 4
    clusters = [auction.plan(b, m, m, k, HELD).cluster for b in (1, 7, 8, 15, 16, 30, 31, 40, 66, 67, 200)]
    assert clusters == ([16, 16, 8, 8, 4, 4, 2, 2, 2, 1, 1] if m == 2048 else [16, 16, 8, 8, 8, 8, 8, 8, 8, 8, 8])
    assert all(auction.plan(b, m, m, k, HELD).shared for b in (1, 8, 40, 200))
    assert auction.plan(8, m, m, k, HELD) == auction._plan_for(m, m, k, 8)
    assert auction.plan(16, 30000, 30000, 7500, HELD).cluster == 4  # global scratch at 16 and at 4
    assert auction.plan(8, 600, 600, 256, HELD).cluster == 8 and auction.plan(8, 40, 40, 40, HELD).cluster == 1


@pytest.mark.parametrize('contract', [TRAIN, EVAL])
@pytest.mark.parametrize('k_active', [None, 16])
def test_unassigned_count_never_rises(contract, k_active):
    """Each item that receives bids takes one winner, who was unassigned,
    and evicts at most one owner: the unassigned count after r rounds never
    rises with r (the fact that lets the kernel switch once, from the
    compaction to a list, and from the cluster to one block)."""
    x, y = _clouds(b=2, n=64, seed=41)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    left = [(auction.plain(xt, yt, contract['eps'], r, k_active)[1] < 0).sum(dim=1) for r in range(13)]
    assert (left[0] == 64).all() and (left[12] < 64).all()
    for a, b in zip(left, left[1:]):
        assert (b <= a).all()


def _tied_clouds(seed):
    """Clouds whose second holds every point twice (a bidder's best and
    second best tie, its increment is eps) and whose first holds pairs of
    equal points (equal bids on one item: the lowest row wins).  The
    coordinates are multiples of 1/8 in [0, 1], so every squared distance is
    exact in float32 however it is evaluated (JAX's jitted loop expands and
    fuses its own) and equal distances tie exactly."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 9, (2, 24, 3)) / 8).astype(np.float32)
    x = (rng.integers(0, 9, (2, 48, 3)) / 8).astype(np.float32)
    x[:, 1::2] = x[:, 0::2]
    return x, np.concatenate([y, y], axis=1)


@pytest.mark.parametrize('contract,k_active', [(TRAIN, None), (EVAL, None), (TRAIN, 8)])
def test_ties_broken_on_the_row_give_the_slots_result(contract, k_active):
    """Duplicated points in ``x2`` and equal bids: the plain version, whose
    bids tie on the slot, equals JAX bit for bit, and so does the kernel's
    schedule rehearsed with its keys on the row (``_rehearse``)."""
    x, y = _tied_clouds(42)
    want_dis, want = jauction_emd(jnp.asarray(x), jnp.asarray(y), **contract, k_active=k_active)
    d = torch.from_numpy(np.array(jops.square_distance(jnp.asarray(x), jnp.asarray(y))))
    dis, assignment, _, counts = auction.plain(torch.from_numpy(x), torch.from_numpy(y), **contract,
                                               k_active=k_active, d=d)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(want))
    np.testing.assert_allclose(dis.numpy(), np.asarray(want_dis), rtol=0, atol=1e-6)
    assert contract is TRAIN or (assignment >= 0).all()
    mine = auction.plain(torch.from_numpy(x), torch.from_numpy(y), **contract, k_active=k_active)
    for c in range(2):
        got = _rehearse(x[c], y[c], contract['eps'], contract['iters'], k_active, cluster=2, tail=16, seed=c)
        for a, w in zip(got[:4], mine):
            assert np.array_equal(a, w[c].numpy())


KNEG = np.float32(-1e30)
INT_MAX = 2 ** 31 - 1


def _merge(a, b):
    """The kernel's ``merge``: the max, the lowest index on a tie, the
    second best over both."""
    (best, second, j), (ob, os, oj) = a, b
    if ob > best or (ob == best and oj < j):
        return ob, max(second, os, best), oj
    return best, max(second, os, ob), j


def _sweep(v, j0, lanes, rng):
    """A group of ``lanes`` lanes over the benefits ``v`` of items ``j0``,
    ``j0 + 1``, ...: lane l takes items l, l + lanes, ... in order (the first
    strict max, a second best that keeps a tied best), and the lanes' partials
    merge in a random order."""
    out = (np.float32(-np.inf), KNEG, INT_MAX)  # a group with no items
    if len(v) == 0:
        return out
    t = -(-len(v) // lanes)
    pad = np.full(t * lanes, -np.inf, np.float32)
    pad[:len(v)] = v
    cols = pad.reshape(t, lanes)
    jj = cols.argmax(axis=0)
    best = cols[jj, np.arange(lanes)]
    cols[jj, np.arange(lanes)] = -np.inf
    second = np.maximum(cols.max(axis=0), KNEG)
    parts = [(best[q], second[q], j0 + q + lanes * int(jj[q])) for q in range(lanes) if q < len(v)]
    for q in rng.permutation(len(parts)):
        out = _merge(out, parts[q])
    return out


def _rehearse(x1, x2, eps, iters, k_active, cluster, tail, seed):
    """The kernel's schedule on one cloud, in numpy: blocks own contiguous
    shares of the items and rows; while more than k rows are unassigned each
    block lists its own in order, after that its handled losers and the
    owners of its items' bids in any order; each block's partial for a bidder
    from groups of lanes, the blocks' partials merged in any order; the key
    is (bid, lowest row); below ``tail`` bidders (and at most k) one list,
    32 // count shares a bidder, the next list in lane order.  Every list
    fits the k rows the kernel's layout gives it.  Returns dis, assignment,
    near, counts as :func:`auction.plain` for one cloud, the rounds from
    which every unassigned row bid and one block ran, and the longest list a
    block built from its items' bids."""
    d = ops.pair_square_distance(torch.from_numpy(x1[None]), torch.from_numpy(x2[None]))[0].numpy()
    n, m = d.shape
    k = auction.bidder_cap(n, k_active)
    rng = np.random.default_rng(seed)
    mi, nr, eps = -(-m // cluster), -(-n // cluster), np.float32(eps)
    price, owner, assign = np.zeros(m, np.float32), np.full(m, -1), np.full(n, -1)
    lists = [list(range(r * nr, min(n, (r + 1) * nr))) for r in range(cluster)]
    rnd = bids = longest = 0
    listed_from = tail_from = None
    while rnd < iters:
        total = sum(map(len, lists))
        if total == 0:
            break
        listed = total <= k
        if listed and listed_from is None:
            listed_from = rnd
        if tail_from is None and listed and total < tail:
            tail_from = rnd
            lists = [[i for part in lists for i in part]]
        bidders = [i for part in lists for i in part][:k]
        bids += len(bidders)
        keys, placed = {}, []
        for s, i in enumerate(bidders):
            v = -d[i] - price
            if tail_from is None:
                lanes = 32
                while lanes > 1 and len(bidders) * lanes > 1024:
                    lanes //= 2
                parts = [_sweep(v[r * mi:(r + 1) * mi], r * mi, lanes, rng) for r in range(cluster) if r * mi < m]
            else:
                per = 32 // len(bidders)
                parts = [_sweep(v[m * q // per:m * (q + 1) // per], m * q // per, 32, rng) for q in range(per)]
            best, second, j = np.float32(-np.inf), KNEG, INT_MAX
            for q in rng.permutation(len(parts)):
                best, second, j = _merge((best, second, j), parts[q])
            key = (price[j] + ((best - second) + eps), -i)
            keys[j] = max(keys.get(j, key), key)
            placed.append((s, i, j, key))
        won = {j: -key[1] for j, key in keys.items()}
        evicted = []
        for j in sorted(keys):
            w, o = won[j], owner[j]
            owner[j], price[j], assign[w] = w, keys[j][0], j
            if o >= 0:
                assign[o] = -1
            evicted.append(o)
        if tail_from is not None:  # lane order: a loser stays, a winner's slot takes the owner it evicted
            lists = [[i if keys[j] != key else owner_before for (_, i, j, key), owner_before in
                      zip(placed, [dict(zip(sorted(keys), evicted))[j] if keys[j] == key else -1
                                   for _, _, j, key in placed]) if (keys[j] != key or owner_before >= 0)]]
        elif listed:
            new = [[] for _ in range(cluster)]
            for j, o in zip(sorted(keys), evicted):
                if o >= 0:
                    new[j // mi].append(o)
            for s, i, j, key in placed:
                if keys[j] != key:
                    new[j // mi].append(i)
            lists = [rng.permutation(part).tolist() for part in new]
            longest = max(longest, *map(len, lists))
            assert longest <= k  # the room of a block's list
        else:
            lists = [[i for i in range(r * nr, min(n, (r + 1) * nr)) if assign[i] < 0] for r in range(cluster)]
        rnd += 1
    near = np.where(assign >= 0, assign, d.argmin(axis=1))
    dis = d[np.arange(n), near]
    return dis, assign.astype(np.int32), near.astype(np.int32), np.array([rnd, bids], np.int32), listed_from, \
        tail_from, longest


def _ordered(v):
    """``ordered_bits``: float32 bits in an order that compares as the floats do."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _from_ordered(o):
    o = np.asarray(o, np.uint32)
    return np.where(o & 0x80000000, o & 0x7fffffff, ~o).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize('seed', range(6))
def test_warp_merge_by_reductions_equals_pairwise(seed):
    """The tail's ``merge_warp`` (a max over the ordered bits, the lowest
    index at it, the max of every second and every other best) gives what
    the pairwise ``merge`` gives over 32 lanes in any order: lanes with tied
    bests, lanes with no items, -0 and the -1e30 sentinel."""
    rng = np.random.default_rng(seed)
    best = rng.choice(np.float32([-0.0, -0.25, -0.5, -1.0, -2.0]), 32)
    second = np.minimum(best, rng.choice(np.float32([-0.0, -0.25, -0.5, -3.0, -1e30]), 32))
    best_j = rng.permutation(2048)[:32].astype(np.int64)
    empty = rng.random(32) < 0.2
    best[empty], second[empty], best_j[empty] = -np.inf, KNEG, INT_MAX
    ob = _ordered(best)
    top = ob.max()
    j = np.where(ob == top, best_j, 0xFFFFFFFF).min()
    first = (ob == top) & (best_j == j)
    got = (_from_ordered(top), _from_ordered(_ordered(np.where(first, second, np.maximum(second, best))).max()), j)
    want = (np.float32(-np.inf), KNEG, INT_MAX)
    for q in rng.permutation(32):
        want = _merge(want, (best[q], second[q], int(best_j[q])))
    assert got[0].tobytes() == np.float32(want[0]).tobytes() and got[1].tobytes() == np.float32(want[1]).tobytes()
    assert got[2] == want[2]
    assert np.array_equal(_from_ordered(_ordered(best)).view(np.uint32), best.view(np.uint32))


@pytest.mark.parametrize('n,m,contract,k_active,cluster,tail', [
    (64, 64, TRAIN, None, 4, 16),
    (96, 128, TRAIN, 24, 8, 16),
    (40, 48, dict(eps=0.002, iters=3000), None, 2, 16),
    (30, 30, dict(eps=0.002, iters=3000), 8, 1, 16),
    (48, 64, dict(eps=0.005, iters=3000), 12, 4, 32),
])
def test_kernel_schedule_rehearsed_equals_plain(n, m, contract, k_active, cluster, tail):
    """The kernel's schedule (``_rehearse``: the cluster's shares, lists in
    any order, partials merged in any order, keys on the row, the one-block
    tail) gives the plain version's dis, assignment, near and counts bit for
    bit; the tail begins only once every unassigned row bids."""
    x, y = _clouds(b=1, n=n, m=m, seed=n + m)
    want = [t[0].numpy() for t in auction.plain(torch.from_numpy(x), torch.from_numpy(y), **contract,
                                                k_active=k_active)]
    got = _rehearse(x[0], y[0], contract['eps'], contract['iters'], k_active, cluster, tail, seed=n)
    for a, w in zip(got[:4], want):
        assert np.array_equal(a, w)
    listed_from, tail_from = got[4:6]
    k = auction.bidder_cap(n, k_active)
    if tail_from is not None:
        assert listed_from is not None and listed_from <= tail_from
    rows = [chip_smoke.rounds_until(auction.plain, torch.from_numpy(x), torch.from_numpy(y), contract['eps'],
                                 contract['iters'], k_active, below)[0] for below in (k + 1, min(tail, k + 1))]
    assert rows == [listed_from, tail_from]


def test_concentrated_bids_fit_a_blocks_list():
    """Coincident points in ``x1``: once the other rows are assigned they
    all bid on one item, so one block lists nearly every loser of a round,
    more than its bidder slots and items together.  The kernel's
    schedule keeps them in the k rows of its list and gives the plain
    version's result bit for bit."""
    x, y = _clouds(b=1, n=128, seed=43)
    x[0, np.random.default_rng(43).permutation(128)[:90]] = x[0, 0]
    want = [t[0].numpy() for t in auction.plain(torch.from_numpy(x), torch.from_numpy(y), **TRAIN)]
    got = _rehearse(x[0], y[0], TRAIN['eps'], TRAIN['iters'], None, cluster=4, tail=16, seed=43)
    for a, w in zip(got[:4], want):
        assert np.array_equal(a, w)
    items = handled = 128 // 4
    assert got[6] > handled + items


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
