"""Auction EMD with an exact point assignment: the CUDA kernel
``csrc/auction_emd.cu``, its plain version, and the autograd function.

Ports ``pccf/kernels/auction_emd.py``, a compacted Jacobi auction that JAX
runs as dense XLA ops inside ``lax.while_loop`` (no ``pallas_call``; the
reference's own auction is CUDA, ``external/emd/``).  Each round the first
``k`` unassigned points of ``x1`` (by index) bid on the point of ``x2`` with
the best benefit ``-d² - price``, raising its price by the gap to the
second-best benefit plus ``eps``; each item takes its highest bid (the
lowest bidder slot on a tie), evicting its previous owner.  The loop stops
when every point is assigned or after ``iters`` rounds; ``dis`` is the
squared distance to the assigned point, or to the nearest one where a point
is left unassigned.

:func:`plain` repeats JAX's rounds op for op over the batch (the loop runs
while any cloud has an unassigned point).  A cloud that is fully assigned has
no bidder, so it places no bid and its state stays as it is: running each
cloud's loop on its own gives the same result, and the kernel runs each
cloud on a thread-block cluster (:func:`plan`), all rounds in one launch,
with no host synchronisation; once fewer than ``plan.tail`` rows are left,
one block of the cluster runs the remaining rounds alone.  Two facts let it
drop the compaction once every unassigned row bids: the unassigned count
never rises, and slots are filled in row order, so the lowest slot on a tie
is the lowest row.  Both take the squared distances in
:func:`ops.pair_square_distance`'s rounding (no FMA), so on the card the
kernel's outputs equal the plain version's bit for bit.  The gradient of
``dis`` holds the assignment constant: each row's distance is re-expressed
through the two clouds at its matched (or nearest) index, and ``x2``'s rows
are summed through the ordered row scatter, as the Chamfer backward does
(:mod:`pccf_torch.kernels.chamfer`).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import NamedTuple

import torch

from pccf_torch.kernels import _build, chamfer, ops

NEG = -1e30  # the sentinel of an absent bid and of the second-best benefit (auction_emd.py:43)
# csrc/auction_emd.cu's constants
MAX_SMEM = 232448 - 1024  # kAuctionMaxSmem: a block's dynamic shared memory at most, beside the static arrays
MAX_CLUSTER = 16  # kMaxCluster: blocks a cloud at most
CLUSTER_SIZES = 5  # kClusterSizes: clusters of 1, 2, 4, 8, 16 blocks
MIN_ITEMS = 64  # kMinItems: items a block owns at least
TAIL_BIDDERS = 32  # kTailBidders: bidders below which one block runs the rounds (one warp resolves them)
WARPS = 32  # kAuctionWarps


def bidder_cap(n: int, k_active: int | None) -> int:
    """Bidders a round at most (``auction_emd.py:75``): ``k_active`` if given,
    else ``min(max(256, N // 4), N)``."""
    return min(k_active, n) if k_active else min(max(256, n // 4), n)


def _check(n: int, m: int) -> None:
    if n > m:
        # with more bidders than items the auction can never fully assign
        raise ValueError(f'auction_emd requires N <= M, got N={n} > M={m}')


def _align16(size: int) -> int:
    return -(-size // 16) * 16


class Plan(NamedTuple):
    """A cloud's auction on the card (``auction_plan`` in
    ``csrc/auction_emd.cu``, whose ``pccf_auction_plan`` gives the same
    fields in this order)."""

    cluster: int  # blocks a cloud
    items: int  # items a block owns (block r: [r items, (r + 1) items))
    rows: int  # rows a block owns
    handled: int  # bidder slots a block handles at most (slot s: block s mod cluster)
    shared: int  # 1: the state in shared memory, 0: in global scratch
    tail: int  # bidders below which one block runs the rounds (0: never)
    smem: int  # dynamic shared memory a block
    region: int  # bytes of a block's cluster state


def region_bytes(p: Plan, k: int) -> int:
    """A block's cluster state (``layout``): its items' float4 (coordinates
    and price), 64-bit keys and owners; its rows' assignment; its list of
    k rows (its own first k unassigned, or the losers and evicted owners of
    the bids on its items: every bid of a round may land there); every
    block's list count; the round's bidders (k); the partials of the
    slots it handles (16 bytes from each block); its inbox, a 16-byte bid
    (key, item) for each handled slot of each block; its list's count."""
    return (_align16(16 * p.items) + _align16(8 * p.items) + _align16(4 * p.items) + _align16(4 * p.rows)
            + _align16(4 * k) + _align16(4 * MAX_CLUSTER) + _align16(4 * k) + 2 * 16 * p.handled * p.cluster + 16)


def tail_bytes(n: int, m: int) -> int:
    """The leader's tail state (``tail_layout``): every item's float4, key
    and owner, every row's assignment, two lists of :data:`TAIL_BIDDERS`
    bidders' (x, y, z, row), a partial a warp."""
    return _align16(16 * m) + _align16(8 * m) + _align16(4 * m) + _align16(4 * n) + 2 * TAIL_BIDDERS * 16 + 16 * WARPS


def _plan_for(n: int, m: int, k: int, c: int) -> Plan:
    items, rows, handled = -(-m // c), -(-n // c), -(-k // c)
    p = Plan(c, items, rows, handled, 0, 0, 0, 0)
    region, tail = region_bytes(p, k), tail_bytes(n, m)
    shared = region <= MAX_SMEM
    tail_ok = shared and region + tail <= MAX_SMEM
    return p._replace(shared=int(shared), tail=TAIL_BIDDERS if tail_ok else 0,
                      smem=(region + (tail if tail_ok else 0)) if shared else 0, region=region)


def plan(b: int, n: int, m: int, k: int, resident: Sequence[int]) -> Plan:
    """The plan of ``b`` clouds on a card that holds ``resident[i]``
    clusters of ``2**i`` blocks at once (:func:`resident_clusters`): the
    cluster (the largest power of two up to :data:`MAX_CLUSTER` that leaves
    each block :data:`MIN_ITEMS` items, halved while the card holds fewer
    than ``b`` such clusters, unless the halved state would leave shared
    memory: one wave of smaller clusters beats waves of larger ones), each
    block's share, where the state lives (shared memory while a block's share fits
    in :data:`MAX_SMEM`, else global scratch) and whether one block can take
    over the tail (its gathered state fits beside the cluster's)."""
    c = MAX_CLUSTER
    while c > 1 and m < c * MIN_ITEMS:
        c //= 2
    p = _plan_for(n, m, k, c)
    while c > 1 and b > resident[c.bit_length() - 1]:
        half = _plan_for(n, m, k, c // 2)
        if p.shared and not half.shared:
            break
        p, c = half, c // 2
    return p


def library_plan(b: int, n: int, m: int, k: int) -> Plan:
    """The plan on the current card from the kernel library
    (``pccf_auction_plan``: :func:`plan` with the card's
    :func:`resident_clusters`)."""
    out = (ctypes.c_int * len(Plan._fields))()
    err = _build.lib().pccf_auction_plan(b, n, m, k, out)
    _build.check('pccf_auction_plan', err, f'b={b}, n={n}, m={m}, k={k}')
    return Plan(*out)


def resident_clusters() -> tuple[int, ...]:
    """Clusters of 1, 2, 4, 8 and 16 blocks the current card holds at once
    (``cudaOccupancyMaxActiveClusters``, ``pccf_auction_resident``)."""
    out = (ctypes.c_int * CLUSTER_SIZES)()
    _build.check('pccf_auction_resident', _build.lib().pccf_auction_resident(out), 'the current card')
    return tuple(out)


def scratch_bytes(b: int, p: Plan) -> int:
    """The global scratch of a call whose state does not fit in shared memory."""
    return 0 if p.shared else b * p.cluster * p.region


def _first_max(v: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Max and the lowest index attaining it (``jnp.argmax``)."""
    dim %= v.dim()
    val = torch.amax(v, dim=dim, keepdim=True)
    pos = torch.arange(v.shape[dim], device=v.device).view([-1 if i == dim else 1 for i in range(v.dim())])
    idx = torch.where(v == val, pos, v.shape[dim]).amin(dim=dim)
    return val.squeeze(dim), idx


def plain(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005, iters: int = 50, k_active: int | None = None,
          d: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, round by round as ``auction_emd.py:76-144``:
    ``dis (B, N)``, ``assignment (B, N)`` int32 (-1 where unassigned),
    ``near (B, N)`` int32 (the index ``dis`` was taken at: the assignment, or
    the nearest point, the lowest index on ties) and ``counts (B, 2)`` int32
    (the rounds each cloud bid in, and its bids over them).  ``d`` overrides
    the squared distances (default: :func:`ops.pair_square_distance` of the
    clouds in float32)."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    _check(n, m)
    k = bidder_cap(n, k_active)
    d = ops.pair_square_distance(x1.float(), x2.float()) if d is None else d
    dev = d.device
    neg_d2 = -d
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    row_ids = torch.arange(n, device=dev)[None, :]
    item_ids = torch.arange(m, dtype=torch.int32, device=dev)[None, :].expand(b, m)
    assignment = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    owner = torch.full((b, m), -1, dtype=torch.long, device=dev)
    price = torch.zeros((b, m), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    for _ in range(iters):
        unassigned = assignment < 0
        live = unassigned.any(dim=1)
        if not bool(live.any()):
            break
        # compact: the row ids of the first k unassigned points of each cloud
        pos = torch.cumsum(unassigned, dim=1) - 1
        valid = unassigned & (pos < k)
        counts += torch.stack([live, valid.sum(dim=1)], dim=1).to(torch.int32)
        rows_ext = torch.full((b, k + 1), n, dtype=torch.long, device=dev)
        rows_ext.scatter_(1, torch.where(valid, pos, k), torch.where(valid, row_ids, n))  # k: the dump slot
        rows = rows_ext[:, :k]
        active = rows < n
        rows_safe = rows.clamp_max(n - 1)
        # bid: the best and second-best benefit of each bidder
        benefits = torch.gather(neg_d2, 1, rows_safe[:, :, None].expand(b, k, m)) - price[:, None, :]
        best, j_star = _first_max(benefits, -1)
        second = benefits.scatter(2, j_star[..., None], NEG).amax(dim=-1)
        bid_value = torch.gather(price, 1, j_star) + ((best - second) + eps_t)
        bid_value = torch.where(active, bid_value, NEG)
        # each item takes its best bid (Jacobi), the lowest slot on a tie
        bids = torch.full((b, k, m), NEG, dtype=torch.float32, device=dev)
        bids.scatter_(2, j_star[..., None], bid_value[..., None])
        win_bid, win_slot = _first_max(bids, 1)
        has_bid = win_bid > NEG / 2
        win_row = torch.gather(rows_safe, 1, win_slot)
        # evict the previous owners of the re-auctioned items, then assign the winners
        assignment_ext = torch.cat([assignment, assignment.new_full((b, 1), -1)], dim=1)
        assignment_ext.scatter_(1, torch.where(has_bid & (owner >= 0), owner, n), -1)
        assignment_ext.scatter_(1, torch.where(has_bid, win_row, n), torch.where(has_bid, item_ids, -1))
        assignment = assignment_ext[:, :n]
        owner = torch.where(has_bid, win_row, owner)
        price = torch.where(has_bid, win_bid, price)
    near = torch.where(assignment >= 0, assignment, ops._first_min(d, -1)[1])
    dis = torch.gather(d, 2, near.long()[..., None])[..., 0]
    return dis, assignment.contiguous(), near, counts


def auction_emd_cuda(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005, iters: int = 50,
                     k_active: int | None = None) -> tuple[torch.Tensor, ...]:
    """``x1 (B, N, 3)``, ``x2 (B, M, 3)`` float32 on the card, ``N <= M`` ->
    ``dis, assignment, near, counts`` as :func:`plain`, from one launch of
    a cluster of blocks a cloud (:func:`library_plan`).  The state lives in shared
    memory while it fits, else in global scratch of this call.  A cluster
    the card cannot launch raises, naming the shapes."""
    _build.require(x1, 'x1', torch.float32)
    if x1.dim() != 3 or x1.shape[-1] != 3:
        raise ValueError(f'x1: expected (B, N, 3), got {tuple(x1.shape)}')
    b, n, _ = x1.shape
    if x2.dim() != 3:
        raise ValueError(f'x2: expected (B, M, 3), got {tuple(x2.shape)}')
    m = x2.shape[1]
    _build.require(x2, 'x2', torch.float32, (b, m, 3))
    _check(n, m)
    k = bidder_cap(n, k_active)
    dev = x1.device
    out = (torch.empty((b, n), dtype=torch.float32, device=dev), torch.empty((b, n), dtype=torch.int32, device=dev),
           torch.empty((b, n), dtype=torch.int32, device=dev), torch.empty((b, 2), dtype=torch.int32, device=dev))
    # the state's global scratch where it does not fit in shared memory: a narrower cluster gives each
    # block more, and the plan narrows only within shared memory, so the widest plan tells
    widest = plan(b, n, m, k, (b,) * CLUSTER_SIZES)
    p = widest if widest.shared else library_plan(b, n, m, k)
    scratch = None if p.shared else torch.empty(scratch_bytes(b, p), dtype=torch.uint8, device=dev)
    err = _build.lib().pccf_auction_emd(x1.data_ptr(), x2.data_ptr(), b, n, m, k, eps, iters,
                                        *(t.data_ptr() for t in out), None if scratch is None else scratch.data_ptr(),
                                        _build.stream())
    _build.check('pccf_auction_emd', err, f'x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, k={k}, iters={iters}')
    auction_emd_cuda.launches += 1
    return out


auction_emd_cuda.launches = 0


class AuctionEMD(torch.autograd.Function):
    """``(dis, assignment)``; the gradient of ``dis`` with the assignment
    held constant: ``2 (x1 - x2[j]) g`` for ``x1``, its negation summed into
    ``x2``'s rows ``j`` in ascending row order (unassigned rows map many to
    one onto their nearest point)."""

    @staticmethod
    def forward(ctx, x1, x2, eps, iters, k_active):
        # JAX's squared distances are float32 for bf16 clouds too (ops.py:46-51)
        x1f, x2f = x1.float().contiguous(), x2.float().contiguous()
        run = auction_emd_cuda if _build.on_cuda(x1f) else plain
        dis, assignment, near, _ = run(x1f, x2f, eps, iters, k_active)
        ctx.save_for_backward(x1f, x2f, near)
        ctx.dtypes = (x1.dtype, x2.dtype)
        ctx.mark_non_differentiable(assignment)
        return dis, assignment

    @staticmethod
    def backward(ctx, g, _):
        x1, x2, near = ctx.saved_tensors
        gx1 = 2.0 * (x1 - chamfer._gather_rows(x2, near)) * g[..., None]
        gx2 = chamfer._scatter_rows(x2.shape[1], near, -gx1)
        return gx1.to(ctx.dtypes[0]), gx2.to(ctx.dtypes[1]), None, None, None


def auction_emd(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005, iters: int = 50,
                k_active: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate optimal-assignment EMD (``auction_emd.py:46-144``):
    ``dis (B, N)`` float32, the squared distance to the assigned point of
    ``x2`` (to the nearest where unassigned), and ``assignment (B, N)`` int32
    (-1 where unassigned after ``iters`` rounds).  ``eps`` is the bid
    increment (0.005 / 50 rounds for training, 0.002 / ~10000 for
    evaluation); ``k_active`` caps the bidders a round (:func:`bidder_cap`).
    The kernel on a CUDA tensor, the plain version on a CPU tensor;
    differentiable in ``dis``."""
    return AuctionEMD.apply(x1, x2, eps, int(iters), k_active)


class EmdModule:
    """The reference ``emdModule``'s call surface (``auction_emd.py:148-152``)."""

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005, iters: int = 50):
        return auction_emd(x1, x2, eps=eps, iters=int(iters))


emdModule = EmdModule  # the reference's alias (external/emd/emd/__init__.py)
