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
cloud's loop on its own gives the same result, and the kernel runs one block
a cloud, all rounds in one launch, with no host synchronisation.  Both take
the squared distances in :func:`ops.pair_square_distance`'s rounding (no
FMA), so on the card the kernel's assignment equals the plain version's bit
for bit.  The gradient of ``dis`` holds the assignment constant: each row's
distance is re-expressed through the two clouds at its matched (or nearest)
index, and ``x2``'s rows are summed through the ordered row scatter, as the
Chamfer backward does (:mod:`pccf_torch.kernels.chamfer`).
"""

from __future__ import annotations

import torch

from pccf_torch.kernels import _build, chamfer, ops

NEG = -1e30  # the sentinel of an absent bid and of the second-best benefit (auction_emd.py:43)
MAX_SMEM = 232448 - 1024  # kAuctionMaxSmem: the state's shared memory at most, beside the static arrays


def bidder_cap(n: int, k_active: int | None) -> int:
    """Bidders a round at most (``auction_emd.py:75``): ``k_active`` if given,
    else ``min(max(256, N // 4), N)``."""
    return min(k_active, n) if k_active else min(max(256, n // 4), n)


def _check(n: int, m: int) -> None:
    if n > m:
        # with more bidders than items the auction can never fully assign
        raise ValueError(f'auction_emd requires N <= M, got N={n} > M={m}')


def state_bytes(n: int, m: int, k: int, shared: bool) -> int:
    """Bytes of one cloud's auction state (``auction_bytes`` in
    ``csrc/auction_emd.cu``): each item's coordinates and price (16), its
    best bid's key (8) and owner (4); each bidder slot's row, item and bid
    (12); in shared memory also the assignment (4 a row); rounded up to 16."""
    size = 28 * m + 12 * k + (4 * n if shared else 0)
    return -(-size // 16) * 16


def smem_bytes(n: int, m: int, k: int) -> int:
    """The kernel's dynamic shared memory: the whole state while it fits in
    :data:`MAX_SMEM`, else 0 (the state lives in global scratch)."""
    size = state_bytes(n, m, k, True)
    return size if size <= MAX_SMEM else 0


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
    one block a cloud.  The state lives in shared memory while it fits
    (:func:`smem_bytes`), else in global scratch of this call."""
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
    # the state's global scratch where it does not fit in shared memory
    scratch = None if smem_bytes(n, m, k) else torch.empty(b * state_bytes(n, m, k, False), dtype=torch.uint8,
                                                           device=dev)
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
