"""Plain PyTorch versions of the slice's operations: the port's golden semantics.

Each mirrors its counterpart in ``pccf/kernels/ops.py`` (or, for ``pcgen_mix``
and ``cvae_cf``, the computation of the Pallas kernel it stands beside).  On a
CPU tensor the dispatcher (:mod:`pccf_torch.kernels.api`) runs these; on a
CUDA tensor it launches the hand-written kernels, which ``chip_smoke.py``
holds against these functions on the card.

All clouds are channels-last ``(B, N, C)``; neighbour indices ``(B, N, k)``
int32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def self_square_distance(x: Tensor) -> Tensor:
    """Pairwise squared distance of a cloud with itself, ``(B, N, N)``
    (``pccf/kernels/ops.py:55``: ``|x|² − 2 x·y + |y|²``)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    cross = torch.matmul(x, x.transpose(-1, -2))
    return sq - 2.0 * cross + sq.transpose(-1, -2)


def knn(x: Tensor, k: int) -> Tensor:
    """Indices of the k nearest neighbours of each point, self included,
    sorted by distance with the lowest index first on ties (``jax.lax.top_k``
    order, ``pccf/kernels/ops.py:64``).  A stable sort, not ``torch.topk``,
    whose tie order is unspecified."""
    d = self_square_distance(x)
    order = torch.sort(d, dim=-1, stable=True).indices
    return order[..., :k].to(torch.int32)


def gather_neighbors(x: Tensor, idx: Tensor) -> Tensor:
    """Neighbour features ``(B, N, k, C)`` (``pccf/kernels/ops.py:83``)."""
    b, n, c = x.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(x, 1, flat).reshape(b, n, k, c)


def graph_max_pool(x: Tensor, idx: Tensor) -> Tensor:
    """Max over the k neighbours of each point, ``(B, N, C)``
    (``pccf/kernels/ops.py:110``; the eval forward).  Its training gradient
    goes to the first winning slot: :func:`graph_max_pool_slots` and
    :func:`scatter_add_slots`."""
    return torch.amax(gather_neighbors(x, idx), dim=2)


def graph_max_pool_slots(x: Tensor, idx: Tensor) -> tuple[Tensor, Tensor]:
    """Max over the k neighbours and the slot ``j`` that wins each channel,
    ``(B, N, C)`` float and ``(B, N, C)`` uint8; ties keep the earliest slot
    and a NaN wins (``argmax`` first, ``pccf/kernels/ops.py:124-127``).
    Without NaNs it equals :func:`graph_max_pool_slots_strict`, the rule of
    the TPU kernel and of the card's."""
    gathered = gather_neighbors(x, idx)
    slots = torch.argmax(gathered, dim=2, keepdim=True)  # first maximum
    return torch.gather(gathered, 2, slots)[:, :, 0, :], slots[:, :, 0, :].to(torch.uint8)


def graph_max_pool_slots_strict(x: Tensor, idx: Tensor) -> tuple[Tensor, Tensor]:
    """:func:`graph_max_pool_slots` by the TPU kernel's rule
    (``pallas_gather.py:107-113``): slot 0 seeds the max and the slot, and
    slot ``j`` takes over only where it is strictly greater, so ties keep the
    earliest slot and a NaN past slot 0 never wins.  The card's
    ``graph_max_pool_src`` equals it bit for bit, NaNs included."""
    gathered = gather_neighbors(x, idx)
    best = gathered[:, :, 0]
    slots = torch.zeros(best.shape, dtype=torch.uint8, device=x.device)
    for j in range(1, idx.shape[-1]):
        cand = gathered[:, :, j]
        take = cand > best
        best = torch.where(take, cand, best)
        slots = torch.where(take, j, slots)
    return best.contiguous(), slots


def scatter_add_slots(g: Tensor, idx: Tensor, slots: Tensor, n: int) -> Tensor:
    """Max-pool backward ``dx[b, idx[b, i, slot], c] += g[b, i, c]`` where
    ``slot = slots[b, i, c]``, ``(B, n, C)`` (``pccf/kernels/ops.py:130-140``).
    On the CPU ``scatter_add_`` adds each element's terms in ascending ``i``
    from 0.0, the order of the TPU kernel (``pallas_gather.py:161-179``) and of
    the card's, which equals this run on the CPU bit for bit."""
    rows = torch.gather(idx.long(), 2, slots.long())  # (B, M, C): winning row per channel
    return torch.zeros((g.shape[0], n, g.shape[2]), dtype=g.dtype, device=g.device).scatter_add_(1, rows, g)


def graph_sum_pool(x: Tensor, idx: Tensor) -> Tensor:
    """Sum over the k neighbours of each point, ``(B, N, C)``
    (``pccf/kernels/ops.py:164``)."""
    return torch.sum(gather_neighbors(x, idx), dim=2)


def graph_sum_pool_slot_order(x: Tensor, idx: Tensor) -> Tensor:
    """:func:`graph_sum_pool` added in slot order from slot 0's row with
    plain fp32 adds, the order of the TPU kernel (``pallas_gather.py:246-249``)
    and of the card's kernel, which equals it bit for bit on the CPU."""
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    out = x[batch, idx[..., 0].long()]
    for j in range(1, idx.shape[-1]):
        out += x[batch, idx[..., j].long()]
    return out


def scatter_add_rows(g: Tensor, idx: Tensor, n: int) -> Tensor:
    """Transpose of the row gather: ``dx[b, idx[b, i, j]] += g[b, i]``,
    ``g (B, M, C)``, ``idx (B, M, k)`` -> ``(B, n, C)``
    (``pallas_gather.py:182``; the backward of sum-pool and gather).  Every
    row adds its terms one at a time in ascending edge order ``(i, j)`` on
    every device, the order of the card's kernel: on the CPU ``index_add_``
    adds so; elsewhere it may add in any order (atomics on the card), so
    there each row's edges are listed in that order, padded to the largest
    in-degree with a zero row, and added one list slot at a time."""
    b, m, c = g.shape
    k = idx.shape[-1]
    rows = (idx.long() + n * torch.arange(b, device=g.device)[:, None, None]).reshape(-1)
    if g.device.type == 'cpu':
        src = g[:, :, None, :].expand(b, m, k, c).reshape(-1, c)
        return torch.zeros((b * n, c), dtype=g.dtype, device=g.device).index_add_(0, rows, src).reshape(b, n, c)
    return scatter_add_rows_listed(g, rows, k, n)


def scatter_add_rows_listed(g: Tensor, rows: Tensor, k: int, n: int) -> Tensor:
    """:func:`scatter_add_rows` off the CPU, given each edge's flat target
    row ``rows (B * M * k,)``: each row's edges listed in ascending order
    (a stable sort), padded with a zero row to the largest in-degree, and
    added one list slot at a time."""
    b, m, c = g.shape
    n_edges = rows.numel()
    sorted_rows, order = torch.sort(rows, stable=True)
    targets = torch.arange(b * n, device=g.device)
    starts = torch.searchsorted(sorted_rows, targets)
    depth = int((torch.searchsorted(sorted_rows, targets, right=True) - starts).max()) if n_edges else 0
    table = torch.full((b * n, depth), b * m, dtype=torch.long, device=g.device)  # b * m: the zero row
    table[sorted_rows, torch.arange(n_edges, device=g.device) - starts[sorted_rows]] = order // k
    src = torch.cat([g.reshape(b * m, c), g.new_zeros((1, c))])
    out = g.new_zeros((b * n, c))
    for slot in range(depth):
        out += src[table[:, slot]]
    return out.reshape(b, n, c)


def graph_filtering_with_idx(x: Tensor, idx: Tensor, gather_fn=None) -> Tensor:
    """Gaussian-weighted sharpening of a decoded cloud from its kNN graph
    (``pccf/kernels/ops.py:207-219``): slot 0 is dropped as the point itself,
    ``sqrt(|d²| + 1e-12)`` guards the gradient of duplicates, and the
    per-cloud bandwidth is clamped at 0.005."""
    neigh = (gather_fn or gather_neighbors)(x, idx)[:, :, 1:, :]
    diff = x[:, :, None, :] - neigh
    dist = torch.sqrt(torch.abs(torch.sum(diff * diff, dim=-1)) + 1e-12)
    sigma = torch.clamp_min(torch.mean(dist[:, :, 0:1], dim=1, keepdim=True), 0.005)
    weights = torch.exp(-dist / sigma)
    w_sum = torch.sum(weights, dim=-1, keepdim=True)
    weighted = torch.sum(weights[..., None] * neigh, dim=2)
    return (1.0 + w_sum) * x - weighted


# ---------------------------------------------------- Chamfer, ApproxMatch EMD

# ApproxMatch relaxation levels -4^j, j = 7 .. -1 (pccf/kernels/ops.py:30)
APPROX_MATCH_LEVELS = tuple(-float(4.0**j) for j in range(7, -2, -1))


def square_distance(t1: Tensor, t2: Tensor) -> Tensor:
    """``|x|² − 2 x·y + |y|²``, ``(B, N, M)`` (``pccf/kernels/ops.py:33``)."""
    d = -2.0 * torch.matmul(t1, t2.transpose(-1, -2))
    d = d + torch.sum(t1 * t1, dim=-1, keepdim=True)
    return d + torch.sum(t2 * t2, dim=-1, keepdim=True).transpose(-1, -2)


def pair_square_distance(t1: Tensor, t2: Tensor) -> Tensor:
    """Squared distances from coordinate differences, ``((dx² + dy²) + dz²)``
    in float32: what the EMD kernels (``pallas_emd.py:137-142`` and
    ``csrc/emd.cu``) compute, never negative."""
    diff = t1[:, :, None, :] - t2[:, None, :, :]
    d = diff[..., 0] * diff[..., 0]
    for c in range(1, t1.shape[-1]):
        d = d + diff[..., c] * diff[..., c]
    return d


def nn_distance(x: Tensor, y: Tensor, d: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Bidirectional nearest neighbours ``dist1 (B, N), idx1 (B, N), dist2
    (B, M), idx2 (B, M)``, the lowest index on ties
    (``pccf/kernels/ops.py:227``).  ``d`` overrides the distance matrix."""
    d = square_distance(x, y) if d is None else d
    dist1, idx1 = _first_min(d, -1)
    dist2, idx2 = _first_min(d, -2)
    return dist1, idx1, dist2, idx2


def _first_min(d: Tensor, dim: int) -> tuple[Tensor, Tensor]:
    """Min and the lowest index attaining it (``jnp.argmin``); ``torch.min``
    leaves the index of ties unspecified."""
    val = torch.amin(d, dim=dim, keepdim=True)
    pos = torch.arange(d.shape[dim], device=d.device).view([-1 if i == d.dim() + dim else 1 for i in range(d.dim())])
    idx = torch.where(d == val, pos, d.shape[dim]).amin(dim=dim)
    return val.squeeze(dim), idx.to(torch.int32)


def chamfer(x: Tensor, y: Tensor) -> Tensor:
    """Chamfer distance per sample ``(B,)``, the mean over the points of each
    direction, gradients through the gathered nearest neighbours
    (``pccf/kernels/ops.py:242``, ``reduction='mean'``)."""
    with torch.no_grad():
        _, idx1, _, idx2 = nn_distance(x, y)
    near_y = torch.gather(y, 1, idx1.long()[..., None].expand(-1, -1, y.shape[-1]))
    near_x = torch.gather(x, 1, idx2.long()[..., None].expand(-1, -1, x.shape[-1]))
    forward = torch.mean(torch.sum((x - near_y) ** 2, dim=-1), dim=1)
    return forward + torch.mean(torch.sum((y - near_x) ** 2, dim=-1), dim=1)


def emd_marginal_multipliers(n: int, m: int) -> tuple[float, float]:
    """ApproxMatch marginals by C integer division (``ops.py:268``)."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def approx_match(x1: Tensor, x2: Tensor, d: Tensor | None = None) -> Tensor:
    """ApproxMatch transport plan ``(B, N, M)``, level by level as
    ``pccf/kernels/ops.py:277-321``: phase 1 row ratios, phase 2 column
    demand and consumption, phase 3 assignment and remains."""
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    mult_l, mult_r = emd_marginal_multipliers(n, m)
    d = square_distance(x1, x2) if d is None else d
    remain_l = torch.full((b, n), mult_l, dtype=x1.dtype, device=x1.device)
    remain_r = torch.full((b, m), mult_r, dtype=x1.dtype, device=x1.device)
    match = torch.zeros_like(d)
    for level in APPROX_MATCH_LEVELS:
        kernel = torch.exp(level * d)
        suml = torch.einsum('bnm,bm->bn', kernel, remain_r) + 1e-9
        ratio_l = remain_l / suml
        demand = torch.einsum('bnm,bn->bm', kernel, ratio_l) * remain_r
        consumption = torch.clamp_max(remain_r / (demand + 1e-9), 1.0)
        ratio_r = consumption * remain_r
        w = kernel * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + w
        remain_l = torch.clamp_min(remain_l - torch.sum(w, dim=2), 0.0)
        remain_r = torch.clamp_min(remain_r - demand, 0.0)
    return match


def match_cost_grads(x1: Tensor, x2: Tensor, match: Tensor) -> tuple[Tensor, Tensor]:
    """Gradients of the match cost with the plan held constant
    (``pccf/kernels/ops.py:330-342``, ``rsqrt(max(d², 1e-20))``)."""
    diff = x1[:, :, None, :] - x2[:, None, :, :]
    w = match * torch.rsqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 1e-20))
    return torch.einsum('bnm,bnmc->bnc', w, diff), -torch.einsum('bnm,bnmc->bmc', w, diff)


def emd_forward(x1: Tensor, x2: Tensor, d: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """ApproxMatch EMD ``cost (B,)`` and its two gradients with the plan held
    constant, the forward and saved residuals of ``match_cost``
    (``pccf/kernels/ops.py:345-370``); the autograd function is
    :class:`pccf_torch.kernels.emd.MatchCost`."""
    d = square_distance(x1, x2) if d is None else d
    match = approx_match(x1, x2, d)
    cost = torch.sum(match * torch.sqrt(torch.clamp_min(d, 0.0)), dim=(1, 2))
    return (cost, *match_cost_grads(x1, x2, match))


# Sinkhorn, the opt-in entropic-OT surrogate for ApproxMatch
# (pccf/kernels/ops.py:379-424): the same marginals and the same
# plan-constant cost and gradients

SINKHORN_EPS = 0.02
SINKHORN_ITERS = 12


def sinkhorn_match(x1: Tensor, x2: Tensor, d: Tensor | None = None) -> Tensor:
    """Entropic transport plan ``(B, N, M)`` with ApproxMatch marginals
    (``pccf/kernels/ops.py:383-406``): the row-stabilised kernel
    ``K = exp(-(d² - rowmin) / eps)``, then ``SINKHORN_ITERS`` updates of ``u``
    and ``v`` from ``v = 1``; the plan is ``u K v``."""
    n, m = x1.shape[1], x2.shape[1]
    mult_l, mult_r = emd_marginal_multipliers(n, m)
    d = square_distance(x1, x2) if d is None else d
    k = torch.exp(-(d - torch.amin(d, dim=2, keepdim=True)) / SINKHORN_EPS)
    v = torch.ones((x1.shape[0], m), dtype=x1.dtype, device=x1.device)
    for _ in range(SINKHORN_ITERS):
        u = mult_l / torch.clamp_min(torch.einsum('bnm,bm->bn', k, v), 1e-30)
        v = mult_r / torch.clamp_min(torch.einsum('bnm,bn->bm', k, u), 1e-30)
    return u[:, :, None] * k * v[:, None, :]


def sinkhorn_forward(x1: Tensor, x2: Tensor, d: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Sinkhorn ``cost (B,)`` and its two gradients with the plan held
    constant, the forward and saved residuals of ``sinkhorn_cost``
    (``pccf/kernels/ops.py:410-424``); the autograd function is
    :class:`pccf_torch.kernels.sinkhorn.ChamferSinkhornCost`."""
    d = square_distance(x1, x2) if d is None else d
    match = sinkhorn_match(x1, x2, d)
    cost = torch.sum(match * torch.sqrt(torch.clamp_min(d, 0.0)), dim=(1, 2))
    return (cost, *match_cost_grads(x1, x2, match))


# ------------------------------------------------------------------ layers


def interleave_residual(x: Tensor, out_features: int) -> Tensor:
    """``repeat_interleave(out // in + 1)[..., :out]`` built from the
    surviving prefix (``pccf/kernels/ops.py:146-161``): output column ``j``
    is input column ``j // (out // in + 1)``."""
    reps = out_features // x.shape[-1] + 1
    src = -(-out_features // reps)
    return torch.repeat_interleave(x[..., :src], reps, dim=-1)[..., :out_features]


def temperature_softmax(x: Tensor, temperature: float, dim: int = -1) -> Tensor:
    """Softmax of ``x / T`` (``pccf/nn/layers.py:195``)."""
    return torch.softmax(x / temperature, dim=dim)


def vq_assign(x: Tensor, codebook: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest codebook entry per code slot (``pccf/kernels/ops.py:432``).

    Args:
        x: ``(B, n_codes * d)`` or ``(B, n_codes, d)``.
        codebook: ``(n_codes, book_size, d)``.

    Returns:
        embeddings ``(B, n_codes * d)``, idx ``(B, n_codes)`` int32 (first
        minimum on ties, as ``jnp.argmin``), dist2 ``(B, n_codes, book_size)``.
    """
    n_codes, _, dim = codebook.shape
    xc = x.reshape(x.shape[0], n_codes, dim)
    diff = xc[:, :, None, :] - codebook[None]
    dist2 = torch.sum(diff * diff, dim=-1)
    idx = torch.argmin(dist2, dim=-1).to(torch.int32)
    return vq_lookup(idx, codebook), idx, dist2


def vq_lookup(idx: Tensor, codebook: Tensor) -> Tensor:
    """Embeddings ``(B, n_codes * d)`` from selections ``(B, n_codes)``
    (``pccf/kernels/ops.py:460``)."""
    n_codes = codebook.shape[0]
    slots = torch.arange(n_codes, device=idx.device)
    emb = codebook[slots[None, :], idx.long()]  # (B, n_codes, d)
    return emb.reshape(idx.shape[0], -1)


def one_hot_idx(idx: Tensor, book_size: int) -> Tensor:
    """One-hot VQ selections ``(B, n_codes, book_size)`` float32
    (``pccf/kernels/ops.py:480``)."""
    return F.one_hot(idx.long(), book_size).to(torch.float32)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_e, w_q):
        return w_e.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), g


def straight_through(w_e: Tensor, w_q: Tensor) -> Tensor:
    """Forward ``w_e``, the whole gradient to ``w_q`` and none to ``w_e``
    (``pccf/kernels/ops.py:485-501``)."""
    return _StraightThrough.apply(w_e, w_q)


def leaky(x: Tensor, slope: float) -> Tensor:
    """LeakyReLU with the given negative slope (0.0 is ReLU)."""
    return torch.where(x >= 0, x, slope * x)


def fold_bn_affine(
    weight: Tensor, scale: Tensor, bias: Tensor, mean: Tensor, var: Tensor, eps: float = 1e-5
) -> tuple[Tensor, Tensor]:
    """Fold a running-stat BatchNorm into the preceding dense weight
    (``pccf/kernels/pallas_pcgen.py:223``): ``a = γ / √(σ² + ε)``,
    ``W' = W · a`` (rows of the torch ``(…, out, in)`` layout),
    ``b' = β − μ · a``.  Stays float32; the kernel wrapper rounds."""
    a = scale * torch.rsqrt(var + eps)
    return weight * a[..., :, None], bias - mean * a


# ------------------------------------------------------------------ PCGen mix


def pcgen_mix(
    m: Tensor,
    w: Tensor,
    map_w: Tensor,
    map_b: Tensor,
    layer_ws: Sequence[Tensor],
    layer_bs: Sequence[Tensor],
    head_w: Tensor,
    head_b: Tensor,
    att_w: Tensor,
    att_b: Tensor,
    *,
    tau: float,
    act_slope: float,
) -> Tensor:
    """PCGen eval from the map MLP's penultimate activation to the mixed
    cloud, in float32 (what ``pallas_pcgen._kernel`` computes).

    Args:
        m: ``(B, N, Dm)`` penultimate map activations.
        w: ``(B, D0)`` latent.
        map_w / map_b: ``(D0, Dm)`` / ``(D0,)`` Hardtanh map head.
        layer_ws / layer_bs: per layer ``(G, Dout, Din)`` / ``(G, Dout)``,
            BatchNorm folded in (:func:`fold_bn_affine`).
        head_w / head_b: ``(G, 3, D_last)`` / ``(G, 3)``.
        att_w / att_b: ``(G, G * D_last)`` / ``(G,)``.

    Returns:
        ``(B, N, 3)`` mixed components.
    """
    x = w[:, None, :] * torch.clamp(torch.matmul(m, map_w.T) + map_b, -1.0, 1.0)
    rep0 = interleave_residual(x, layer_ws[0].shape[1])
    feats, comps = [], []
    for g in range(head_w.shape[0]):
        h = leaky(torch.matmul(x, layer_ws[0][g].T) + layer_bs[0][g], act_slope) + rep0
        for wl, bl in zip(layer_ws[1:], layer_bs[1:]):
            h = leaky(torch.matmul(h, wl[g].T) + bl[g], act_slope) + h[..., : wl.shape[1]]
        feats.append(h)
        comps.append(torch.matmul(h, head_w[g].T) + head_b[g])
    logits = torch.matmul(torch.cat(feats, dim=-1), att_w.T) + att_b
    att = temperature_softmax(logits, tau)
    return sum(att[..., g : g + 1] * comps[g] for g in range(len(comps)))


# ------------------------------------------------------------- CVAE chain


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm with flax's default eps 1e-6 (``pallas_wformer.py:38``),
    not torch's 1e-5."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def gelu_exact(x: Tensor) -> Tensor:
    """Exact-erf GELU (``pccf/nn/layers.py:95``)."""
    return F.gelu(x, approximate='none')


def attention(q: Tensor, k: Tensor, v: Tensor, n_heads: int, weight_scale: Tensor | None = None) -> Tensor:
    """Multi-head scaled dot-product attention on projected ``(B, T, d)``
    tensors, heads laid out ``(H, hd)`` along d as flax's MHA does;
    ``weight_scale`` multiplies the softmax weights (a dropout mask)."""
    b, t, d = q.shape
    hd = d // n_heads

    def split(a):
        return a.reshape(a.shape[0], a.shape[1], n_heads, hd).transpose(1, 2)

    s = torch.matmul(split(q) / math.sqrt(hd), split(k).transpose(-1, -2))
    weights = torch.softmax(s, dim=-1)
    if weight_scale is not None:
        weights = weights * weight_scale
    o = torch.matmul(weights, split(v))
    return o.transpose(1, 2).reshape(b, t, d)


def _dense(x: Tensor, p: dict, name: str) -> Tensor:
    return F.linear(x, p[f'w{name}'], p[f'b{name}'])


def _feed_forward(x: Tensor, p: dict) -> Tensor:
    h = layer_norm(x, p['ln2_w'], p['ln2_b'])
    return x + _dense(gelu_exact(_dense(h, p, '1')), p, '2')


def encoder_layer(x: Tensor, p: dict, n_heads: int) -> Tensor:
    """Pre-norm encoder layer from a packed parameter dict, weights in the
    ``(out, in)`` layout of :mod:`pccf_torch.kernels.wformer`."""
    h = layer_norm(x, p['ln1_w'], p['ln1_b'])
    x = x + _dense(attention(_dense(h, p, 'q'), _dense(h, p, 'k'), _dense(h, p, 'v'), n_heads), p, 'o')
    return _feed_forward(x, p)


def decoder_layer(x: Tensor, memory: Tensor, p: dict, n_heads: int) -> Tensor:
    """Pre-norm decoder layer (self, cross, feed-forward) from a packed dict."""
    h = layer_norm(x, p['ln1_w'], p['ln1_b'])
    x = x + _dense(attention(_dense(h, p, 'q'), _dense(h, p, 'k'), _dense(h, p, 'v'), n_heads), p, 'o')
    h = layer_norm(x, p['lnx_w'], p['lnx_b'])
    x = x + _dense(attention(_dense(h, p, 'xq'), _dense(memory, p, 'xk'), _dense(memory, p, 'xv'), n_heads), p, 'xo')
    return _feed_forward(x, p)


def cvae_cf(x: Tensor, probs: Tensor, pack) -> Tensor:
    """The deterministic counterfactual CVAE chain, ``(B, T, e) -> (B, T, e)``
    (what ``pallas_cvae._cvae_kernel`` computes), in float32.

    ``pack`` is a :class:`pccf_torch.kernels.cvae.CVAEPack`; ``probs`` are the
    already-interpolated class probabilities ``(B, C)``."""
    pemb = torch.matmul(probs, pack.wp) + pack.bp  # (B, d)
    pz2p = torch.einsum('bc,ctd->btd', probs, pack.prior_z2p)  # (B, T, d)
    h1, h2, hd = pack.heads

    res = torch.matmul(x, pack.win1) + pack.add1
    for p in pack.enc1:
        res = encoder_layer(res, p, h1)
    memory = torch.matmul(res, pack.aw) + pack.ab

    res = torch.matmul(x, pack.win2) + pack.add2 + pemb[:, None, :]
    for p in pack.enc2:
        res = encoder_layer(res, p, h2)

    res = torch.matmul(res, pack.bw) + pack.addd + pz2p
    for p in pack.dec:
        res = decoder_layer(res, memory, p, hd)
    return torch.matmul(res, pack.wcomp) + pack.bcomp
