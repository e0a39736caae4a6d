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
    (``pccf/kernels/ops.py:110``; forward only)."""
    return torch.amax(gather_neighbors(x, idx), dim=2)


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


def attention(q: Tensor, k: Tensor, v: Tensor, n_heads: int) -> Tensor:
    """Multi-head scaled dot-product attention on projected ``(B, T, d)``
    tensors, heads laid out ``(H, hd)`` along d as flax's MHA does."""
    b, t, d = q.shape
    hd = d // n_heads

    def split(a):
        return a.reshape(a.shape[0], a.shape[1], n_heads, hd).transpose(1, 2)

    s = torch.matmul(split(q) / math.sqrt(hd), split(k).transpose(-1, -2))
    o = torch.matmul(torch.softmax(s, dim=-1), split(v))
    return o.transpose(1, 2).reshape(b, t, d)


def encoder_layer(x: Tensor, p: dict, n_heads: int) -> Tensor:
    """Pre-norm encoder layer from a packed parameter dict (see
    :mod:`pccf_torch.kernels.cvae`)."""
    d = x.shape[-1]
    h = layer_norm(x, p['ln1_w'], p['ln1_b'])
    qkv = torch.matmul(h, p['w_qkv']) + p['b_qkv']
    x = x + torch.matmul(attention(qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], n_heads), p['w_o']) + p['b_o']
    h = layer_norm(x, p['ln2_w'], p['ln2_b'])
    f = gelu_exact(torch.matmul(h, p['w1']) + p['b1'])
    return x + torch.matmul(f, p['w2']) + p['b2']


def decoder_layer(x: Tensor, memory: Tensor, p: dict, n_heads: int) -> Tensor:
    """Pre-norm decoder layer (self, cross, feed-forward) from a packed dict."""
    d = x.shape[-1]
    h = layer_norm(x, p['ln1_w'], p['ln1_b'])
    qkv = torch.matmul(h, p['w_qkv']) + p['b_qkv']
    x = x + torch.matmul(attention(qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], n_heads), p['w_o']) + p['b_o']
    h = layer_norm(x, p['lnx_w'], p['lnx_b'])
    q = torch.matmul(h, p['xw_q']) + p['xb_q']
    kv = torch.matmul(memory, p['xw_kv']) + p['xb_kv']
    x = x + torch.matmul(attention(q, kv[..., :d], kv[..., d:], n_heads), p['xw_o']) + p['xb_o']
    h = layer_norm(x, p['ln2_w'], p['ln2_b'])
    f = gelu_exact(torch.matmul(h, p['w1']) + p['b1'])
    return x + torch.matmul(f, p['w2']) + p['b2']


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
