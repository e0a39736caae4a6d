"""DGCNN and LDGCNN encoders (``pccf/nn/encoders.py``), channels-last;
``module.train()`` selects the batch-statistics training path."""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import AutoEncoderConfig
from pccf_torch.dist import mesh
from pccf_torch.kernels import api
from pccf_torch.nn.layers import Act, BatchNorm, DenseBlock, act_slope, bn_groups, get_act

IN_CHAN = 3


class EdgeConvBlock(nn.Module):
    """EdgeConv (``encoders.py:62-153``).

    With ``W = [W_diff; W_self]`` the edge dense ``concat(nbr − x, x) · W``
    is ``(x · W_diff)[nbr] + x · (W_self − W_diff)``.  Under no activation or
    a (leaky) ReLU it takes the streaming path: BatchNorm is a per-channel
    affine ``a, b`` that folds into the gathered term before the max (the
    per-centre term is constant over neighbours), and a monotone activation
    commutes with the max: ``act(graph_max_pool(u · a, idx) + s · a + b)``.
    In training ``a, b`` come from the batch statistics of the
    never-materialised edge tensor: one sum-pool of ``[u, u²]`` gives both
    u-moments, and ``var = E[u²] + 2 E[u·s] + E[s²] − mean²`` (unclamped, as
    in JAX).  Any other activation (GELU) materialises the edge tensor with
    the neighbour gather (``api.gather_neighbors``, whose gradient is the row
    scatter), normalises it, activates it and keeps each channel's first
    winner over the neighbours, so the gradient goes to that slot alone.

    ``weight`` is ``(F, 2C)``: the transpose of the flax ``kernel``."""

    def __init__(self, in_features: int, features: int, k: int, act: Act | None) -> None:
        super().__init__()
        self.k = k
        self.act = act
        self.monotone = act is None or act_slope(act) is not None
        self.weight = nn.Parameter(torch.empty(features, 2 * in_features))
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
        if idx is not None and idx.shape[-1] != self.k:
            # kNN indices are distance-sorted, so a wider precompute's prefix
            # is the exact k-NN set; too few neighbours means recompute
            idx = idx[..., : self.k].contiguous() if idx.shape[-1] > self.k else None
        if idx is None:
            idx = api.knn(x, self.k)
        c = x.shape[-1]
        w_diff = self.weight[:, :c]
        u = torch.matmul(x, w_diff.T)  # gathered per neighbour
        s = torch.matmul(x, (self.weight[:, c:] - w_diff).T)  # per-centre term
        if not self.monotone:
            return self._materialised(u, s, idx)
        if self.training:
            a, b = self._batch_affine(u, s, idx)
        else:
            a, b = self.bn.affine()
        out = api.graph_max_pool((u * a).contiguous(), idx) + s * a + b
        return self.act(out) if self.act is not None else out

    def _batch_affine(self, u: torch.Tensor, s: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm affine from the edge tensor's batch statistics per
        statistic group (``encoders.py:89-123``): the five terms (the
        neighbour sums of u and u², the cross term s · Σu, s and s²) reduced
        by one :func:`~pccf_torch.dist.mesh.group_moments` call; updates the
        running statistics with the groups' mean."""
        f, k = u.shape[-1], idx.shape[-1]
        sums = api.graph_sum_pool(torch.cat([u, u * u], dim=-1), idx)
        usum, u2sum = sums[..., :f], sums[..., f:]
        groups = bn_groups()
        moments = mesh.group_moments([usum, s, u2sum, lambda: s * usum, lambda: s * s], groups)  # (G, F) each
        e_u, e_s, e_u2, e_cross, e_s2 = (m.squeeze(0) for m in moments) if groups == 1 else moments
        batch_mean = e_u / k + e_s
        batch_var = e_u2 / k + 2.0 * (e_cross / k) + e_s2 - batch_mean * batch_mean
        if groups == 1:
            self.bn.update_running(batch_mean, batch_var)
            a = self.bn.weight * torch.rsqrt(batch_var + self.bn.eps)
            return a, self.bn.bias - batch_mean * a
        self.bn.update_running(batch_mean.mean(dim=0), batch_var.mean(dim=0))
        a = self.bn.weight * torch.rsqrt(batch_var + self.bn.eps)
        b = self.bn.bias - batch_mean * a
        n = u.shape[0]
        return mesh.expand_groups(a, n, groups)[:, None, :], mesh.expand_groups(b, n, groups)[:, None, :]

    def _materialised(self, u: torch.Tensor, s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The edge tensor ``(B, N, k, F)``, BatchNorm per statistic group,
        the activation and the first winner over the neighbours
        (``encoders.py:128-153``)."""
        pre = api.gather_neighbors(u.contiguous(), idx) + s[:, :, None, :]
        if self.training:
            groups = bn_groups()
            mean, sq = mesh.group_moments([pre, lambda: pre * pre], groups)  # (G, F)
            if groups == 1:
                mean, sq = mean.squeeze(0), sq.squeeze(0)
            var = sq - mean * mean
            if groups == 1:
                self.bn.update_running(mean, var)
            else:
                self.bn.update_running(mean.mean(dim=0), var.mean(dim=0))
                n = pre.shape[0]
                mean = mesh.expand_groups(mean, n, groups)[:, None, None, :]
                var = mesh.expand_groups(var, n, groups)[:, None, None, :]
        else:
            mean, var = self.bn.running_mean, self.bn.running_var
        pre = (pre - mean) * torch.rsqrt(var + self.bn.eps) * self.bn.weight + self.bn.bias
        if self.act is not None:
            pre = self.act(pre)
        win = torch.argmax(pre, dim=2, keepdim=True)  # the first winner, as jnp.argmax
        return torch.gather(pre, 2, win)[:, :, 0, :]


class DGCNNEncoder(nn.Module):
    """Dynamic-graph CNN encoder (``encoders.py:154-179``): the kNN graph is
    rebuilt on the features before every block; blocks (64, 64, 128, 256)."""

    def __init__(self, w_dim: int, n_neighbors: int, act: Act, h_dim: tuple[int, ...] = (64, 64, 128, 256)) -> None:
        super().__init__()
        widths = (IN_CHAN, *h_dim)
        self.edge_conv = nn.ModuleList(
            EdgeConvBlock(widths[i], widths[i + 1], n_neighbors, None if i == 0 else act) for i in range(len(h_dim))
        )
        self.final_conv = DenseBlock(sum(h_dim), w_dim, act=None, batch_norm=False)

    def forward(self, cloud: torch.Tensor, indices: torch.Tensor | None = None) -> torch.Tensor:
        x, idx, xs = cloud, indices, []
        for block in self.edge_conv:
            x = block(x, idx)
            idx = None  # dynamic graph: recompute on the new features
            xs.append(x)
        return torch.amax(self.final_conv(torch.cat(xs, dim=-1)), dim=1)  # (B, w_dim)


class LDGCNNEncoder(nn.Module):
    """Lighter DGCNN (``encoders.py:182-205``): one kNN graph on the input
    cloud, one EdgeConv, then per width a graph max-pool over that graph and
    a point-wise Dense + BatchNorm + act; the concatenation's final Dense,
    max over the points."""

    def __init__(self, w_dim: int, n_neighbors: int, conv_dims: tuple[int, ...], act: Act) -> None:
        super().__init__()
        self.n_neighbors = n_neighbors
        self.edge_conv = EdgeConvBlock(IN_CHAN, conv_dims[0], n_neighbors, None)
        self.points_conv = nn.ModuleList(DenseBlock(conv_dims[i], conv_dims[i + 1], act=act)
                                         for i in range(len(conv_dims) - 1))
        self.final_conv = DenseBlock(sum(conv_dims), w_dim, act=None, batch_norm=False)

    def forward(self, cloud: torch.Tensor, indices: torch.Tensor | None = None) -> torch.Tensor:
        idx = indices if indices is not None else api.knn(cloud, self.n_neighbors)
        x = self.edge_conv(cloud, idx)
        xs = [x]
        for block in self.points_conv:
            x = block(api.graph_max_pool(x.contiguous(), idx))
            xs.append(x)
        return torch.amax(self.final_conv(torch.cat(xs, dim=-1)), dim=1)  # (B, w_dim)


def get_encoder(cfg: AutoEncoderConfig, n_neighbors: int) -> nn.Module:
    """The encoder of ``autoencoder.model.encoder`` (``encoders.py:208-229``)."""
    enc = cfg.encoder
    act = get_act(enc.act_name)
    if enc.class_name == 'DGCNN':
        return DGCNNEncoder(cfg.w_dim, n_neighbors, act, enc.h_dim)
    if enc.class_name == 'LDGCNN':
        return LDGCNNEncoder(cfg.w_dim, n_neighbors, enc.conv_dims, act)
    raise ValueError(f'Unknown encoder {enc.class_name}')
