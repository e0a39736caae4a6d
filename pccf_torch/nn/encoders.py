"""DGCNN encoder (``pccf/nn/encoders.py``), channels-last; ``module.train()``
selects the streaming-BN training path."""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.kernels import api
from pccf_torch.nn.layers import Act, BatchNorm, DenseBlock, act_slope

IN_CHAN = 3


class EdgeConvBlock(nn.Module):
    """EdgeConv on the streaming path (``encoders.py:62-126``).

    With ``W = [W_diff; W_self]`` the edge dense ``concat(nbr − x, x) · W``
    is ``(x · W_diff)[nbr] + x · (W_self − W_diff)``.  BatchNorm is a
    per-channel affine ``a, b`` that folds into the gathered term before the
    max (the per-centre term is constant over neighbours), and a monotone
    activation commutes with the max:
    ``act(graph_max_pool(u · a, idx) + s · a + b)``.  In training ``a, b``
    come from the batch statistics of the never-materialised edge tensor:
    one sum-pool of ``[u, u²]`` gives both u-moments, and
    ``var = E[u²] + 2 E[u·s] + E[s²] − mean²`` (unclamped, as in JAX).

    ``weight`` is ``(F, 2C)``: the transpose of the flax ``kernel``."""

    def __init__(self, in_features: int, features: int, k: int, act: Act | None) -> None:
        super().__init__()
        if act is not None and act_slope(act) is None:
            raise ValueError('EdgeConvBlock: only monotone (leaky) ReLU activations take the streaming path')
        self.k = k
        self.act = act
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
        if self.training:
            a, b = self._batch_affine(u, s, idx)
        else:
            a, b = self.bn.affine()
        out = api.graph_max_pool((u * a).contiguous(), idx) + s * a + b
        return self.act(out) if self.act is not None else out

    def _batch_affine(self, u: torch.Tensor, s: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm affine from the edge tensor's batch statistics
        (``encoders.py:89-123``); updates the running statistics."""
        f, k = u.shape[-1], idx.shape[-1]
        sums = api.graph_sum_pool(torch.cat([u, u * u], dim=-1), idx)
        usum, u2sum = sums[..., :f], sums[..., f:]

        def mean(t):
            return torch.mean(t, dim=(0, 1))

        batch_mean = mean(usum) / k + mean(s)
        batch_var = mean(u2sum) / k + 2.0 * (mean(s * usum) / k) + mean(s * s) - batch_mean * batch_mean
        self.bn.update_running(batch_mean, batch_var)
        a = self.bn.weight * torch.rsqrt(batch_var + self.bn.eps)
        return a, self.bn.bias - batch_mean * a


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
