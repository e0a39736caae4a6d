"""Inner (W-space) transformer networks, eval (``pccf/nn/w_networks.py``).

All operate on the code axis: inputs ``(B, n_codes, embedding_dim)``.  Their
parameters feed the CVAE chain's weight pack
(:func:`pccf_torch.kernels.cvae.pack_cvae_cf`); run module by module they
are the chain's unfused form.
"""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.nn.layers import Act, DenseBlock, TransformerDecoderLayer, TransformerEncoderLayer


def _positional(n_codes: int, d: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(1, n_codes, d))


class TransformerWEncoder(nn.Module):
    """Token-per-code transformer encoder (``w_networks.py:84-113``)."""

    def __init__(
        self, embedding_dim: int, z1_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act,
    ) -> None:
        super().__init__()
        self.proj_dim, self.n_heads, self.mlp_dims, self.act = proj_dim, n_heads, mlp_dims, act
        self.input_proj = DenseBlock(embedding_dim, proj_dim, batch_norm=False)
        self.positional_encoding = _positional(n_codes, proj_dim)
        self.layers = nn.ModuleList(TransformerEncoderLayer(proj_dim, n_heads, f, act) for f in mlp_dims)
        self.to_latent = DenseBlock(proj_dim, 2 * z1_dim, batch_norm=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_proj(x) + self.positional_encoding
        for layer in self.layers:
            x = layer(x)
        return self.to_latent(x)


class TransformerWConditionalEncoder(nn.Module):
    """Posterior-difference net conditioned on class probabilities
    (``w_networks.py:205-236``)."""

    def __init__(
        self, embedding_dim: int, n_classes: int, z2_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act,
    ) -> None:
        super().__init__()
        self.proj_dim, self.n_heads, self.mlp_dims, self.act = proj_dim, n_heads, mlp_dims, act
        self.input_proj = DenseBlock(embedding_dim, proj_dim, batch_norm=False)
        self.positional_encoding = _positional(n_codes, proj_dim)
        self.prob_proj = DenseBlock(n_classes, proj_dim, batch_norm=False)
        self.layers = nn.ModuleList(TransformerEncoderLayer(proj_dim, n_heads, f, act) for f in mlp_dims)
        self.to_latent = DenseBlock(proj_dim, 2 * z2_dim, batch_norm=False)

    def forward(self, probs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = self.positional_encoding + self.input_proj(x) + self.prob_proj(probs)[:, None, :]
        for layer in self.layers:
            x = layer(x)
        return self.to_latent(x)


class TransformerWDecoder(nn.Module):
    """z1 as cross-attention memory, z2 as target tokens
    (``w_networks.py:145-187``)."""

    def __init__(
        self, embedding_dim: int, z1_dim: int, z2_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act,
    ) -> None:
        super().__init__()
        self.proj_dim, self.n_heads, self.mlp_dims, self.act = proj_dim, n_heads, mlp_dims, act
        self.n_codes, self.embedding_dim = n_codes, embedding_dim
        self.z1_proj = DenseBlock(z1_dim, proj_dim, batch_norm=False)
        self.z2_proj = DenseBlock(z2_dim, proj_dim, batch_norm=False)
        self.memory_positional_embedding = _positional(n_codes, proj_dim)
        self.positional_embedding = _positional(n_codes, proj_dim)
        self.layers = nn.ModuleList(TransformerDecoderLayer(proj_dim, n_heads, f, act) for f in mlp_dims)
        self.compress = DenseBlock(proj_dim, embedding_dim, batch_norm=False)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        b = z1.shape[0]
        shape = (b, self.n_codes, self.proj_dim)
        memory = self.z1_proj(z1).expand(shape) + self.memory_positional_embedding
        x = self.z2_proj(z2).expand(shape) + self.positional_embedding
        for layer in self.layers:
            x = layer(x, memory)
        return self.compress(x).reshape(b, self.n_codes * self.embedding_dim)


class ConditionalPrior(nn.Module):
    """Linear conditional prior: probs -> per-code ``(mu, log_var)`` of z2
    (``w_networks.py:190-202``)."""

    def __init__(self, n_classes: int, n_codes: int, z2_dim: int) -> None:
        super().__init__()
        self.n_codes, self.z2_dim = n_codes, z2_dim
        self.prior = DenseBlock(n_classes, n_codes * 2 * z2_dim, batch_norm=False)

    def forward(self, probs: torch.Tensor) -> torch.Tensor:
        return self.prior(probs).reshape(-1, self.n_codes, 2 * self.z2_dim)
