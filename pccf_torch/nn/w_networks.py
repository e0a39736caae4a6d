"""Inner (W-space) networks (``pccf/nn/w_networks.py``).

All operate on the code axis: inputs ``(B, n_codes, embedding_dim)``.  In
eval, a transformer net whose shape passes the stack gate
(``w_networks.py:42-63`` ``_fused_stack_ok``: the exact GELU and
``wformer_supported``'s shape line, :func:`pccf_torch.kernels.wformer.supported`)
runs its layer stack through :func:`pccf_torch.kernels.api.wformer_encoder` /
``wformer_decoder``, packed from the live weights on every call: the kernel
on a CUDA tensor, its plain version on a CPU tensor.  A net whose gate fails
runs its layers one by one, as the JAX package leaves such a net to its XLA
layers, on either device; so does every net in training, with dropout masks
drawn from the ``generator`` passed in.  The parameters also feed the CVAE
chain's weight pack (:func:`pccf_torch.kernels.cvae.pack_cvae_cf`).

The convolutional W-encoder (per-code Dense + BatchNorm stacks with no
activation) and the linear W-decoder (per-code grouped Dense stacks) are
module layers on either device, as in the JAX package; :func:`get_w_encoder`,
:func:`get_w_decoder` and :func:`get_conditional_w_encoder` build each net
from the configuration.
"""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import SliceConfig
from pccf_torch.kernels import api, wformer
from pccf_torch.nn.layers import (Act, DenseBlock, TransformerDecoderLayer, TransformerEncoderLayer, dropout,
                                  gelu_exact, get_act)

Generator = torch.Generator | None


def _positional(n_codes: int, d: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(1, n_codes, d))


def _rates(dropout_rates: tuple[float, ...], n_layers: int) -> list[float]:
    """One rate per layer, zero past the configured ones (``w_networks.py:103``)."""
    return (list(dropout_rates) + [0.0] * n_layers)[:n_layers]


class _TransformerNet(nn.Module):
    """What the three nets share: widths, activation, and the stack gate."""

    def __init__(self, n_codes: int, proj_dim: int, n_heads: int, mlp_dims: tuple[int, ...], act: Act) -> None:
        super().__init__()
        self.n_codes, self.proj_dim, self.n_heads, self.mlp_dims, self.act = n_codes, proj_dim, n_heads, mlp_dims, act

    def stack_ok(self) -> bool:
        """``_fused_stack_ok`` (``w_networks.py:42-63``): eval, the exact GELU,
        and ``wformer_supported``'s shape line
        (:func:`pccf_torch.kernels.wformer.supported`)."""
        return not self.training and self.act is gelu_exact and wformer.supported(
            self.n_codes, self.proj_dim, self.n_heads)


class _TransformerEncoderNet(_TransformerNet):
    def __init__(self, n_codes, proj_dim, n_heads, mlp_dims, act, dropout_rates) -> None:
        super().__init__(n_codes, proj_dim, n_heads, mlp_dims, act)
        rates = _rates(dropout_rates, len(mlp_dims))
        self.layers = nn.ModuleList(TransformerEncoderLayer(proj_dim, n_heads, f, act, r)
                                    for f, r in zip(mlp_dims, rates))

    def stack(self, x: torch.Tensor, generator: Generator) -> torch.Tensor:
        if self.stack_ok():
            return api.wformer_encoder(x.contiguous(), wformer.pack_encoder(self.layers), self.n_heads)
        for layer in self.layers:
            x = layer(x, generator)
        return x


class TransformerWEncoder(_TransformerEncoderNet):
    """Token-per-code transformer encoder (``w_networks.py:84-113``)."""

    def __init__(
        self, embedding_dim: int, z1_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act, dropout_rates: tuple[float, ...] = (),
    ) -> None:
        super().__init__(n_codes, proj_dim, n_heads, mlp_dims, act, dropout_rates)
        self.input_proj = DenseBlock(embedding_dim, proj_dim, batch_norm=False)
        self.positional_encoding = _positional(n_codes, proj_dim)
        self.to_latent = DenseBlock(proj_dim, 2 * z1_dim, batch_norm=False)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        x = self.input_proj(x) + self.positional_encoding
        return self.to_latent(self.stack(x, generator))


class TransformerWConditionalEncoder(_TransformerEncoderNet):
    """Posterior-difference net conditioned on class probabilities
    (``w_networks.py:205-236``)."""

    def __init__(
        self, embedding_dim: int, n_classes: int, z2_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act, dropout_rates: tuple[float, ...] = (),
    ) -> None:
        super().__init__(n_codes, proj_dim, n_heads, mlp_dims, act, dropout_rates)
        self.input_proj = DenseBlock(embedding_dim, proj_dim, batch_norm=False)
        self.positional_encoding = _positional(n_codes, proj_dim)
        self.prob_proj = DenseBlock(n_classes, proj_dim, batch_norm=False)
        self.to_latent = DenseBlock(proj_dim, 2 * z2_dim, batch_norm=False)

    def forward(self, probs: torch.Tensor, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        x = self.positional_encoding + self.input_proj(x) + self.prob_proj(probs)[:, None, :]
        return self.to_latent(self.stack(x, generator))


class TransformerWDecoder(_TransformerNet):
    """z1 as cross-attention memory, z2 as target tokens
    (``w_networks.py:145-187``).  A z1 of one row ``(B, 1, z1_dim)`` (drawn
    from the unconditional prior) is broadcast across the code tokens."""

    def __init__(
        self, embedding_dim: int, z1_dim: int, z2_dim: int, n_codes: int, proj_dim: int, n_heads: int,
        mlp_dims: tuple[int, ...], act: Act, dropout_rates: tuple[float, ...] = (),
    ) -> None:
        super().__init__(n_codes, proj_dim, n_heads, mlp_dims, act)
        self.embedding_dim = embedding_dim
        self.z1_proj = DenseBlock(z1_dim, proj_dim, batch_norm=False)
        self.z2_proj = DenseBlock(z2_dim, proj_dim, batch_norm=False)
        self.memory_positional_embedding = _positional(n_codes, proj_dim)
        self.positional_embedding = _positional(n_codes, proj_dim)
        rates = _rates(dropout_rates, len(mlp_dims))
        self.layers = nn.ModuleList(TransformerDecoderLayer(proj_dim, n_heads, f, act, r)
                                    for f, r in zip(mlp_dims, rates))
        self.compress = DenseBlock(proj_dim, embedding_dim, batch_norm=False)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        b = z1.shape[0]
        shape = (b, self.n_codes, self.proj_dim)
        memory = self.z1_proj(z1).expand(shape) + self.memory_positional_embedding
        x = self.z2_proj(z2).expand(shape) + self.positional_embedding
        if self.stack_ok():
            x = api.wformer_decoder(x.contiguous(), memory.contiguous(), wformer.pack_decoder(self.layers),
                                    self.n_heads)
        else:
            for layer in self.layers:
                x = layer(x, memory, generator)
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


class ConvolutionalWEncoder(nn.Module):
    """Per-code Dense + BatchNorm stack with no activation, then a Dense head
    (``w_networks.py:66-81``: the reference builds its layers with no
    activation, and the JAX package keeps that)."""

    def __init__(self, embedding_dim: int, z1_dim: int, conv_dims: tuple[int, ...]) -> None:
        super().__init__()
        widths = (embedding_dim, *conv_dims)
        self.conv = nn.ModuleList(DenseBlock(widths[i], widths[i + 1]) for i in range(len(conv_dims)))
        self.head = DenseBlock(widths[-1], 2 * z1_dim, batch_norm=False)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        for block in self.conv:
            x = block(x)
        return self.head(x)


class LinearWDecoder(nn.Module):
    """Grouped per-code MLP decoder (``w_networks.py:116-142``): z1 and z2
    joined per code, flattened into one row, then Dense + BatchNorm + act
    stacks grouped by code, each followed by dropout in training, and a
    grouped Dense head to ``w_dim``.  A z1 of one row ``(B, 1, z1_dim)``
    (drawn from the unconditional prior) is broadcast across the codes."""

    def __init__(self, w_dim: int, z1_dim: int, z2_dim: int, n_codes: int, mlp_dims: tuple[int, ...], act: Act,
                 dropout_rates: tuple[float, ...] = ()) -> None:
        super().__init__()
        self.n_codes = n_codes
        widths = (n_codes * (z1_dim + z2_dim), *mlp_dims)
        self.mlp = nn.ModuleList(DenseBlock(widths[i], widths[i + 1], act=act, groups=n_codes)
                                 for i in range(len(mlp_dims)))
        self.rates = _rates(dropout_rates, len(mlp_dims))
        self.head = DenseBlock(widths[-1], w_dim, batch_norm=False, groups=n_codes)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        if z1.shape[1] == 1 and z2.shape[1] != 1:
            z1 = z1.expand(z1.shape[0], z2.shape[1], z1.shape[2])
        x = torch.cat([z1, z2], dim=-1).reshape(z1.shape[0], 1, -1)
        for block, rate in zip(self.mlp, self.rates):
            x = dropout(block(x), rate if self.training else 0.0, generator)
        return self.head(x)[:, 0, :]


def get_w_encoder(cfg: SliceConfig) -> nn.Module:
    """The W-encoder of ``w_autoencoder.model.w_encoder`` (``w_networks.py:239-255``)."""
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    we = wae.w_encoder
    if we.class_name == 'Convolutional':
        return ConvolutionalWEncoder(ae.embedding_dim, wae.z1_dim, we.conv_dims)
    return TransformerWEncoder(ae.embedding_dim, wae.z1_dim, ae.n_codes, we.proj_dim, we.n_heads, we.mlp_dims,
                               get_act(we.act_name), we.dropout_rates)


def get_w_decoder(cfg: SliceConfig) -> nn.Module:
    """The W-decoder of ``w_autoencoder.model.w_decoder`` (``w_networks.py:258-282``)."""
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    wd = wae.w_decoder
    if wd.class_name == 'Linear':
        return LinearWDecoder(ae.w_dim, wae.z1_dim, wae.z2_dim, ae.n_codes, wd.mlp_dims, get_act(wd.act_name),
                              wd.dropout_rates)
    return TransformerWDecoder(ae.embedding_dim, wae.z1_dim, wae.z2_dim, ae.n_codes, wd.proj_dim, wd.n_heads,
                               wd.mlp_dims, get_act(wd.act_name), wd.dropout_rates)


def get_conditional_w_encoder(cfg: SliceConfig) -> nn.Module:
    """The posterior-difference net (``w_networks.py:285-298``)."""
    ae, wae = cfg.autoencoder, cfg.w_autoencoder
    cw = wae.conditional_w_encoder
    return TransformerWConditionalEncoder(ae.embedding_dim, cfg.data.n_classes, wae.z2_dim, ae.n_codes, cw.proj_dim,
                                          cw.n_heads, cw.mlp_dims, get_act(cw.act_name), cw.dropout_rates)
