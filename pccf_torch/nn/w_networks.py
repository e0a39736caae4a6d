"""Inner (W-space) transformer networks (``pccf/nn/w_networks.py``).

All operate on the code axis: inputs ``(B, n_codes, embedding_dim)``.  In
eval, a net whose shape passes the stack gate (``w_networks.py:42-63``:
exact GELU and the shapes the card's stack kernels cover,
:func:`pccf_torch.kernels.wformer.supported`) runs its layer stack
through :func:`pccf_torch.kernels.api.wformer_encoder` /
``wformer_decoder``, packed from the live weights on every call: the kernel
on a CUDA tensor, its plain version on a CPU tensor.  In training the layers
run one by one in plain PyTorch, as the JAX package leaves them to XLA, with
dropout masks drawn from the ``generator`` passed in.  In eval with the gate
failing they run one by one on a CPU tensor, and a CUDA tensor raises: the
card has no kernel for such a stack.  The parameters also feed the CVAE chain's weight
pack (:func:`pccf_torch.kernels.cvae.pack_cvae_cf`).
"""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.kernels import api, wformer
from pccf_torch.nn.layers import Act, DenseBlock, TransformerDecoderLayer, TransformerEncoderLayer, gelu_exact

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
        and the shapes the card's stack kernels cover, FF widths included
        (:func:`pccf_torch.kernels.wformer.supported`)."""
        return not self.training and self.act is gelu_exact and wformer.supported(
            self.n_codes, self.proj_dim, self.n_heads, self.mlp_dims)

    def use_kernel(self, x: torch.Tensor) -> bool:
        """Whether the stack runs through its wformer wrapper; raises in eval
        on a CUDA tensor when the gate fails."""
        if self.stack_ok():
            return True
        if not self.training and x.is_cuda:
            raise NotImplementedError(
                f'{type(self).__name__}: the wformer stack gate failed (exact GELU, tokens a multiple of 128 up to '
                f'{wformer.MAX_TOKENS}, width a multiple of 128, heads of {wformer.HEAD_DIM}, FF widths multiples '
                f'of {wformer.FF_MULTIPLE}; here {self.n_codes} tokens, width {self.proj_dim}, {self.n_heads} heads, '
                f'FF {self.mlp_dims}); the layer-by-layer eval path runs on CPU tensors only')
        return False


class _TransformerEncoderNet(_TransformerNet):
    def __init__(self, n_codes, proj_dim, n_heads, mlp_dims, act, dropout_rates) -> None:
        super().__init__(n_codes, proj_dim, n_heads, mlp_dims, act)
        rates = _rates(dropout_rates, len(mlp_dims))
        self.layers = nn.ModuleList(TransformerEncoderLayer(proj_dim, n_heads, f, act, r)
                                    for f, r in zip(mlp_dims, rates))

    def stack(self, x: torch.Tensor, generator: Generator) -> torch.Tensor:
        if self.use_kernel(x):
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
        if self.use_kernel(x):
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
