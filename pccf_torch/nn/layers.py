"""Layer library (``pccf/nn/layers.py``), channels-last.

``module.train()`` selects the JAX ``train=True`` path: BatchNorm normalises
with batch statistics and updates its running statistics.  Dropout is not
ported: the stage-1 VQ-VAE has none.

Parameter layouts are torch's (``weight`` is ``(out, in)``);
:mod:`pccf_torch.convert` maps the flax variable tree onto them.  Module
attribute names follow the flax submodule names (``dense``, ``bn``,
``norm_0`` for ``LayerNorm_0``, ``attn_0`` for
``MultiHeadDotProductAttention_0``, ``dense_0`` for ``Dense_0``) so the
conversion is mechanical.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from pccf_torch.kernels import ops

Tensor = torch.Tensor
Act = Callable[[Tensor], Tensor]

LN_EPS = 1e-6  # flax.linen.LayerNorm default (pallas_wformer.py:38)
BN_EPS = 1e-5


def default_act(x: Tensor) -> Tensor:
    """LeakyReLU(0.2), the reference DEFAULT_ACT."""
    return F.leaky_relu(x, 0.2)


def relu(x: Tensor) -> Tensor:
    return F.relu(x)


def hard_tanh(x: Tensor) -> Tensor:
    return F.hardtanh(x)


gelu_exact = ops.gelu_exact

# act_name -> the shared callable (``pccf/config/specs.py:50-60``); fused
# paths identity-check the callable, as the JAX package does
ACTIVATIONS: dict[str, Act] = {
    '': default_act,
    'LeakyReLU': default_act,
    'ReLU': relu,
    'GELU': gelu_exact,
    'Hardtanh': hard_tanh,
}


def get_act(name: str) -> Act:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f'unknown activation {name!r}') from None


def act_slope(act: Act | None) -> float | None:
    """Negative slope of a (leaky) ReLU callable, None for anything else."""
    if act is relu:
        return 0.0
    if act is default_act:
        return 0.2
    return None


BN_MOMENTUM = 0.9  # flax's momentum: running = 0.9 * running + 0.1 * batch


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax ``nn.BatchNorm``, one statistics
    group: ``PCCF_BN_GROUPS`` is not ported).

    ``shape`` may carry leading stack axes (the vmapped PCGen components); in
    training the statistics are then taken per stack entry, over every axis
    between the stack axes and the features.  Training normalises with the
    batch mean and the biased variance ``max(E[x²] − E[x]², 0)`` and moves
    the running statistics towards them with momentum 0.9 — the biased
    variance, unlike ``torch.nn.BatchNorm1d``'s unbiased update."""

    def __init__(self, *shape: int, eps: float = BN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer('running_mean', torch.zeros(shape))
        self.register_buffer('running_var', torch.ones(shape))

    def forward(self, x: Tensor) -> Tensor:
        stack = self.weight.dim() - 1
        view = x.shape[:stack] + (1,) * (x.dim() - stack - 1) + x.shape[-1:]
        if self.training:
            axes = tuple(range(stack, x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.clamp_min(torch.mean(x * x, dim=axes) - mean * mean, 0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax order: (x − μ) · (γ · rsqrt(σ² + ε)) + β
        a = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(view)) * a.view(view) + self.bias.view(view)

    @torch.no_grad()
    def update_running(self, mean: Tensor, var: Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)

    def affine(self) -> tuple[Tensor, Tensor]:
        """``(a, b)`` with ``bn(x) = x · a + b`` under the running statistics."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a


class GroupedLinear(nn.Module):
    """Grouped dense: features split into ``groups`` independent blocks."""

    def __init__(self, in_features: int, out_features: int, groups: int, bias: bool) -> None:
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError('features not divisible by groups')
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(groups, out_features // groups, in_features // groups))
        self.bias = nn.Parameter(torch.zeros(groups, out_features // groups)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        xg = x.reshape(*x.shape[:-1], self.groups, -1)
        y = torch.einsum('...gi,goi->...go', xg, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*x.shape[:-1], -1)


class StackedLinear(nn.Module):
    """``G`` independent dense layers applied to ``(G, …, in)`` inputs (the
    vmapped PCGen component layers); ``weight`` is ``(G, out, in)``."""

    def __init__(self, stack: int, in_features: int, out_features: int, bias: bool) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(stack, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(stack, out_features)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        g = self.weight.shape[0]
        y = torch.matmul(x.reshape(g, -1, x.shape[-1]), self.weight.transpose(-1, -2))
        if self.bias is not None:
            y = y + self.bias[:, None, :]
        return y.reshape(*x.shape[:-1], -1)


class DenseBlock(nn.Module):
    """dense + optional running-stat BatchNorm + activation + interleaved
    residual (``pccf/nn/layers.py:119``), eval only."""

    def __init__(
        self,
        in_features: int,
        features: int,
        act: Act | None = None,
        batch_norm: bool = True,
        groups: int = 1,
        residual: bool = False,
    ) -> None:
        super().__init__()
        self.features = features
        self.act = act
        self.residual = residual
        if groups == 1:
            self.dense = nn.Linear(in_features, features, bias=not batch_norm)
        else:
            self.dense = GroupedLinear(in_features, features, groups, bias=not batch_norm)
        self.bn = BatchNorm(features) if batch_norm else None

    def forward(self, x: Tensor) -> Tensor:
        y = self.dense(x)
        if self.bn is not None:
            y = self.bn(y)
        if self.act is not None:
            y = self.act(y)
        if self.residual:
            y = y + ops.interleave_residual(x, self.features)
        return y


def gumbel_softmax(logits: Tensor, tau: float, uniform: Tensor, dim: int = -1) -> Tensor:
    """Soft Gumbel-softmax sample (``pccf/nn/layers.py:200-203``) from
    uniform noise in ``[1e-20, 1)`` drawn by the caller's generator."""
    gumbel = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
    return torch.softmax((logits + gumbel) / tau, dim=dim)


def gumbel_uniform(shape: tuple[int, ...], generator: torch.Generator, device: torch.device) -> Tensor:
    """``U[1e-20, 1)`` noise for :func:`gumbel_softmax` (``jax.random.uniform``
    with ``minval=1e-20``), from an explicit generator on ``device``."""
    return torch.rand(shape, generator=generator, device=device).clamp_min_(1e-20)


class MLPHead(nn.Module):
    """Dense stack (BN + act) then a biased linear output (``layers.py:206``);
    dropout is the identity in eval."""

    def __init__(self, in_features: int, dims: tuple[int, ...], out_features: int, act: Act) -> None:
        super().__init__()
        widths = (in_features, *dims)
        blocks = [DenseBlock(widths[i], widths[i + 1], act=act) for i in range(len(dims))]
        blocks.append(DenseBlock(widths[-1], out_features, act=None, batch_norm=False))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: Tensor) -> Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with heads laid out ``(H, hd)``
    along the projected features; projections are ``nn.Linear``s."""

    def __init__(self, d_model: int, n_heads: int) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: Tensor, kv: Tensor) -> Tensor:
        o = ops.attention(self.query(x), self.key(kv), self.value(kv), self.n_heads)
        return self.out(o)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer (``layers.py:231``), eval."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, act: Act) -> None:
        super().__init__()
        self.act = act
        self.norm_0 = _layer_norm(d_model)
        self.attn_0 = MultiHeadAttention(d_model, n_heads)
        self.norm_1 = _layer_norm(d_model)
        self.dense_0 = nn.Linear(d_model, d_ff)
        self.dense_1 = nn.Linear(d_ff, d_model)

    def forward(self, x: Tensor) -> Tensor:
        h = self.norm_0(x)
        x = x + self.attn_0(h, h)
        return x + self.dense_1(self.act(self.dense_0(self.norm_1(x))))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm decoder layer with cross-attention memory (``layers.py:260``)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, act: Act) -> None:
        super().__init__()
        self.act = act
        self.norm_0 = _layer_norm(d_model)
        self.attn_0 = MultiHeadAttention(d_model, n_heads)
        self.norm_1 = _layer_norm(d_model)
        self.attn_1 = MultiHeadAttention(d_model, n_heads)
        self.norm_2 = _layer_norm(d_model)
        self.dense_0 = nn.Linear(d_model, d_ff)
        self.dense_1 = nn.Linear(d_ff, d_model)

    def forward(self, x: Tensor, memory: Tensor) -> Tensor:
        h = self.norm_0(x)
        x = x + self.attn_0(h, h)
        x = x + self.attn_1(self.norm_1(x), memory)
        return x + self.dense_1(self.act(self.dense_0(self.norm_2(x))))


@torch.no_grad()
def init_from_seed(module: nn.Module, seed: int) -> None:
    """Random weights for a model with no JAX checkpoint, from ``seed``.

    Matrices draw ``N(0, 1/fan_in)``, biases ``N(0, 0.02²)``, LayerNorm and
    BatchNorm scales ``U(0.8, 1.2)``, BatchNorm shifts ``N(0, 0.1²)``,
    running means ``N(0, 0.1²)`` and running variances ``U(0.5, 2)`` — the
    non-trivial running statistics make the folded BatchNorm affine do real
    work; embeddings and codebooks draw ``N(0, 1)`` as flax initialises them.
    """
    gen = torch.Generator().manual_seed(seed)

    def normal(t: Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    def uniform(t: Tensor, lo: float, hi: float) -> None:
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen))

    for mod in module.modules():
        for name, p in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            if isinstance(mod, (BatchNorm, nn.LayerNorm)):
                if name == 'weight':
                    uniform(p, 0.8, 1.2)
                elif name == 'bias':
                    normal(p, 0.1 if isinstance(mod, BatchNorm) else 0.02)
                elif name == 'running_mean':
                    normal(p, 0.1)
                elif name == 'running_var':
                    uniform(p, 0.5, 2.0)
            elif name == 'weight':
                normal(p, 1.0 / math.sqrt(p.shape[-1]))
            elif name == 'bias':
                normal(p, 0.02)
            else:  # codebook, positional encodings
                normal(p, 1.0)
