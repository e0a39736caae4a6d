"""Layer library (``pccf/nn/layers.py``), channels-last.

``module.train()`` selects the JAX ``train=True`` path: BatchNorm normalises
with batch statistics and updates its running statistics, and the
transformer layers apply dropout (flax ``nn.Dropout`` on each residual branch
and after the FF activation, and the attention's ``broadcast_dropout``) with
masks drawn from the caller's ``torch.Generator``.

Parameter layouts are torch's (``weight`` is ``(out, in)``);
:mod:`pccf_torch.convert` maps the flax variable tree onto them.  Module
attribute names follow the flax submodule names (``dense``, ``bn``,
``norm_0`` for ``LayerNorm_0``, ``attn_0`` for
``MultiHeadDotProductAttention_0``, ``dense_0`` for ``Dense_0``) so the
conversion is mechanical.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from pccf_torch.dist import mesh
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


def bn_groups() -> int:
    """BatchNorm statistic groups, ``PCCF_BN_GROUPS`` (``pccf/nn/layers.py:27-40``):
    1 (the default) takes the statistics over the global batch, as GSPMD
    does; G > 1 over each contiguous group of B/G samples of the global
    batch, the reference's per-replica DDP BatchNorm with G replicas."""
    return max(1, int(os.environ.get('PCCF_BN_GROUPS', '1')))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax ``nn.BatchNorm``, and
    ``GroupedBatchNorm`` under :func:`bn_groups`, ``layers.py:43-87``).

    ``shape`` may carry leading stack axes (the vmapped PCGen components); in
    training the statistics are then taken per stack entry, over every axis
    between the stack axes and the features.  Training normalises with the
    batch mean and the biased variance ``max(E[x²] − E[x]², 0)`` of each
    statistic group (:func:`pccf_torch.dist.mesh.group_moments`: over the
    global batch in a data-parallel step) and moves the running statistics
    towards their mean over the groups with momentum 0.9 — the biased
    variance, unlike ``torch.nn.BatchNorm1d``'s unbiased update.  The
    parameter and buffer names do not depend on the groups."""

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
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            groups = bn_groups()
            mean, sq = mesh.group_moments([x, lambda: x * x], groups, stack)  # (*S, G, F)
            if groups == 1:
                mean, sq = mean.squeeze(-2), sq.squeeze(-2)  # views: no copy in the backward
            var = torch.clamp_min(sq - mean * mean, 0.0)
            if groups > 1:
                self.update_running(mean.mean(dim=-2), var.mean(dim=-2))
                n = x.shape[stack]
                rows = x.shape[:stack + 1] + (1,) * (x.dim() - stack - 2) + x.shape[-1:]
                a = self.weight.unsqueeze(-2) * torch.rsqrt(var + self.eps)
                return ((x - mesh.expand_groups(mean, n, groups).view(rows))
                        * mesh.expand_groups(a, n, groups).view(rows) + self.bias.view(view))
            self.update_running(mean, var)
        # flax order: (x − μ) · (γ · rsqrt(σ² + ε)) + β
        a = self.scale(var)
        return (x - mean.view(view)) * a.view(view) + self.bias.view(view)

    def scale(self, var: Tensor) -> Tensor:
        """``γ · rsqrt(σ² + ε)`` as JAX computes it.  Under the server's bf16
        cast (:func:`pccf_torch.serve.bf16_copy`) every JAX parameter is bf16:
        its compiled graph rounds the sum and the rsqrt to bf16 and fuses the
        product with γ into the float32 products that read it."""
        if not parametrize.is_parametrized(self):
            return self.weight * torch.rsqrt(var + self.eps)
        return self.weight * torch.rsqrt((var + self.eps).to(torch.bfloat16).float()).to(torch.bfloat16).float()

    @torch.no_grad()
    def update_running(self, mean: Tensor, var: Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)

    def affine(self) -> tuple[Tensor, Tensor]:
        """``(a, b)`` with ``bn(x) = x · a + b`` under the running statistics
        (the EdgeConv and PCGen folds), ``a`` as :meth:`scale` computes it."""
        a = self.scale(self.running_var)
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
    with ``minval=1e-20``), from an explicit generator on ``device``; axis 0
    is the batch (:func:`pccf_torch.dist.mesh.draw`)."""
    return mesh.draw(lambda s: torch.rand(s, generator=generator, device=device), shape).clamp_min_(1e-20)


class MLPHead(nn.Module):
    """Dense stack (BN + act) then a biased linear output (``layers.py:206``).
    In training, dropout at ``dropout_rates[i - 1]`` before hidden block
    ``i >= 1``, with masks from the caller's generator: as in the JAX package
    only the first ``len(dims) - 1`` rates are read, and nothing drops before
    the output layer.  Dropout is the identity in eval."""

    def __init__(self, in_features: int, dims: tuple[int, ...], out_features: int, act: Act,
                 dropout_rates: tuple[float, ...] = ()) -> None:
        super().__init__()
        widths = (in_features, *dims)
        blocks = [DenseBlock(widths[i], widths[i + 1], act=act) for i in range(len(dims))]
        blocks.append(DenseBlock(widths[-1], out_features, act=None, batch_norm=False))
        self.blocks = nn.ModuleList(blocks)
        self.rates = (0.0, *dropout_rates, *(0.0,) * len(dims))[: len(dims)] + (0.0,)

    def forward(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        for blk, rate in zip(self.blocks, self.rates):
            x = blk(dropout(x, rate if self.training else 0.0, generator))
        return x


def dropout(x: Tensor, rate: float, generator: torch.Generator | None) -> Tensor:
    """flax ``nn.Dropout`` in training: each element kept with probability
    ``1 - rate`` by its own draw and scaled by ``1 / (1 - rate)``.  Axis 0
    is the batch: in a data-parallel step the mask is the global batch's
    (:func:`pccf_torch.dist.mesh.draw`)."""
    if rate == 0.0:
        return x
    keep = mesh.draw(lambda shape: _keep(shape, rate, generator, x.device), x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _keep(shape: tuple[int, ...], rate: float, generator: torch.Generator | None, device) -> Tensor:
    if generator is None:
        raise ValueError('dropout in training draws its masks from an explicit torch.Generator')
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


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

    def forward(self, x: Tensor, kv: Tensor, rate: float = 0.0, generator: torch.Generator | None = None) -> Tensor:
        """``rate > 0`` drops attention weights with one ``(T, T_kv)`` mask
        shared by the batch and the heads (flax ``broadcast_dropout=True``)."""
        scale = None
        if rate > 0.0:
            keep = _keep((x.shape[-2], kv.shape[-2]), rate, generator, x.device)
            scale = keep.to(x.dtype) / (1.0 - rate)
        o = ops.attention(self.query(x), self.key(kv), self.value(kv), self.n_heads, weight_scale=scale)
        return self.out(o)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer (``layers.py:231-257``); in training, dropout
    at ``rate`` on the attention weights, the attention branch, after the FF
    activation and on the FF branch."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, act: Act, rate: float = 0.0) -> None:
        super().__init__()
        self.act, self.rate = act, rate
        self.norm_0 = _layer_norm(d_model)
        self.attn_0 = MultiHeadAttention(d_model, n_heads)
        self.norm_1 = _layer_norm(d_model)
        self.dense_0 = nn.Linear(d_model, d_ff)
        self.dense_1 = nn.Linear(d_ff, d_model)

    def forward(self, x: Tensor, generator: torch.Generator | None = None) -> Tensor:
        rate = self.rate if self.training else 0.0
        h = self.norm_0(x)
        x = x + dropout(self.attn_0(h, h, rate, generator), rate, generator)
        h = dropout(self.act(self.dense_0(self.norm_1(x))), rate, generator)
        return x + dropout(self.dense_1(h), rate, generator)


class TransformerDecoderLayer(nn.Module):
    """Pre-norm decoder layer with cross-attention memory
    (``layers.py:260-295``), dropout as the encoder layer's."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, act: Act, rate: float = 0.0) -> None:
        super().__init__()
        self.act, self.rate = act, rate
        self.norm_0 = _layer_norm(d_model)
        self.attn_0 = MultiHeadAttention(d_model, n_heads)
        self.norm_1 = _layer_norm(d_model)
        self.attn_1 = MultiHeadAttention(d_model, n_heads)
        self.norm_2 = _layer_norm(d_model)
        self.dense_0 = nn.Linear(d_model, d_ff)
        self.dense_1 = nn.Linear(d_ff, d_model)

    def forward(self, x: Tensor, memory: Tensor, generator: torch.Generator | None = None) -> Tensor:
        rate = self.rate if self.training else 0.0
        h = self.norm_0(x)
        x = x + dropout(self.attn_0(h, h, rate, generator), rate, generator)
        x = x + dropout(self.attn_1(self.norm_1(x), memory, rate, generator), rate, generator)
        h = dropout(self.act(self.dense_0(self.norm_2(x))), rate, generator)
        return x + dropout(self.dense_1(h), rate, generator)


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


@torch.no_grad()
def init_for_training(module: nn.Module, seed: int) -> None:
    """The initial weights of a model an entry point trains, from ``seed``,
    as flax initialises the JAX package's modules: matrices ``N(0,
    1/fan_in)`` (flax's LeCun normal without its truncation), biases and
    norm shifts 0, norm scales 1, running means 0 and variances 1; codebooks,
    positional encodings and pseudo-inputs ``N(0, 1)``."""
    gen = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        for name, p in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            if isinstance(mod, (BatchNorm, nn.LayerNorm)):
                p.fill_(1.0 if name in ('weight', 'running_var') else 0.0)
            elif name == 'weight':
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[-1]))
            elif name == 'bias':
                p.zero_()
            elif p.is_floating_point():
                p.copy_(torch.randn(p.shape, generator=gen))
