"""PCGen point-cloud decoder (``pccf/nn/decoders.py``).

Eval: the map MLP up to its penultimate layer stays ``torch.matmul`` (it lies
outside the Pallas kernel in JAX too); the Hardtanh map head, the ``w ⊙ map``
join, the component stacks, their heads and the tempered-softmax mix run in
the ``pcgen_mix`` kernel when the structural gate of ``pallas_pcgen.py:68-72``
holds.  Training (``module.train()``) runs module by module with batch-stat
BatchNorm and Gumbel-softmax attention, whose products are plain
``torch.matmul`` as in JAX.  Either way graph filtering (kNN with k=4, then
the neighbour gather kernel) sharpens the mixed cloud when ``filtering`` is
on, as the flagship configuration has it.
"""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import AutoEncoderConfig
from pccf_torch.kernels import api, ops
from pccf_torch.kernels.pcgen import PCGenPack
from pccf_torch.nn.layers import (Act, BatchNorm, DenseBlock, StackedLinear, act_slope, get_act, gumbel_softmax,
                                  hard_tanh, relu)

OUT_CHAN = 3


class StackedDenseBlock(nn.Module):
    """``G`` DenseBlocks side by side (the vmapped flax modules): inputs and
    outputs carry a leading ``G`` axis; BatchNorm statistics are ``(G, F)``."""

    def __init__(
        self, stack: int, in_features: int, features: int, act: Act | None, batch_norm: bool, residual: bool
    ) -> None:
        super().__init__()
        self.features = features
        self.act = act
        self.residual = residual
        self.dense = StackedLinear(stack, in_features, features, bias=not batch_norm)
        self.bn = BatchNorm(stack, features) if batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dense(x)
        if self.bn is not None:
            y = self.bn(y)
        if self.act is not None:
            y = self.act(y)
        if self.residual:
            y = y + ops.interleave_residual(x, self.features)
        return y


class ComponentStack(nn.Module):
    """The residual stacks of all components (``decoders.py:27``)."""

    def __init__(self, stack: int, in_features: int, conv_dims: tuple[int, ...], act: Act) -> None:
        super().__init__()
        widths = (in_features, *conv_dims)
        self.conv = nn.ModuleList(
            StackedDenseBlock(stack, widths[i], widths[i + 1], act, batch_norm=True, residual=True)
            for i in range(len(conv_dims))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv:
            x = layer(x)
        return x


class PCGenDecoder(nn.Module):
    """Map per-point Gaussian samples through an MLP, join with the latent by
    elementwise product, mix ``n_components`` residual stacks with tempered
    (eval) or Gumbel (training) softmax attention, and sharpen the result with
    graph filtering (``decoders.py:43-132``)."""

    def __init__(
        self,
        w_dim: int,
        sample_dim: int,
        n_components: int,
        map_dims: tuple[int, ...],
        conv_dims: tuple[int, ...],
        tau: float,
        act: Act,
        filtering: bool = False,
    ) -> None:
        super().__init__()
        self.w_dim = w_dim
        self.sample_dim = sample_dim
        self.n_components = n_components
        self.conv_dims = conv_dims
        self.tau = tau
        self.act = act
        self.filtering = filtering
        widths = (sample_dim, *map_dims)
        self.map = nn.ModuleList(
            DenseBlock(widths[i], widths[i + 1], act=relu, batch_norm=False) for i in range(len(map_dims))
        )
        self.map_out = DenseBlock(widths[-1], w_dim, act=hard_tanh, batch_norm=False)
        self.components = ComponentStack(n_components, w_dim, conv_dims, act)
        self.component_heads = StackedDenseBlock(
            n_components, conv_dims[-1], OUT_CHAN, None, batch_norm=False, residual=False
        )
        self.att = DenseBlock(n_components * conv_dims[-1], n_components, act=None, batch_norm=False)
        # weights folded for the kernel; set once by a server (prepack), else
        # folded on every call
        self.packed: PCGenPack | None = None

    def fused_ok(self) -> bool:
        """The structural gate of the fused path (``decoders.py:135-155``,
        ``pallas_pcgen.py:68-72``): a (leaky) ReLU the kernel hard-codes,
        at least two components, non-expanding layers after the first."""
        dims = (self.w_dim, *self.conv_dims)
        return (
            act_slope(self.act) is not None
            and self.n_components >= 2
            and all(dims[i + 1] < dims[i] for i in range(1, len(dims) - 1))
        )

    @torch.no_grad()
    def pack(self) -> PCGenPack:
        """Fold each component layer's BatchNorm into its weight."""
        ws, bs = [], []
        for layer in self.components.conv:
            bn = layer.bn
            w, b = ops.fold_bn_affine(layer.dense.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            ws.append(w)
            bs.append(b)
        heads = self.component_heads.dense
        return PCGenPack(
            map_w=self.map_out.dense.weight.detach(), map_b=self.map_out.dense.bias.detach(),
            layer_ws=tuple(ws), layer_bs=tuple(bs),
            head_w=heads.weight.detach(), head_b=heads.bias.detach(),
            att_w=self.att.dense.weight.detach(), att_b=self.att.dense.bias.detach(),
        )

    def forward(
        self, w: torch.Tensor, initial_sampling: torch.Tensor, gumbel_uniform: torch.Tensor | None = None
    ) -> torch.Tensor:
        """``w (B, w_dim)`` and the per-point Gaussian samples
        ``(B, n_out, sample_dim)`` -> ``(B, n_out, 3)``.  The sampling is always
        passed in, drawn by the caller's ``torch.Generator``; so is the
        training attention's uniform noise ``(B, n_out, n_components)``
        (:func:`pccf_torch.nn.layers.gumbel_uniform`)."""
        x = initial_sampling
        for block in self.map:
            x = block(x)
        if self.training:
            x = self._mix_modules(x, w, gumbel_uniform)
        elif self.fused_ok():
            pack = self.packed if self.packed is not None else self.pack()
            x = api.pcgen_mix(x.contiguous(), w.contiguous(), pack, tau=self.tau, act_slope=act_slope(self.act))
        elif x.is_cuda:
            raise NotImplementedError(
                'PCGenDecoder: the pcgen_mix gate failed ((leaky) ReLU, at least two components, non-expanding '
                'layers after the first); the module-by-module path runs on CPU tensors only'
            )
        else:
            x = self._mix_modules(x, w, None)
        return api.graph_filtering(x.contiguous()) if self.filtering else x

    def _mix_modules(self, m: torch.Tensor, w: torch.Tensor, gumbel_uniform: torch.Tensor | None) -> torch.Tensor:
        """Map head, join, components, heads and the attention mix, module by
        module (``decoders.py:87-128``)."""
        x = w[:, None, :] * self.map_out(m)  # join (decoders.py:92)
        g = self.n_components
        feats = self.components(x.expand(g, *x.shape))  # (G, B, N, D_last)
        comps = self.component_heads(feats)  # (G, B, N, 3)
        if g == 1:
            return comps[0]
        att = self.att(torch.cat(list(feats), dim=-1))
        if self.training:
            if gumbel_uniform is None:
                raise ValueError('PCGenDecoder: training needs the Gumbel noise (gumbel_uniform)')
            att = gumbel_softmax(att, self.tau, gumbel_uniform)
        else:
            att = ops.temperature_softmax(att, self.tau)
        return torch.einsum('bng,gbnc->bnc', att, comps)


def build_decoder(cfg: AutoEncoderConfig) -> PCGenDecoder:
    d = cfg.decoder
    return PCGenDecoder(
        w_dim=cfg.w_dim,
        sample_dim=d.sample_dim,
        n_components=d.n_components,
        map_dims=d.map_dims,
        conv_dims=d.conv_dims,
        tau=d.tau,
        act=get_act(d.act_name),
        filtering=d.filter,
    )
