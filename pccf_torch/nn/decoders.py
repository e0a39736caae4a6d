"""PCGen point-cloud decoder (``pccf/nn/decoders.py``).

Eval: the map MLP up to its penultimate layer stays ``torch.matmul`` (it lies
outside the Pallas kernel in JAX too); the Hardtanh map head, the ``w ⊙ map``
join, the component stacks, their heads and the tempered-softmax mix run in
the ``pcgen_mix`` kernels when the JAX package's gate holds
(``decoders.py:135-155`` ``_fused_eval_ok`` with
``pallas_pcgen.py:60-74`` ``pcgen_fused_supported``,
:func:`pccf_torch.kernels.pcgen.supported`), and module by module where it
fails, as JAX leaves such a decoder to its XLA layers, on either device.
Training (``module.train()``) runs module by module with batch-stat
BatchNorm and Gumbel-softmax attention, whose products are plain
``torch.matmul`` as in JAX.  Either way graph filtering (kNN with k=4, then
the neighbour gather kernel) sharpens the mixed cloud when ``filtering`` is
on, as the flagship configuration has it.

Expert parallelism (:func:`pccf_torch.dist.sharding.shard_variables_ep`)
leaves a rank ``G / mp`` of the components (``self.ep``).  The mix is a
softmax over every component's logit, so a rank cannot mix alone.  In eval
on the fused path the kernel's partial mode gives the rank's share of the
logits and its heads; the logits are summed over ``mp``, the rank mixes its
heads with its slice of the softmax and the mixtures are summed (two small
all-reduces, ``G`` and 3 floats a point).  With a gradient (the module
path) the placement is GSPMD's (``pccf/dist/sharding.py:52-56``): the
joined latent enters this rank's components through ``copy_to_mp`` (its
gradient summed over ``mp``), the components' features are gathered, the
attention runs replicated (its gradient whole on every rank), each rank
mixes its heads, and the sum over ``mp`` of the mixtures is the output, its
backward the identity.
"""

from __future__ import annotations

import torch
from torch import nn

from pccf_torch.config import AutoEncoderConfig
from pccf_torch.dist import tp
from pccf_torch.kernels import api, ops, pcgen
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
        self.ep: tp.ExpertShard | None = None  # this rank's components under expert parallelism
        self._share: tuple[PCGenPack, PCGenPack] | None = None

    def fused_ok(self, n_points: int | None = None) -> bool:
        """The gate of the fused path (``decoders.py:135-155``): a (leaky) ReLU
        the kernels hard-code, and ``pcgen_fused_supported``'s shape terms
        (:func:`pccf_torch.kernels.pcgen.supported`: points in multiples of
        256, a 128-multiple ``w_dim``, layers non-expanding after the first,
        at least two components); ``n_points`` None (``prepack``, which packs
        for any point count) checks every term but the points'."""
        return act_slope(self.act) is not None and pcgen.supported(
            pcgen.TILE if n_points is None else n_points, self.w_dim, self.conv_dims, self.n_components)

    @torch.no_grad()
    def pack(self) -> PCGenPack:
        """Fold each component layer's BatchNorm into its weight
        (``pccf/kernels/pallas_pcgen.py:223``): ``W · a`` (rows of the torch
        ``(…, out, in)`` layout) and ``β − μ · a``, ``a`` as the module
        computes it (:meth:`~pccf_torch.nn.layers.BatchNorm.affine`)."""
        ws, bs = [], []
        for layer in self.components.conv:
            a, b = layer.bn.affine()
            ws.append(layer.dense.weight * a[..., :, None])
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
        elif self.fused_ok(x.shape[1]):
            pack = self.packed if self.packed is not None else self.pack()
            if self.ep is None:
                x = api.pcgen_mix(x.contiguous(), w.contiguous(), pack, tau=self.tau, act_slope=act_slope(self.act))
            else:
                x = self._mix_shares(x.contiguous(), w.contiguous(), pack)
        else:
            x = self._mix_modules(x, w, None)
        return api.graph_filtering(x.contiguous()) if self.filtering else x

    def _mix_shares(self, m: torch.Tensor, w: torch.Tensor, pack: PCGenPack) -> torch.Tensor:
        """The expert-parallel fused decode: this rank's share of the logits
        and its heads from the kernel's partial mode, the logits summed over
        ``mp``, this rank's mixture, the mixtures summed."""
        ep = self.ep
        if self._share is None or self._share[0] is not pack:  # a prepacked decoder folds its share once
            self._share = (pack, pack.share(ep.g0, ep.count, ep.grid.index(ep.axis) == 0))
        share = self._share[1]
        logits, heads = api.pcgen_partial(m, w, share, act_slope=act_slope(self.act))
        return ep.summed(ops.pcgen_mix_share(ep.summed(logits), heads, ep.g0, self.tau))

    def _mix_modules(self, m: torch.Tensor, w: torch.Tensor, gumbel_uniform: torch.Tensor | None) -> torch.Tensor:
        """Map head, join, components, heads and the attention mix, module by
        module (``decoders.py:87-128``); under expert parallelism this rank's
        components, their features gathered for the attention."""
        x = w[:, None, :] * self.map_out(m)  # join (decoders.py:92)
        g = self.n_components
        if self.ep is not None:  # the joined latent feeds this rank's components: its gradient summed over mp
            g, x = self.ep.count, self.ep.copy(x)
        feats = self.components(x.expand(g, *x.shape))  # (G, B, N, D_last)
        comps = self.component_heads(feats)  # (G, B, N, 3)
        if self.n_components == 1:
            return comps[0]
        if self.ep is not None:
            feats = self.ep.gather(feats)
        att = self.att(torch.cat(list(feats), dim=-1))
        if self.training:
            if gumbel_uniform is None:
                raise ValueError('PCGenDecoder: training needs the Gumbel noise (gumbel_uniform)')
            att = gumbel_softmax(att, self.tau, gumbel_uniform)
        else:
            att = ops.temperature_softmax(att, self.tau)
        if self.ep is None:
            return torch.einsum('bng,gbnc->bnc', att, comps)
        return self.ep.psum(torch.einsum('bng,gbnc->bnc', self.ep.columns(att), comps))


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
