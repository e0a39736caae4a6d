"""Gradient operations applied before the optimiser (``pccf/train/grad_ops.py``).

Stage 2 clips every parameter's gradient against the history of its own
norms (``param_hist_clipper``, ``grad_ops.py:109-147``): a gradient whose L2
norm exceeds the threshold is scaled down to it, the threshold being
``1.5 · EMA`` of past norms (``EMA``) or ``mean + 2 · std`` (``ZStat``).  The
first step clips nothing and seeds the statistics with its norms.  The
statistics live on the parameters' device, so a step never waits for the
host.  One statistic per parameter tensor: the port's parameters map one to
one onto the flax leaves the JAX clipper walks.
"""

from __future__ import annotations

from typing import Iterable

import torch


class ParamHistClipper:
    """Per-parameter history clipping of ``p.grad`` in place."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]], criterion: str = 'EMA',
                 decay: float = 0.9) -> None:
        if criterion not in ('EMA', 'ZStat'):
            raise ValueError(f'unknown clip criterion {criterion!r}')
        self.names, self.params = map(list, zip(*named_params))
        self.criterion, self.decay = criterion, decay
        dev = self.params[0].device
        self.mean = torch.zeros(len(self.params), device=dev)
        self.var = torch.zeros(len(self.params), device=dev)
        self.seen = 0

    def threshold(self) -> torch.Tensor:
        if self.criterion == 'ZStat':
            return self.mean + 2.0 * torch.sqrt(torch.clamp_min(self.var, 0.0))
        return 1.5 * self.mean

    @torch.no_grad()
    def __call__(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        first = self.seen == 0
        threshold = self.threshold()
        clip = (norms > threshold) & (threshold > 0) & (not first)
        scale = torch.where(clip, threshold / torch.clamp_min(norms, 1e-12), torch.ones_like(norms))
        for g, s in zip(grads, scale):
            g.mul_(s)
        eff = torch.where(clip, threshold, norms)
        if first:
            self.mean, self.var = norms, torch.zeros_like(norms)
        else:
            self.mean = self.decay * self.mean + (1 - self.decay) * eff
            self.var = self.decay * self.var + (1 - self.decay) * (eff - self.mean) ** 2
        for p, g in zip(self.params, grads):
            if p.grad is None:
                p.grad = g
        self.seen += 1

    def state(self) -> dict[str, tuple[float, float]]:
        """``name -> (mean, var)`` of the gradient norms, on the host."""
        return dict(zip(self.names, zip(self.mean.tolist(), self.var.tolist())))


def get_grad_op(name: str | None, named_params, criterion: str = 'ZStat') -> ParamHistClipper | None:
    """The registry lookup of ``grad_ops.py:150-166`` for what the port has:
    ``None`` (no operation) and ``ParamHistClipper``; any other name raises."""
    if name is None:
        return None
    if name == 'ParamHistClipper':
        return ParamHistClipper(named_params, criterion)
    raise ValueError(f'gradient op {name!r} is not ported; pccf_torch has ParamHistClipper')
