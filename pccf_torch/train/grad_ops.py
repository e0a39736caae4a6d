"""Gradient operations applied before the optimiser (``pccf/train/grad_ops.py``).

The six operations of the JAX registry (``grad_ops.py:150-166``), each
rewriting ``p.grad`` of the trained parameters in place:

- ``GradParamNormalizer``: every parameter's gradient to unit L2 norm;
- ``GradZScoreNormalizer``: every parameter's gradient to zero mean and unit
  (population) standard deviation;
- ``GradValueClipper``: every element into ``[-1, 1]`` (``optax.clip(1.0)``);
- ``GradNormClipper``: the global L2 norm down to 1 where it is not below it
  (``optax.clip_by_global_norm(1.0)``);
- ``HistClipper``: the global norm against the history of past global norms
  (``hist_clipper``, ``grad_ops.py:59-106``);
- ``ParamHistClipper``: every parameter's norm against the history of its own
  (``param_hist_clipper``, ``grad_ops.py:109-147``), stage 2's default.

The history clippers scale a norm above the threshold down to it, the
threshold being ``1.5 · EMA`` of past norms (``EMA``) or ``mean + 2 · std``
(``ZStat``) of the running statistics before this step.  The first step
clips nothing and seeds the statistics with its norm; a threshold of 0 (a
first norm of exactly 0) clips nothing, so the history recovers.  The
statistics live on the parameters' device, so a step never waits for the
host; ``seen`` counts the steps taken and is not the optimiser's step, so a
weights-only resume starts the history afresh.  :meth:`GradOp.state_dict`
and :meth:`GradOp.load_state_dict` carry the state through a checkpoint.

Under tensor parallelism (:mod:`pccf_torch.train.tp`) some gradients are
this rank's slice of a parameter's: :meth:`GradOp.shard_over` names them and
the sum over the ranks holding the other slices, so that every norm, mean
and deviation is the one-device gradient's (the slices' sums of squares
summed over the ranks, a replicated gradient counted once).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

EPS = 1e-12  # the floor of every divisor, as jnp.maximum(n, 1e-12) in grad_ops.py


class GradOp:
    """An operation on the gradients of ``named_params``; stateless unless a
    subclass says otherwise."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]]) -> None:
        self.names, self.params = map(list, zip(*named_params))
        self.sharded: torch.Tensor | None = None  # which gradients are slices (shard_over)
        self.reduce: Callable[[torch.Tensor], torch.Tensor] | None = None

    def shard_over(self, sharded: list[bool], reduce: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Mark the gradients that are this rank's slices; ``reduce`` sums a
        tensor over the ranks that hold the other slices."""
        self.sharded = torch.tensor(sharded, device=self.params[0].device)
        self.reduce = reduce

    def norms(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """Each gradient's L2 norm, a sliced one's over every slice."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self.reduce is None:
            return norms
        return torch.where(self.sharded, torch.sqrt(self.reduce(torch.where(self.sharded, norms * norms, 0.0))), norms)

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient, a zero one set where none was computed."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def __call__(self) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        del state


class GradParamNormalizer(GradOp):
    @torch.no_grad()
    def __call__(self) -> None:
        grads = self.grads()
        norms = self.norms(grads) if self.reduce is not None else [torch.linalg.vector_norm(g) for g in grads]
        for g, norm in zip(grads, norms):
            g.div_(torch.clamp_min(norm, EPS))


class GradZScoreNormalizer(GradOp):
    @torch.no_grad()
    def __call__(self) -> None:
        grads = self.grads()
        for i, g in enumerate(grads):
            if self.reduce is not None and bool(self.sharded[i]):
                total = self.reduce(torch.stack([g.sum(), (g * g).sum(), g.new_tensor(float(g.numel()))]))
                mean = total[0] / total[2]
                std = torch.sqrt(torch.clamp_min(total[1] / total[2] - mean * mean, 0.0))
            else:
                std, mean = torch.std_mean(g, correction=0)
            g.sub_(mean).div_(torch.clamp_min(std, EPS))


class GradValueClipper(GradOp):
    def __init__(self, named_params, max_value: float = 1.0) -> None:
        super().__init__(named_params)
        self.max_value = max_value

    @torch.no_grad()
    def __call__(self) -> None:
        for g in self.grads():
            g.clamp_(-self.max_value, self.max_value)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of every gradient element together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class GradNormClipper(GradOp):
    def __init__(self, named_params, max_norm: float = 1.0) -> None:
        super().__init__(named_params)
        self.max_norm = max_norm

    @torch.no_grad()
    def __call__(self) -> None:
        grads = self.grads()
        norm = global_norm(grads) if self.reduce is None else torch.linalg.vector_norm(self.norms(grads))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        torch._foreach_mul_(grads, scale)


def _threshold(criterion: str, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    if criterion == 'ZStat':
        return mean + 2.0 * torch.sqrt(torch.clamp_min(var, 0.0))
    return 1.5 * mean


class _History(GradOp):
    """Running mean and variance of gradient norms, ``norms`` of them a step."""

    def __init__(self, named_params, criterion: str, decay: float, n_norms: int) -> None:
        super().__init__(named_params)
        if criterion not in ('EMA', 'ZStat'):
            raise ValueError(f'unknown clip criterion {criterion!r}')
        self.criterion, self.decay = criterion, decay
        dev = self.params[0].device
        self.mean = torch.zeros(n_norms, device=dev)
        self.var = torch.zeros(n_norms, device=dev)
        self.seen = 0

    def clip(self, norms: torch.Tensor) -> torch.Tensor:
        """The scale of each norm this step, and the statistics folded."""
        first = self.seen == 0
        threshold = _threshold(self.criterion, self.mean, self.var)
        clip = (norms > threshold) & (threshold > 0) & (not first)
        scale = torch.where(clip, threshold / torch.clamp_min(norms, EPS), torch.ones_like(norms))
        eff = torch.where(clip, threshold, norms)
        if first:
            self.mean, self.var = norms.clone(), torch.zeros_like(norms)
        else:
            self.mean = self.decay * self.mean + (1 - self.decay) * eff
            self.var = self.decay * self.var + (1 - self.decay) * (eff - self.mean) ** 2
        self.seen += 1
        return scale

    def state_dict(self) -> dict:
        return {'mean': self.mean.clone(), 'var': self.var.clone(), 'seen': self.seen}

    def load_state_dict(self, state: dict) -> None:
        self.mean = state['mean'].to(self.mean.device)
        self.var = state['var'].to(self.var.device)
        self.seen = int(state['seen'])


class HistClipper(_History):
    """The global norm against the history of global norms."""

    def __init__(self, named_params, criterion: str = 'ZStat', decay: float = 0.9) -> None:
        super().__init__(named_params, criterion, decay, 1)

    @torch.no_grad()
    def __call__(self) -> None:
        grads = self.grads()
        norm = global_norm(grads) if self.reduce is None else torch.linalg.vector_norm(self.norms(grads))
        torch._foreach_mul_(grads, self.clip(norm.reshape(1))[0])


class ParamHistClipper(_History):
    """Every parameter's norm against the history of its own: one statistic
    per parameter tensor, as the port's parameters map one to one onto the
    flax leaves the JAX clipper walks."""

    def __init__(self, named_params, criterion: str = 'EMA', decay: float = 0.9) -> None:
        named_params = list(named_params)
        super().__init__(named_params, criterion, decay, len(named_params))

    @torch.no_grad()
    def __call__(self) -> None:
        grads = self.grads()
        scale = self.clip(self.norms(grads))
        for g, s in zip(grads, scale):
            g.mul_(s)

    def state(self) -> dict[str, tuple[float, float]]:
        """``name -> (mean, var)`` of the gradient norms, on the host."""
        return dict(zip(self.names, zip(self.mean.tolist(), self.var.tolist())))


REGISTRY = {
    'GradParamNormalizer': lambda params, criterion: GradParamNormalizer(params),
    'GradZScoreNormalizer': lambda params, criterion: GradZScoreNormalizer(params),
    'GradValueClipper': lambda params, criterion: GradValueClipper(params),
    'GradNormClipper': lambda params, criterion: GradNormClipper(params),
    'HistClipper': lambda params, criterion: HistClipper(params, criterion),
    'ParamHistClipper': lambda params, criterion: ParamHistClipper(params, criterion),
}


def get_grad_op(name: str | None, named_params, criterion: str = 'ZStat') -> GradOp | None:
    """The registry lookup (``grad_ops.py:150-166``): ``None`` is no
    operation; an unknown name raises."""
    if name is None:
        return None
    if name not in REGISTRY:
        raise ValueError(f'unknown gradient op {name!r}; expected one of {sorted(REGISTRY)}')
    return REGISTRY[name](named_params, criterion)
