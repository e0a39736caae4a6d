"""The loss algebra of the training objectives (``pccf/train/objectives.py``).

``Loss(fn, name)`` wraps a per-sample calculation ``fn(outputs, targets) ->
(B,)``; ``a + b`` sums losses, ``c * a`` scales one by a number and ``a * b``
multiplies two (the KLD annealing), ``a | m`` attaches the calculations of
``m`` as metrics that are reported but not optimised; ``Metric`` is such a
calculation on its own.  :meth:`Objective.loss_and_metrics` returns the batch
mean of the loss expression and the batch mean of every named calculation.
A metric whose value is not a mean over the samples (the macro accuracy)
also gives its additive sums and the value from them, ``pooled``, so that a
data-parallel step computes it over the global batch
(:func:`pccf_torch.dist.mesh.reduce_metrics`).
An objective also keeps a running state of batch means weighted by batch
size (``update_state`` / ``compute_metrics``), as the evaluation runners
aggregate it; :meth:`Objective.copy` keeps that state and
:meth:`Objective.merge_state` adds another objective's to it, as the
evaluation suites merge their per-target tests
(``evaluate_counterfactuals.py:79-81``).  ``higher_is_better`` says, per
metric name, which direction is better (``Metric(..., higher_is_better=True)``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

CalcFn = Callable[[Any, Any], torch.Tensor]
PooledFn = tuple[CalcFn, Callable[[torch.Tensor], torch.Tensor]]  # (outputs, targets) -> sums; sums -> value
LossExpr = Callable[[dict[str, torch.Tensor]], torch.Tensor]  # per-sample values -> (B,)


class Objective:
    """Named per-sample calculations and one loss expression over them
    (``None`` for a metric-only objective)."""

    def __init__(self, calculations: dict[str, CalcFn], loss_expr: LossExpr | None, name: str,
                 leaves: tuple[str, ...] = ()) -> None:
        self.calculations = dict(calculations)
        self.loss_expr = loss_expr
        self.name = name
        self.leaves = leaves  # the calculations the loss expression reads, in order
        self._state: dict[str, tuple[float, float]] = {}  # name -> (weighted sum, count)
        self.higher_is_better: dict[str, bool] = {}
        self.pooled: dict[str, PooledFn] = {}  # a batch-level metric's additive sums and its value from them

    def compute_all(self, outputs: Any, targets: Any) -> dict[str, torch.Tensor]:
        return {name: fn(outputs, targets) for name, fn in self.calculations.items()}

    def loss_and_metrics(self, outputs: Any, targets: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        values = self.compute_all(outputs, targets)
        metrics = {name: torch.mean(v) for name, v in values.items()}
        if self.loss_expr is None:
            return torch.zeros(()), metrics
        loss = torch.mean(self.loss_expr(values))
        metrics[self.name] = loss
        return loss, metrics

    # ---------------------------------------------------------- aggregation
    def update_state(self, metrics: dict[str, Any], count: int = 1) -> None:
        """Fold batch-mean metrics of a batch of ``count`` samples into the
        running state (reads each value to the host)."""
        for name, value in metrics.items():
            s, c = self._state.get(name, (0.0, 0.0))
            self._state[name] = (s + float(value) * count, c + count)

    def reset_state(self) -> None:
        self._state = {}

    def compute_metrics(self) -> dict[str, float]:
        """Means since the last reset, weighted by batch size."""
        return {name: s / max(c, 1e-12) for name, (s, c) in self._state.items()}

    def merge_state(self, other: 'Objective') -> None:
        """Add ``other``'s running state to this one's (sums and counts)."""
        for name, (s, c) in other._state.items():
            s0, c0 = self._state.get(name, (0.0, 0.0))
            self._state[name] = (s0 + s, c0 + c)

    def copy(self) -> 'Objective':
        """The same calculations with a copy of the running state."""
        new = _objective(self.calculations, self.loss_expr, self.name, self.higher_is_better, self.leaves,
                         self.pooled)
        new._state = dict(self._state)
        return new

    def evaluate(self, row: dict[str, float]) -> float:
        """The loss expression over logged means ``row`` of its leaves."""
        return float(self._expr()({name: torch.tensor(row[name], dtype=torch.float64) for name in self.leaves}))

    # -------------------------------------------------------------- algebra
    @staticmethod
    def _merge(a: dict, b: dict) -> dict:
        for name in a.keys() & b.keys():
            if a[name] is not b[name]:
                raise ValueError(f'objective name collision: {name!r} is bound to two different calculations')
        return {**a, **b}

    def _expr(self) -> LossExpr:
        if self.loss_expr is None:
            raise ValueError(f'{self.name} is metric-only; it cannot join a loss')
        return self.loss_expr

    def _join(self, other: 'Objective', loss_expr: LossExpr | None, name: str,
              leaves: tuple[str, ...]) -> 'Objective':
        return _objective(self._merge(self.calculations, other.calculations), loss_expr, name,
                          {**self.higher_is_better, **other.higher_is_better}, leaves,
                          {**self.pooled, **other.pooled})

    def __add__(self, other: 'Objective') -> 'Objective':
        ea, eb = self._expr(), other._expr()
        return self._join(other, lambda v: ea(v) + eb(v), 'Loss', self.leaves + other.leaves)

    def __mul__(self, other: 'Objective | float') -> 'Objective':
        ea = self._expr()
        if isinstance(other, Objective):
            eb = other._expr()
            return self._join(other, lambda v: ea(v) * eb(v), 'Loss', self.leaves + other.leaves)
        s = float(other)
        return _objective(self.calculations, lambda v: s * ea(v), self.name, self.higher_is_better, self.leaves,
                          self.pooled)

    __rmul__ = __mul__

    def __or__(self, metric: 'Objective') -> 'Objective':
        return self._join(metric, self.loss_expr, self.name, self.leaves)


def _objective(calculations: dict[str, CalcFn], loss_expr: LossExpr | None, name: str,
               higher_is_better: dict[str, bool], leaves: tuple[str, ...],
               pooled: dict[str, PooledFn] | None = None) -> Objective:
    """A new objective with an empty running state."""
    new = Objective(calculations, loss_expr, name, leaves)
    new.higher_is_better = dict(higher_is_better)
    new.pooled = dict(pooled or {})
    return new


class Loss(Objective):
    """A named, optimised per-sample term."""

    def __init__(self, fn: CalcFn, name: str) -> None:
        super().__init__({name: fn}, lambda v: v[name], name, (name,))


class Metric(Objective):
    """A named per-sample calculation that is reported, never optimised;
    ``pooled`` for a batch-level value (see :attr:`Objective.pooled`)."""

    def __init__(self, fn: CalcFn, name: str, higher_is_better: bool = False, pooled: PooledFn | None = None) -> None:
        super().__init__({name: fn}, None, name)
        self.higher_is_better = {name: higher_is_better}
        self.pooled = {name: pooled} if pooled is not None else {}


def compute_metrics(objective: Objective) -> dict[str, float]:
    """The running means of ``objective`` (``pccf/train/objectives.py:187``)."""
    return objective.compute_metrics()
