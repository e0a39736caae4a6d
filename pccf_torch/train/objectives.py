"""The loss algebra the stage-1 objective uses (``pccf/train/objectives.py``).

``Loss(fn, name)`` wraps a per-sample calculation ``fn(outputs, targets) ->
(B,)``; ``a + b`` sums losses, ``c * a`` scales one by a number, ``a | m``
attaches the calculations of ``m`` as metrics that are reported but not
optimised.  :meth:`Objective.loss_and_metrics` returns the batch mean of the
loss expression and the batch mean of every named calculation.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

CalcFn = Callable[[Any, Any], torch.Tensor]
LossExpr = Callable[[dict[str, torch.Tensor]], torch.Tensor]  # per-sample values -> (B,)


class Objective:
    """Named per-sample calculations and one loss expression over them."""

    def __init__(self, calculations: dict[str, CalcFn], loss_expr: LossExpr, name: str) -> None:
        self.calculations = dict(calculations)
        self.loss_expr = loss_expr
        self.name = name

    def compute_all(self, outputs: Any, targets: Any) -> dict[str, torch.Tensor]:
        return {name: fn(outputs, targets) for name, fn in self.calculations.items()}

    def loss_and_metrics(self, outputs: Any, targets: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        values = self.compute_all(outputs, targets)
        metrics = {name: torch.mean(v) for name, v in values.items()}
        loss = torch.mean(self.loss_expr(values))
        metrics[self.name] = loss
        return loss, metrics

    @staticmethod
    def _merge(a: dict, b: dict) -> dict:
        for name in a.keys() & b.keys():
            if a[name] is not b[name]:
                raise ValueError(f'objective name collision: {name!r} is bound to two different calculations')
        return {**a, **b}

    def __add__(self, other: 'Objective') -> 'Objective':
        ea, eb = self.loss_expr, other.loss_expr
        return Objective(self._merge(self.calculations, other.calculations), lambda v: ea(v) + eb(v), 'Loss')

    def __mul__(self, scale: float) -> 'Objective':
        ea, s = self.loss_expr, float(scale)
        return Objective(self.calculations, lambda v: s * ea(v), self.name)

    __rmul__ = __mul__

    def __or__(self, metric: 'Objective') -> 'Objective':
        return Objective(self._merge(self.calculations, metric.calculations), self.loss_expr, self.name)


class Loss(Objective):
    """A named, optimised per-sample term."""

    def __init__(self, fn: CalcFn, name: str) -> None:
        super().__init__({name: fn}, lambda v: v[name], name)
