"""Tensor-parallel training over a ``(dp, mp)`` grid (``pccf/train/tp.py``).

JAX runs the data-parallel step's jitted function on column-sharded
parameters and a ``dp``-sharded batch, and GSPMD places the collectives.  The
port's :class:`TPTrainer` is the :class:`~pccf_torch.train.runners.Trainer`
with the layout of :func:`~pccf_torch.dist.sharding.shard_params_tp` and the
collectives of :mod:`pccf_torch.dist.tp`:

- every parameter the rule shards keeps this rank's column slice, and its
  AdamW moments, built by the optimiser from the slice, are slices too:
  parameters and moments stay sharded between steps (``tp.py:10-12``);
- the batch is cut over the grid's ``dp`` column, the gradients averaged
  and the metrics reduced over it; the ``mp`` ranks of a row hold the same
  rows, draw the same noise from the same generator and take BatchNorm's
  statistics over the column (:class:`~pccf_torch.dist.mesh.Axis`);
- a sharded slice's gradient is this rank's slice of the one-device
  gradient (the gather's backward); a replicated parameter's is whole on
  every rank (every rank computes the whole layer from the gathered
  weights), so no gradient is averaged over ``mp``;
- the gradient operation sums the slices' squares over ``mp`` and counts a
  replicated gradient once (:meth:`~pccf_torch.train.grad_ops.GradOp.shard_over`);
- checkpoints hold the one-device layout: rank 0 writes the gathered
  weights, moments and clipper state in the one-device order, and every
  rank loads the file and takes its slices, so a TP checkpoint loads on one
  device and a one-device checkpoint loads under TP;
- a resume from weights alone sets the step, and with it the schedule and
  the optimiser's counts, from the restored epoch (``tp.py:171-210``).

:func:`tp_train_step` is JAX's one-shot probe: one TP step from the
trainer's weights, on a copy, the trainer left as it was.
"""

from __future__ import annotations

import copy

import torch
from torch.nn.utils import parametrize

from pccf_torch.dist import mesh, tp
from pccf_torch.dist.sharding import Grid, shard_params_tp
from pccf_torch.train.runners import Trainer, align_counts


class TPTrainer(Trainer):
    """A :class:`~pccf_torch.train.runners.Trainer` over a ``(dp, mp)`` grid
    with persistent column-sharded state.  ``model`` is sharded in place
    (:func:`~pccf_torch.dist.sharding.shard_params_tp` at ``min_size``)
    before the optimiser is built from its parameters.  Every rank of the
    grid builds one from the same weights."""

    def __init__(self, model: torch.nn.Module, objective, cfg, steps_per_epoch: int, grid: Grid, seed: int = 0,
                 name: str | None = None, min_size: int = 32) -> None:
        self.grid = grid
        self.order = [name for name, _ in model.named_parameters()]  # the one-device parameter order
        self.shards = shard_params_tp(model, grid, min_size=min_size)
        super().__init__(model, objective, cfg, steps_per_epoch, seed, name)
        if self.grad_op is not None:
            self.grad_op.shard_over([tp.one_device_name(n) in self.shards for n in self.grad_op.names],
                                    lambda t: tp.psum_mp(t, grid).detach())

    def data_axis(self) -> mesh.Axis:
        """The grid's ``dp`` column."""
        return mesh.Axis(self.grid.index('dp'), self.grid.dp, self.grid.group('dp'))

    def forward(self, inputs, noise):
        """The train-mode forward, each sharded weight gathered at most once."""
        with parametrize.cached():
            return self.model(inputs, noise, self.generator)

    def _one_device_order(self) -> list[int]:
        """Each trained parameter's index in this trainer's order, in the
        one-device order of the trained parameters."""
        names = [tp.one_device_name(n) for n in self.trained_names]
        return sorted(range(len(names)), key=lambda i: self.order.index(names[i]))

    def _shard(self, i: int):
        return self.shards.get(tp.one_device_name(self.trained_names[i]))

    def optimizer_state(self) -> dict:
        """The sidecar in the one-device layout: the moments of every sharded
        parameter gathered, parameters and clipper statistics in the
        one-device order (a collective: every rank calls it)."""
        state = self.optimizer.state_dict()
        order = self._one_device_order()
        moments = {}
        for j, i in enumerate(order):
            if i not in state['state']:
                continue
            shard = self._shard(i)
            moments[j] = {k: shard.full(v) if shard is not None and torch.is_tensor(v) and v.dim() else v
                          for k, v in state['state'][i].items()}
        groups = [dict(g, params=list(range(len(order)))) for g in state['param_groups']]
        grad_op = _permuted(self.grad_op.state_dict(), order) if self.grad_op is not None else {}
        return {'optimizer': {'state': moments, 'param_groups': groups}, 'step': self.step, 'grad_op': grad_op}

    def load_optimizer_state(self, state: dict) -> None:
        order = self._one_device_order()
        saved = state['optimizer']
        moments = {}
        for j, i in enumerate(order):
            if j not in saved['state']:
                continue
            shard = self._shard(i)
            moments[i] = {k: shard.take(v) if shard is not None and torch.is_tensor(v) and v.dim() else v
                          for k, v in saved['state'][j].items()}
        groups = [dict(g, params=list(range(len(order)))) for g in saved['param_groups']]
        self.optimizer.load_state_dict({'state': moments, 'param_groups': groups})
        if self.grad_op is not None:
            self.grad_op.load_state_dict(_permuted(state['grad_op'], torch.argsort(torch.tensor(order)).tolist()))
        self.step = int(state['step'])

    def weights_state(self) -> dict:
        """The one-device weights, gathered (a collective: every rank calls it)."""
        return tp.one_device_state(self.model)

    def load_weights(self, state: dict) -> None:
        """One-device weights, this rank taking its slices."""
        tp.load_one_device_state(self.model, state)


def _permuted(state: dict, perm: list[int]) -> dict:
    """A gradient operation's state with its per-parameter statistics
    (``ParamHistClipper``'s) taken in the order ``perm``."""
    state = dict(state)
    for key in ('mean', 'var'):
        if key in state and state[key].numel() == len(perm) > 1:
            state[key] = state[key][torch.tensor(perm, device=state[key].device)]
    return state


def tp_state(trainer: Trainer, grid: Grid, min_size: int = 32) -> TPTrainer:
    """A :class:`TPTrainer` on a copy of ``trainer``'s model (``tp.py:52-101``):
    column-sharded parameters, fresh moments built from the slices, the step
    of ``trainer``'s completed epochs with the optimiser's counts aligned to
    it, and ``trainer``'s generator state.  ``trainer`` is left as it was."""
    probe = TPTrainer(copy.deepcopy(trainer.model), trainer.objective, trainer.cfg, trainer.steps_per_epoch, grid,
                      name=trainer.name, min_size=min_size)
    probe.epoch = trainer.epoch
    probe.step = trainer.epoch * trainer.steps_per_epoch
    align_counts(probe.optimizer, probe.step)
    probe.generator.set_state(trainer.generator.get_state())
    return probe


def tp_train_step(trainer: Trainer, grid: Grid, inputs, targets, noise=None, epoch: float | None = None,
                  min_size: int = 32, return_state: bool = False):
    """ONE tensor-parallel step from ``trainer``'s weights (``tp.py:104-140``):
    the global batch in, the host metrics out, and with ``return_state`` the
    probe's :class:`TPTrainer` after the step.  A one-shot equivalence probe
    that shards a copy on every call; :class:`TPTrainer` trains."""
    probe = tp_state(trainer, grid, min_size)
    metrics = {k: float(v) for k, v in probe.run_step(inputs, targets, noise, epoch).items()}
    return (metrics, probe) if return_state else metrics
