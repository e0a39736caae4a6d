"""Post-epoch hooks (``pccf/train/hooks.py``): the every-n-epochs
combinator, the checkpoint cadence, early stopping and the codebook
maintenance that re-seeds VQ codebook entries no sample selects.

A hook is a callable taking the :class:`~pccf_torch.train.runners.Trainer`;
``trainer.post_epoch_hooks`` runs them after each epoch's validation, and
:class:`EarlyStoppingCallback` ends training by raising
:class:`~pccf_torch.train.runners.StopTraining`.  In a data-parallel run
rank 0 rewrites the codebook and broadcasts it, so every rank installs the
same book (``hooks.py:181-193``); early stopping reads the epoch rows, which
are equal on every rank, so every rank stops at the same epoch.
:class:`TensorBoardLogReconstruction` and
:class:`WandbLogReconstruction` (``hooks.py:229-288``) log the first samples
and, when called, their reconstructions as 3-D point sets to the current
run's TensorBoard or wandb tracker; built without that tracker they raise
:class:`~pccf_torch.train.trackers.TrackerNotUsedError`, without its
package ``ImportError``, and the stage skips them.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from pccf_torch.data.structures import Inputs
from pccf_torch.dist import mesh
from pccf_torch.train.objectives import Objective
from pccf_torch.train.runners import Diagnostic, StopTraining, Trainer

Hook = Callable[[Trainer], None]

DEAD_ENTRY = 1000.0  # where an entry no sample selects goes at the final epoch, out of every code's reach


def call_every(n: int) -> Callable[[Hook], Hook]:
    """Run the wrapped hook only after epochs that ``n`` divides."""

    def wrapper(fn: Hook) -> Hook:
        def wrapped(trainer: Trainer) -> None:
            if n and trainer.epoch % n == 0:
                fn(trainer)

        return wrapped

    return wrapper


def saving_hook(trainer: Trainer) -> None:
    """Save the trainer's checkpoint (``hooks.py:54``); registered under
    ``call_every(user.checkpoint_every)``."""
    trainer.save_checkpoint()


# ------------------------------------------------------------- metric filters


def get_trailing_mean(window: int) -> Callable[[list[float]], float]:
    """Mean of the last ``window`` values (``hooks.py:60-66``)."""

    def f(history: list[float]) -> float:
        return float(np.mean(history[-window:])) if history else float('inf')

    return f


def get_moving_average(alpha: float = 0.9) -> Callable[[list[float]], float]:
    """Exponential moving average over the history (``hooks.py:69-80``)."""

    def f(history: list[float]) -> float:
        if not history:
            return float('inf')
        ema = history[0]
        for v in history[1:]:
            ema = alpha * ema + (1 - alpha) * v
        return float(ema)

    return f


# ------------------------------------------------------------ early stopping


def resolve_monitored_value(metric: Objective, row: dict[str, float]) -> tuple[str, float | None]:
    """The value of ``metric`` in a logged metrics row (``hooks.py:86-105``).
    A composite criterion is named ``'Loss'``, as is the training loss in the
    row, so its loss expression is evaluated over the row's logged means of
    its leaves instead."""
    if metric.name != 'Loss' and metric.name in row:
        return metric.name, row[metric.name]
    if metric.loss_expr is not None:
        names = list(dict.fromkeys(metric.leaves))
        if names and all(name in row for name in names):
            return '+'.join(names), metric.evaluate(row)
    return metric.name, row.get(metric.name)


class EarlyStoppingCallback:
    """Stop when the smoothed validation metric stops improving
    (``hooks.py:108-152``): after every epoch the monitored value of the
    latest validation row (the training row without validation), negated
    where higher is better, joins the history; ``filter_fn`` of the history
    that does not beat the best by 1e-12 is a stale epoch, and ``patience``
    stale epochs in a row raise :class:`StopTraining`."""

    def __init__(self, metric: Objective, filter_fn: Callable[[list[float]], float] | None = None,
                 patience: int = 10, monitor: str | None = None) -> None:
        self.metric = metric
        self.monitor = monitor
        self.metric_name = monitor or metric.name
        self.higher_is_better = metric.higher_is_better.get(self.metric_name, False)
        self.filter_fn = filter_fn or (lambda h: h[-1])
        self.patience = patience
        self.best = float('inf')
        self.stale = 0
        self.history: list[float] = []

    def __call__(self, trainer: Trainer) -> None:
        log = trainer.validation_log or trainer.metrics_log
        if not log:
            return
        if self.monitor is not None:
            value = log[-1].get(self.monitor)
        else:
            self.metric_name, value = resolve_monitored_value(self.metric, log[-1])
        if value is None:
            return
        if self.higher_is_better:
            value = -value
        self.history.append(float(value))
        smoothed = self.filter_fn(self.history)
        if smoothed < self.best - 1e-12:
            self.best = smoothed
            self.stale = 0
        else:
            self.stale += 1
            if self.stale >= self.patience:
                raise StopTraining(f'early stop on {self.metric_name} after {self.stale} stale epochs')


# -------------------------------------------------------- codebook optimiser


def rewritten_codebook(codebook: np.ndarray, usage: np.ndarray, rng: np.random.Generator, vq_noise: float,
                       at_final: bool) -> np.ndarray | None:
    """The codebook ``(n_codes, book_size, dim)`` with every entry that
    ``usage (n_codes, book_size)`` never counts rewritten: to a copy of an
    entry of the same slot, drawn in proportion to its use, plus ``vq_noise``
    Gaussian noise, or to :data:`DEAD_ENTRY` at the final epoch; None when
    every entry is used.  The draws from ``rng`` come in JAX's order
    (``hooks.py:200-226``)."""
    unused = usage == 0
    if not unused.any():
        return None
    codebook = codebook.copy()
    for slot in range(codebook.shape[0]):
        total = usage[slot].sum()
        if total == 0:
            continue
        probs = usage[slot].astype(np.float64) / total
        for entry in np.flatnonzero(unused[slot]):
            if at_final:
                codebook[slot, entry] = DEAD_ENTRY
            else:
                template = codebook[slot, rng.choice(codebook.shape[1], p=probs)]
                noise = vq_noise * rng.standard_normal(codebook.shape[-1])
                codebook[slot, entry] = template + noise.astype(codebook.dtype)
    return codebook


class DiscreteSpaceOptimizer:
    """Codebook maintenance (``hooks.py:155-226``): a :class:`Diagnostic`
    pass over the training set counts how often each code slot selects each
    entry, and :func:`rewritten_codebook` re-seeds the entries no sample
    selects.  ``final_epoch`` is the last epoch training runs; the draws come
    from ``np.random.default_rng(seed)``.  In a data-parallel run rank 0
    alone rewrites, with its generator, and every rank installs rank 0's
    book (:func:`~pccf_torch.dist.mesh.broadcast_from_main`)."""

    def __init__(self, diagnostic: Diagnostic, vq_noise: float, final_epoch: int, seed: int = 0) -> None:
        self.diagnostic = diagnostic
        self.vq_noise = vq_noise
        self.final_epoch = final_epoch
        self.rng = np.random.default_rng(seed)
        self.last_usage: np.ndarray | None = None  # the counts of the latest pass, for the caller to inspect

    @torch.no_grad()
    def __call__(self, trainer: Trainer) -> None:
        self.diagnostic(trainer.epoch)
        self.last_usage = self.diagnostic.code_usage.round().to(torch.int64).cpu().numpy()
        codebook = trainer.model.codebook
        new = None
        if mesh.is_main_process():
            new = rewritten_codebook(codebook.detach().cpu().numpy(), self.last_usage, self.rng, self.vq_noise,
                                     trainer.epoch == self.final_epoch)
            new = None if new is None else torch.from_numpy(new).to(codebook.device)
        new = mesh.broadcast_from_main(new, codebook)
        if new is not None:
            codebook.copy_(new)


# ------------------------------------------------------- reconstruction logs

RECON_SEED = 7  # the decoder's sampling of the logged reconstructions (hooks.py:243's key)


def _first(dataset: Any, num: int) -> tuple[torch.Tensor, list[int | None]]:
    """The first ``num`` clouds of ``dataset`` and their labels (None for an
    unlabelled set), fetched as one inference batch: the clouds as stored,
    no augmentation drawn, so the training batches' draws are untouched; the
    dataset's switch is restored."""
    switch = getattr(dataset, 'set_inference', None)
    was = getattr(dataset, 'inference', True)
    if switch is not None:
        switch(True)
    try:
        inputs, targets = dataset.__getitems__(list(range(num)))
    finally:
        if switch is not None:
            switch(was)
    labels = [None] * num if targets.label is None else [int(v) for v in targets.label.cpu()]
    return inputs.cloud, labels


@torch.no_grad()
def _reconstruct(trainer: Trainer, dataset: Any, num: int) -> np.ndarray:
    """The eval reconstructions of the first ``num`` samples of ``dataset``,
    on the host (``hooks.py:232-243``); the decoder's sampling from a
    generator seeded with :data:`RECON_SEED`, so every epoch draws the
    same."""
    model = trainer.model
    cloud, _ = _first(dataset, num)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        outputs = model(Inputs(cloud=cloud.to(device)), None, torch.Generator(device=device).manual_seed(RECON_SEED))
    finally:
        model.train(was_training)
    return outputs.recon.float().cpu().numpy()


class TensorBoardLogReconstruction:
    """Log sample reconstructions as 3-D meshes (``hooks.py:246-265``): the
    first ``num_samples`` clouds of ``dataset`` once, their reconstructions
    at every call, at the completed epoch."""

    def __init__(self, dataset: Any, num_samples: int = 1) -> None:
        from pccf_torch.train.trackers import TensorBoardTracker

        self._dataset = dataset
        self._num = num_samples
        self.writer = TensorBoardTracker.require_current().writer
        clouds, labels = _first(dataset, num_samples)
        for i, (cloud, label) in enumerate(zip(clouds.cpu().numpy(), labels)):
            self.writer.add_mesh(f'Sample {i} with label: {label}', vertices=cloud[None], global_step=0)

    def __call__(self, trainer: Trainer) -> None:
        for i, recon in enumerate(_reconstruct(trainer, self._dataset, self._num)):
            self.writer.add_mesh(f'Recon {i}', vertices=recon[None], global_step=trainer.epoch)


class WandbLogReconstruction:
    """The wandb variant (``hooks.py:268-288``); needs the wandb tracker."""

    def __init__(self, dataset: Any, num_samples: int = 1) -> None:
        import wandb

        from pccf_torch.train.trackers import WandbTracker

        self._wandb = wandb
        self._dataset = dataset
        self._num = num_samples
        self.run = WandbTracker.require_current().run
        clouds, labels = _first(dataset, num_samples)
        for i, (cloud, label) in enumerate(zip(clouds.cpu().numpy(), labels)):
            self.run.log({f'Sample {i} with label: {label}': wandb.Object3D(cloud)})

    def __call__(self, trainer: Trainer) -> None:
        for i, recon in enumerate(_reconstruct(trainer, self._dataset, self._num)):
            self.run.log({f'Recon {i}': self._wandb.Object3D(recon)})
