"""Training and evaluation runners (``pccf/train/runners.py``).

:class:`Trainer` holds a model, its objective, the configured gradient
operation and the optimiser its configuration names
(``pccf/config/specs.py:70-92``): AdamW for both autoencoders, set as
``optax.adamw(lr, weight_decay)`` is (betas 0.9 / 0.999, eps 1e-8, decoupled
decay on every trained parameter), SGD for the classifier (the weight decay
added to the gradient, then momentum, as ``optax.chain(add_decayed_weights,
sgd)``), and Adam or RMSprop where ``optimizer_name`` asks for them (the
decay added to the gradient, then optax's rules).  A step runs the model in
train mode, injects the 1-based epoch into ``Outputs.model_epoch``
(``runners.py:69-73, 303``), backpropagates,
applies the gradient operation (stage 2's per-parameter history clipper),
then the optimiser at ``base_lr · schedule(step // steps_per_epoch)``, the
0-based epoch (``runners.py:226-229``).  The VQ-VAE's embedded inner CVAE is frozen
in stage 1: it is left out of the optimiser, so neither updates nor weight
decay touch it (``runners.py:245-256``, ``train_autoencoder.py:68``).  Stage 2
trains a :class:`~pccf_torch.models.w_autoencoders.WAETrainModule`, whose
codebook is a buffer and so is never optimised.

A step's noise comes from the trainer's ``torch.Generator`` on the model's
device unless the caller passes it: the model is called as ``model(inputs,
noise, generator)`` and draws what is missing (stage 1 the decoder's
``initial_sampling`` and the attention's Gumbel noise, stage 2 the
posterior's Gaussian noise and its dropout masks, the classifier its
dropout masks).  A model that returns ``Outputs`` gets the epoch in
``model_epoch``; other outputs (the classifier's logits) pass as they are.

:class:`Test` is the evaluation pass (``runners.py:69-150``): the model in
eval mode over every batch, metrics averaged with the batch sizes as weights;
``store_outputs=True`` keeps each batch's output tensor (the classifier's
logits), moved to the host, in ``outputs_list``.
:class:`Diagnostic` is the same pass over the training set for the codebook
hook (``runners.py:151-156``).  After every epoch's validation, the trainer
runs its ``post_epoch_hooks``; a hook that raises :class:`StopTraining` (early
stopping) ends training after that epoch.  :class:`Loader` batches a dataset
held by the main process for the entry points.

Every epoch's training row and every pass's metrics go to the current
experiment's trackers under the model's name (``runners.py:127-137``).
:meth:`Trainer.save_checkpoint` and :meth:`Trainer.load_checkpoint` write
and read the model's checkpoint with its sidecar
(:mod:`pccf_torch.train.checkpoint`), so a resumed run continues as the
uninterrupted one would.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import math
import multiprocessing
import time
from typing import Callable, Iterator

import numpy as np
import torch

from pccf_torch.data.structures import Outputs
from pccf_torch.train.checkpoint import Checkpoint
from pccf_torch.train.grad_ops import get_grad_op
from pccf_torch.train.objectives import Objective
from pccf_torch.train.schedulers import get_scheduler
from pccf_torch.train.trackers import dispatch_metrics

FROZEN = 'w_autoencoder'  # the submodule stage 1 does not train


class ConvergenceError(RuntimeError):
    """The epoch's loss is not finite (``runners.py:49``)."""


class StopTraining(Exception):
    """Raised by a post-epoch hook (early stopping) to end training."""


# One dataset copy lives in each loader worker process, shipped once through
# the pool's initializer; a task carries an index list and the generator's
# seed.  Workers build host arrays only and never touch the card.
_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(task: tuple[list[int], tuple[int, ...]]) -> dict:
    idx_list, rng_key = task
    ds = _WORKER_DATASET
    if hasattr(ds, 'rng'):
        ds.rng = np.random.default_rng(rng_key)
    ds.set_inference(False)
    return ds.host_batch(idx_list)


class Loader:
    """Batches of a dataset (``pccf/train/loader.py:58-200``): training
    epochs shuffled by ``(seed, epoch)`` with the trailing partial batch
    dropped, evaluation in order with it kept.  The dataset has a length and
    ``__getitems__(indices) -> (inputs, targets)``; as the JAX loader does,
    it is told whether a batch is for inference (``set_inference``) and,
    where it augments with a numpy generator ``rng``, that generator is
    seeded anew by ``(seed, epoch, batch)`` before each training batch.

    With ``n_workers`` > 0 and a dataset that ``supports_workers``,
    training batches are built in that many ``spawn`` worker processes
    (``loader.py:19-44, 173-190``), each with its own copy of the dataset:
    a worker runs the dataset's ``host_batch`` under the same reseed, the
    main process its ``upload``, so the batches are bit-equal for any
    ``n_workers``; at most ``PREFETCH + n_workers`` batches are in flight.
    The pool starts at the first epoch, once the kernel library (the
    compiled batch assembler) is built, and :meth:`close` ends it.
    Evaluation batches are built in the main process."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, seed: int = 0, n_workers: int = 0) -> None:
        self.dataset, self.batch_size, self.seed = dataset, batch_size, seed
        self.n_workers = n_workers if getattr(dataset, 'supports_workers', False) else 0
        self._pool = None

    def n_batches(self) -> int:
        """Training batches per epoch."""
        full = len(self.dataset) // self.batch_size
        if full == 0:
            raise ValueError(f'{len(self.dataset)} samples yield no training batch of {self.batch_size}')
        return full

    def epoch_iterator(self, epoch: int) -> Iterator[tuple]:
        order = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, epoch)).shuffle(order)
        self._set_inference(False)
        batches = [order[b * self.batch_size: (b + 1) * self.batch_size].tolist() for b in range(self.n_batches())]
        if self.n_workers:
            yield from self._from_workers(epoch, batches)
            return
        for b, idx in enumerate(batches):
            if hasattr(self.dataset, 'rng'):
                self.dataset.rng = np.random.default_rng((self.seed, epoch, b))
            yield self.dataset.__getitems__(idx)

    def _from_workers(self, epoch: int, batches: list[list[int]]) -> Iterator[tuple]:
        pool = self._executor()
        pending: collections.deque = collections.deque()
        for b, idx in enumerate(batches):
            pending.append(pool.submit(_worker_fetch, (idx, (self.seed, epoch, b))))
            if len(pending) >= self.PREFETCH + self.n_workers:
                yield self.dataset.upload(pending.popleft().result())
        while pending:
            yield self.dataset.upload(pending.popleft().result())

    def _executor(self) -> concurrent.futures.ProcessPoolExecutor:
        if self._pool is None:
            if getattr(self.dataset, 'device', torch.device('cpu')).type == 'cuda':
                from pccf_torch.kernels import _build

                _build.lib()  # the workers load the library the main process built
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.n_workers, mp_context=multiprocessing.get_context('spawn'),
                initializer=_worker_init, initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        """End the worker processes, if any started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def batches(self) -> Iterator[tuple]:
        n = len(self.dataset)
        self._set_inference(True)
        for start in range(0, n, self.batch_size):
            yield self.dataset.__getitems__(list(range(start, min(start + self.batch_size, n))))

    def _set_inference(self, inference: bool) -> None:
        if hasattr(self.dataset, 'set_inference'):
            self.dataset.set_inference(inference)


class Trainer:
    """One optimisation step at a time, or whole epochs, of a model.

    ``cfg`` is the stage's train configuration
    (:class:`~pccf_torch.config.AutoEncoderTrainConfig`,
    :class:`~pccf_torch.config.WAutoEncoderTrainConfig` or
    :class:`~pccf_torch.config.ClassifierTrainConfig`).  The trainer's
    objective starts with an empty running state.  ``name`` is the model's,
    which names its checkpoints and its rows in the trackers."""

    def __init__(self, model: torch.nn.Module, objective: Objective, cfg, steps_per_epoch: int, seed: int = 0,
                 name: str | None = None) -> None:
        self.model = model
        self.name = name or type(model).__name__
        self.checkpoint = Checkpoint(self.name)
        self.objective = objective.copy()
        self.objective.reset_state()
        self.base_lr = cfg.learning_rate
        self.schedule = get_scheduler(cfg.scheduler)
        self.steps_per_epoch = steps_per_epoch
        trained = []
        for name, p in model.named_parameters():
            if name.split('.')[0] == FROZEN:
                p.requires_grad_(False)
            else:
                trained.append((name, p))
        self.optimizer = make_optimizer(cfg, [p for _, p in trained], self.lr_at(0))
        self.grad_op = get_grad_op(cfg.grad_op, trained, cfg.clip_criterion)
        self.step = 0
        self.epoch = 0  # completed epochs
        self.generator = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
        self.metrics_log: list[dict[str, float]] = []
        self.validation_log: list[dict[str, float]] = []
        self.epoch_seconds: list[float] = []  # host seconds of each epoch's steps, metrics read
        self.post_epoch_hooks: list[Callable[['Trainer'], None]] = []

    def lr_at(self, step: int) -> float:
        return self.base_lr * self.schedule(step // self.steps_per_epoch)

    def run_step(self, inputs, targets, noise=None, epoch: float | None = None) -> dict[str, torch.Tensor]:
        """One step: forward in train mode, loss, backward, gradient
        operation, optimiser.  ``epoch`` (1-based) defaults to the one after the
        completed epochs, as ``runners.py:357-358``.  Returns the batch-mean
        metrics (device tensors: reading them waits for the step)."""
        self.model.train()
        for group in self.optimizer.param_groups:
            group['lr'] = self.lr_at(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        epoch = float(self.epoch + 1 if epoch is None else epoch)
        outputs = with_epoch(self.model(inputs, noise, self.generator), epoch)
        loss, metrics = self.objective.loss_and_metrics(outputs, targets)
        loss.backward()
        if self.grad_op is not None:
            self.grad_op()
        self.optimizer.step()
        self.step += 1
        return {name: v.detach() for name, v in metrics.items()}

    def train_until(self, loader: Loader, n_epochs: int, validation: 'Test | None' = None) -> None:
        """Train from the completed epochs up to ``n_epochs``
        (``runners.py:364-423``): per epoch the mean of the step metrics and
        the lr applied, a non-finite loss raises, then the validation pass
        and the post-epoch hooks, in registration order; a hook's
        :class:`StopTraining` ends training there."""
        for epoch in range(self.epoch + 1, n_epochs + 1):
            t0 = time.perf_counter()
            self.objective.reset_state()
            step_metrics = [self.run_step(inputs, targets, epoch=epoch) for inputs, targets in loader.epoch_iterator(epoch)]
            for metrics in step_metrics:
                self.objective.update_state(metrics, 1)
            self.epoch = epoch
            epoch_metrics = self.objective.compute_metrics()
            epoch_metrics['lr'] = self.base_lr * self.schedule(epoch - 1)
            self.epoch_seconds.append(time.perf_counter() - t0)
            self.metrics_log.append(epoch_metrics)
            if not math.isfinite(epoch_metrics.get(self.objective.name, 0.0)):
                raise ConvergenceError(f'{self.objective.name} diverged: {epoch_metrics[self.objective.name]}')
            dispatch_metrics(self.name, 'Train', epoch, {**epoch_metrics, 'epoch_time_s': self.epoch_seconds[-1]})
            if validation is not None:
                self.validation_log.append(validation(epoch))
            try:
                for hook in self.post_epoch_hooks:
                    hook(self)
            except StopTraining:
                break

    def save_checkpoint(self) -> None:
        """The model at the completed epoch, and the sidecar with the
        optimiser's and gradient operation's state, the step and the
        generator (``runners.py:441-453``)."""
        self.checkpoint.save(self.model, self.epoch)
        torch.save({'optimizer': self.optimizer.state_dict(), 'step': self.step,
                    'grad_op': self.grad_op.state_dict() if self.grad_op is not None else {},
                    'generator': self.generator.get_state()}, self.checkpoint.sidecar(self.epoch))

    def load_checkpoint(self, checkpoint: int = -1) -> None:
        """The model's weights of ``checkpoint`` (-1 the latest) and, where
        its sidecar exists, the rest of the state; without it the step
        follows the epoch and the optimiser and gradient operation start
        afresh (``runners.py:455-488``)."""
        self.epoch = self.checkpoint.load(self.model, checkpoint)
        sidecar = self.checkpoint.sidecar(self.epoch)
        if not sidecar.exists():
            self.step = self.epoch * self.steps_per_epoch
            return
        state = torch.load(sidecar, map_location='cpu', weights_only=False)
        self.optimizer.load_state_dict(state['optimizer'])
        if self.grad_op is not None:
            self.grad_op.load_state_dict(state['grad_op'])
        self.step = int(state['step'])
        self.generator.set_state(state['generator'])


class Test:
    """An evaluation pass with averaged metrics (``runners.py:69-150``).  The
    model samples in eval too; its noise comes from a generator seeded anew
    for every pass (``seed + 17``), so two passes over the same weights
    agree.  The objective starts with an empty running state."""

    def __init__(self, model: torch.nn.Module, loader: Loader, objective: Objective, name: str = 'Test',
                 seed: int = 0, model_name: str | None = None) -> None:
        self.model, self.loader, self.name = model, loader, name
        self.model_name = model_name or type(model).__name__
        self.objective = objective.copy()
        self.objective.reset_state()
        self.seed = seed + 17
        self.outputs_list: list = []

    @torch.no_grad()
    def __call__(self, epoch: int = 0, store_outputs: bool = False) -> dict[str, float]:
        """Metrics over the loader's batches, with ``epoch`` (the completed
        epochs) as ``Outputs.model_epoch``; with ``store_outputs`` each
        batch's output tensor, on the host, in ``outputs_list``."""
        self.model.eval()
        self.objective.reset_state()
        self.outputs_list = []
        device = next(self.model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(self.seed)
        pending = []
        for inputs, targets in self.loader.batches():
            outputs = with_epoch(self.model(inputs, None, generator), float(epoch))
            self._observe(outputs)
            pending.append((self.objective.loss_and_metrics(outputs, targets)[1], _batch_size(inputs)))
            if store_outputs:
                self.outputs_list.append(outputs.cpu())
        for metrics, count in pending:  # read to the host once the pass is enqueued
            self.objective.update_state(metrics, count)
        results = self.objective.compute_metrics()
        dispatch_metrics(self.model_name, self.name, epoch, results)
        return results

    def _observe(self, outputs) -> None:
        """What a subclass keeps of each batch's outputs; a test keeps none."""


class Diagnostic(Test):
    """An evaluation pass over the training set that keeps, of its outputs,
    what the codebook hook reads: how often each code slot selected each
    codebook entry, ``code_usage (n_codes, book_size)``, summed on the
    device (``runners.py:151-156``, ``hooks.py:203-205``)."""

    def __init__(self, model: torch.nn.Module, loader: Loader, objective: Objective, seed: int = 0,
                 model_name: str | None = None) -> None:
        super().__init__(model, loader, objective, 'Diagnostic', seed, model_name)
        self.code_usage: torch.Tensor | None = None

    def __call__(self, epoch: int = 0) -> dict[str, float]:
        self.code_usage = None
        return super().__call__(epoch)

    def _observe(self, outputs) -> None:
        usage = outputs.one_hot_idx.sum(dim=0)
        self.code_usage = usage if self.code_usage is None else self.code_usage + usage


class RMSprop(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(weight_decay), rmsprop(lr, ...))``
    (``pccf/config/specs.py:86-89``, optax 0.2.6), which
    ``torch.optim.RMSprop`` does not compute (its decay 0.99 and eps outside
    the root): ``g += weight_decay * p``; ``nu = (1 - decay) g² + decay nu``
    from ``initial_scale`` (``mu`` likewise from 0 where ``centered``);
    both divided by ``1 - decay^t`` where ``bias_correction``; the update
    ``-lr g / sqrt(nu - mu² + eps)`` (``/ (sqrt(nu - mu²) + eps)`` unless
    ``eps_in_sqrt``), then optax's ``trace`` where ``momentum`` is set:
    ``t = u + momentum t``, the update ``t`` (``u + momentum t`` with
    ``nesterov``).  The trace sums updates already scaled by the lr."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: float | None = None, nesterov: bool = False, bias_correction: bool = False) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, decay=decay, eps=eps,
                                      initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt, centered=centered,
                                      momentum=momentum, nesterov=nesterov, bias_correction=bias_correction))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps, momentum = group['decay'], group['eps'], group['momentum']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad + group['weight_decay'] * p if group['weight_decay'] else p.grad
                state = self.state[p]
                if not state:
                    state['count'] = 0
                    state['nu'] = torch.full_like(p, group['initial_scale'])
                    if group['centered']:
                        state['mu'] = torch.zeros_like(p)
                    if momentum is not None:
                        state['trace'] = torch.zeros_like(p)
                state['count'] += 1
                nu = state['nu'].mul_(decay).add_((1 - decay) * (g * g))
                mu = state['mu'].mul_(decay).add_((1 - decay) * g) if group['centered'] else None
                if group['bias_correction']:
                    correction = 1 - decay ** state['count']
                    nu = nu / correction
                    mu = None if mu is None else mu / correction
                var = nu if mu is None else nu - mu * mu
                scaled = g * torch.rsqrt(var + eps) if group['eps_in_sqrt'] else g / (torch.sqrt(var) + eps)
                update = -group['lr'] * scaled
                if momentum is not None:
                    trace = state['trace'].mul_(momentum).add_(update)
                    update = update + momentum * trace if group['nesterov'] else trace
                p.add_(update)


def make_optimizer(cfg, params: list[torch.nn.Parameter], lr: float) -> torch.optim.Optimizer:
    """The optimiser ``cfg.optimizer_name`` names, as ``pccf/config/specs.py``
    ``get_optimizer`` builds it: AdamW with decoupled decay; SGD with the
    decay added to the gradient and optional momentum (no dampening); Adam
    with the decay added to the gradient (``torch.optim.Adam``'s
    ``weight_decay``, optax's ``b1``, ``b2`` and ``eps``); :class:`RMSprop`."""
    settings = dict(cfg.opt_settings)
    if cfg.optimizer_name == 'AdamW':
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer_name == 'SGD':
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.optimizer_name == 'Adam':
        return torch.optim.Adam(params, lr=lr, betas=(float(settings.get('b1', 0.9)), float(settings.get('b2', 0.999))),
                                eps=float(settings.get('eps', 1e-8)), weight_decay=cfg.weight_decay)
    if cfg.optimizer_name == 'RMSprop':
        return RMSprop(params, lr=lr, weight_decay=cfg.weight_decay, **settings)
    raise ValueError(f'optimizer {cfg.optimizer_name!r} is not one of AdamW, SGD, Adam, RMSprop')


def with_epoch(outputs, epoch: float):
    """``outputs`` with ``model_epoch`` set where they are ``Outputs``
    (``runners.py:69-73``); logits pass as they are."""
    return outputs.replace(model_epoch=epoch) if isinstance(outputs, Outputs) else outputs


def _batch_size(inputs) -> int:
    """The samples in a batch, read from its first field as JAX reads the
    first leaf of its inputs (``runners.py:108``)."""
    return getattr(inputs, dataclasses.fields(inputs)[0].name).shape[0]
