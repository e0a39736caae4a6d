"""Post-epoch hooks of stage-1 training (``pccf/train/hooks.py:41-51,
155-226``): the every-n-epochs combinator and the codebook maintenance that
re-seeds VQ codebook entries no sample selects.

A hook is a callable taking the :class:`~pccf_torch.train.runners.Trainer`;
``trainer.post_epoch_hooks`` runs them after each epoch's validation.  The
port trains in one process, so one process rewrites the codebook; the
broadcast of the rewritten codebook across processes (``hooks.py:181-193``)
comes with data-parallel training.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pccf_torch.train.runners import Diagnostic, Trainer

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
    from ``np.random.default_rng(seed)``."""

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
        new = rewritten_codebook(codebook.detach().cpu().numpy(), self.last_usage, self.rng, self.vq_noise,
                                 trainer.epoch == self.final_epoch)
        if new is not None:
            codebook.copy_(torch.from_numpy(new))
