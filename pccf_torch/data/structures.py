"""Typed batch structures (``pccf/data/structures.py``) as dataclasses."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Inputs:
    """Input of the outer autoencoder / classifier.

    Attributes:
        cloud: ``(B, N, 3)`` input cloud.
        indices: optional precomputed kNN indices ``(B, N, k)``.
        initial_sampling: optional fixed decoder sampling ``(B, n_out, sample_dim)``.
    """

    cloud: torch.Tensor
    indices: torch.Tensor | None = None
    initial_sampling: torch.Tensor | None = None


@dataclasses.dataclass
class Targets:
    """Targets of the outer autoencoder, the reference cloud ``(B, M, 3)``,
    and of the classifier, the class labels ``(B,)`` int64 (``pccf`` also
    carries the scale, which no ported path reads)."""

    ref_cloud: torch.Tensor
    label: torch.Tensor | None = None


@dataclasses.dataclass
class WInputs:
    """Inputs of the inner (W) autoencoder."""

    w_q: torch.Tensor
    logits: torch.Tensor | None = None


@dataclasses.dataclass
class WTargets:
    """Targets of the inner (W) autoencoder: the quantised code embeddings
    ``(B, w_dim)``, their one-hot selections ``(B, n_codes, book_size)`` and
    the classifier logits ``(B, C)``."""

    w_e: torch.Tensor
    one_hot_idx: torch.Tensor
    logits: torch.Tensor | None = None


@dataclasses.dataclass
class Outputs:
    """Outputs of the inner and outer autoencoder, filled along the path
    (the fields the serving and training paths set; ``pccf`` has more).
    ``model_epoch`` is the 1-based epoch a training step injects (0-based
    in evaluation), which the KLD annealing reads."""

    model_epoch: float | None = None
    recon: torch.Tensor | None = None
    w: torch.Tensor | None = None
    w_q: torch.Tensor | None = None
    w_e: torch.Tensor | None = None
    w_recon: torch.Tensor | None = None
    w_dist_2: torch.Tensor | None = None
    idx: torch.Tensor | None = None
    one_hot_idx: torch.Tensor | None = None
    z1: torch.Tensor | None = None
    z2: torch.Tensor | None = None
    mu1: torch.Tensor | None = None
    log_var1: torch.Tensor | None = None
    pseudo_mu1: torch.Tensor | None = None  # the VampPrior's pseudo-inputs' z1 statistics
    pseudo_log_var1: torch.Tensor | None = None
    p_mu2: torch.Tensor | None = None
    p_log_var2: torch.Tensor | None = None
    d_mu2: torch.Tensor | None = None
    d_log_var2: torch.Tensor | None = None
    probs: torch.Tensor | None = None

    def replace(self, **changes) -> 'Outputs':
        return dataclasses.replace(self, **changes)
