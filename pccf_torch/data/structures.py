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
    """Targets of the outer autoencoder: the reference cloud ``(B, M, 3)``
    (``pccf`` also carries the scale and label, which stage 1 does not read)."""

    ref_cloud: torch.Tensor


@dataclasses.dataclass
class WInputs:
    """Inputs of the inner (W) autoencoder."""

    w_q: torch.Tensor
    logits: torch.Tensor | None = None


@dataclasses.dataclass
class Outputs:
    """Outputs of the inner and outer autoencoder, filled along the path
    (the fields the serving and stage-1 training paths set; ``pccf`` has
    more)."""

    recon: torch.Tensor | None = None
    w: torch.Tensor | None = None
    w_q: torch.Tensor | None = None
    w_e: torch.Tensor | None = None
    w_recon: torch.Tensor | None = None
    w_dist_2: torch.Tensor | None = None
    idx: torch.Tensor | None = None
    one_hot_idx: torch.Tensor | None = None
    probs: torch.Tensor | None = None

    def replace(self, **changes) -> 'Outputs':
        return dataclasses.replace(self, **changes)
