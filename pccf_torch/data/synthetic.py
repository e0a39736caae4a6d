"""Synthetic point clouds, numpy only (``pccf/data/synthetic.py``): the
parametric shapes of each class, their split creator and splits.  The JAX
package's data modules pull in flax and jax through ``pccf/data/__init__.py``;
the port keeps this copy so that a run on the card can make its data from a
seed.  A split's training item path is that of
:class:`~pccf_torch.data.modelnet.ModelNet40Split` (the batch assembler);
inference normalises the cloud cut to ``n_input_points``.
"""

from __future__ import annotations

import numpy as np
import torch

from pccf_torch.data import augmentations
from pccf_torch.data.modelnet import ModelNet40Split, index_k_neighbours
from pccf_torch.data.protocols import Partitions, SplitCreator

N_KINDS = 4  # sphere, box, torus, cylinder


def shape_cloud(rng: np.random.Generator, kind: int, n: int, variability: float = 0.0) -> np.ndarray:
    """``(n, 3)`` float32 surface sample of the class ``kind``, with the same
    draws from ``rng`` as ``pccf.data.synthetic._shape_cloud``;
    ``variability`` in [0, 1] draws per-instance shape parameters."""
    u = rng.random(n) * 2 * np.pi
    v = rng.random(n)
    if kind % N_KINDS == 0:  # sphere -> ellipsoid
        phi = np.arccos(2 * v - 1)
        pts = np.stack([np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u), np.cos(phi)], 1)
        if variability:
            pts = pts * (1.0 - 0.45 * variability * rng.random(3))
    elif kind % N_KINDS == 1:  # box surface
        pts = rng.random((n, 3)) * 2 - 1
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), face] = sign
        if variability:
            pts = pts * (1.0 - 0.5 * variability * rng.random(3))
    elif kind % N_KINDS == 2:  # torus
        w = rng.random(n) * 2 * np.pi
        r, rr = 1.0, 0.35
        if variability:
            rr = 0.35 + variability * rng.uniform(-0.15, 0.25)
        pts = np.stack([(r + rr * np.cos(w)) * np.cos(u), (r + rr * np.cos(w)) * np.sin(u), rr * np.sin(w)], 1)
        if variability:
            pts[:, 2] *= 1.0 + variability * rng.uniform(-0.3, 1.0)
    else:  # cylinder -> cone
        radius = np.ones(n)
        height = 2 * v - 1
        if variability:
            taper = variability * rng.uniform(0.0, 0.8)
            radius = 1.0 - taper * (height + 1.0) / 2.0
            height = height * (1.0 + variability * rng.uniform(-0.4, 0.4))
        pts = np.stack([radius * np.cos(u), radius * np.sin(u), height], 1)
    pts = pts + 0.02 * rng.standard_normal((n, 3))
    return pts.astype(np.float32)


def normalise(cloud: np.ndarray) -> np.ndarray:
    """Centre and scale to the unit sphere (a single point stays at the origin)."""
    cloud = cloud - cloud.mean(axis=0)
    radius = float(np.max(np.sqrt(np.sum(cloud**2, axis=1))))
    return cloud / (radius if radius > 0.0 else 1.0)


def batch(seed: int, size: int, n_points: int) -> np.ndarray:
    """``(size, n_points, 3)`` normalised clouds cycling through the four
    kinds, from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return np.stack([normalise(shape_cloud(rng, i, n_points)) for i in range(size)]).astype(np.float32)


class SyntheticSplit(ModelNet40Split):
    """A partition of the synthetic dataset: training batches as
    :class:`ModelNet40Split`'s, inference items normalised from the cloud's
    first ``n_input_points`` points."""

    def item(self, index: int) -> tuple[np.ndarray, np.ndarray | None]:
        cloud = augmentations.normalise(self.pcd[index][: self.input_points].copy())[0].astype(np.float32)
        return cloud, None if self.indices is None else self.indices[index]


class SyntheticDataset(SplitCreator):
    """The split creator of ``data/dataset=synthetic``: ``settings`` keys
    ``n_train``, ``n_test``, ``base_points`` and ``variability``; train,
    val (half the test count, at least one cloud a class), test, and
    train_val their union, the clouds drawn from one generator seeded 12345
    in that order.  The val and test splits carry neighbour indices made on
    ``device``, once a partition."""

    def __init__(self, cfg, device: torch.device | str = 'cpu') -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        data = cfg.data
        n_classes = data.n_classes
        if n_classes > N_KINDS:
            raise ValueError(f'synthetic dataset has {N_KINDS} distinct shape kinds; n_classes={n_classes} would '
                             f'alias labels to identical shapes')
        n_train = int(data.setting('n_train', 64))
        n_test = int(data.setting('n_test', 32))
        base_points = int(data.setting('base_points', max(2048, data.n_input_points)))
        variability = float(data.setting('variability', 0.0))
        rng = np.random.default_rng(12345)
        self.data: dict[Partitions, tuple[np.ndarray, np.ndarray]] = {}
        counts = {Partitions.train: n_train, Partitions.val: max(n_test // 2, n_classes), Partitions.test: n_test}
        for part, count in counts.items():
            clouds = np.stack([shape_cloud(rng, i % n_classes, base_points, variability) for i in range(count)])
            self.data[part] = (clouds, np.asarray([i % n_classes for i in range(count)], np.int64))
        self.data[Partitions.train_val] = (
            np.concatenate([self.data[Partitions.train][0], self.data[Partitions.val][0]]),
            np.concatenate([self.data[Partitions.train][1], self.data[Partitions.val][1]]))
        self._index_cache: dict[Partitions, np.ndarray] = {}

    def split(self, split: Partitions) -> SyntheticSplit:
        clouds, labels = self.data[split]
        n_in, k = self.cfg.data.n_input_points, self.cfg.data.n_neighbors
        indices = None
        if split in (Partitions.val, Partitions.test):
            if split not in self._index_cache:
                normed = np.stack([augmentations.normalise(c[:n_in].copy())[0] for c in clouds]).astype(np.float32)
                self._index_cache[split] = index_k_neighbours(normed, k, self.device)
            indices = self._index_cache[split]
        return SyntheticSplit(clouds, indices, labels, self.cfg.data, seed=self.cfg.user.seed or 0,
                              device=self.device)
