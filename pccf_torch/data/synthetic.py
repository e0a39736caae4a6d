"""Synthetic point clouds, numpy only: the fixed shapes of
``pccf/data/synthetic.py:23-70`` (``variability=0``), normalised as
``pccf/data/augmentations.py:16-26`` does.  The JAX package's data modules
import flax and jax through ``pccf/data/__init__.py``; the port keeps this
copy so that a run on the card can make a batch from a seed.
"""

from __future__ import annotations

import numpy as np

N_KINDS = 4  # sphere, box, torus, cylinder


def shape_cloud(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
    """``(n, 3)`` float32 surface sample of the class ``kind``, with the same
    draws from ``rng`` as ``pccf.data.synthetic._shape_cloud``."""
    u = rng.random(n) * 2 * np.pi
    v = rng.random(n)
    if kind % N_KINDS == 0:  # sphere
        phi = np.arccos(2 * v - 1)
        pts = np.stack([np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u), np.cos(phi)], 1)
    elif kind % N_KINDS == 1:  # box surface
        pts = rng.random((n, 3)) * 2 - 1
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), face] = sign
    elif kind % N_KINDS == 2:  # torus
        w = rng.random(n) * 2 * np.pi
        r, rr = 1.0, 0.35
        pts = np.stack([(r + rr * np.cos(w)) * np.cos(u), (r + rr * np.cos(w)) * np.sin(u), rr * np.sin(w)], 1)
    else:  # cylinder
        height = 2 * v - 1
        pts = np.stack([np.cos(u), np.sin(u), height], 1)
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
