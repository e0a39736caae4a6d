"""Cloud augmentations, numpy only: a copy of ``pccf/data/augmentations.py``
(which the JAX package's data modules reach through ``pccf/data/__init__.py``,
importing flax and jax), held against it by
``tests/test_torch_port_classifier.py``.  They run on the host while a
training batch is assembled, with an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
from numpy import typing as npt


def normalise(cloud: npt.NDArray[Any]) -> tuple[npt.NDArray[Any], float]:
    """Center and scale to the unit sphere (augmentations.py:13-18).

    A degenerate cloud (all points identical) has zero radius; keep it at the
    origin instead of dividing by zero — mirrors the native assembler's guard
    (cloud_sampler.cpp ``max_r2 > 0``)."""
    cloud = cloud - cloud.mean(axis=0)
    std = float(np.max(np.sqrt(np.sum(cloud**2, axis=1))))
    if std == 0.0:
        std = 1.0
    return cloud / std, std


def jitter(
    rng: np.random.Generator, cloud: npt.NDArray[Any], sigma: float = 0.01, clip: float = 0.02
) -> npt.NDArray[Any]:
    """Clipped Gaussian coordinate noise (augmentations.py:21-26)."""
    noise = np.clip(rng.standard_normal(cloud.shape) * sigma, -clip, clip)
    return (cloud + noise).astype(cloud.dtype)


def random_rotation_matrix(rng: np.random.Generator) -> npt.NDArray[Any]:
    """2D rotation in the x-z plane (about y; augmentations.py:29-42)."""
    theta = 2.0 * np.pi * rng.random()
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s], [s, c]], dtype=np.float32)


def apply_rotation(cloud: npt.NDArray[Any], rot: npt.NDArray[Any]) -> npt.NDArray[Any]:
    new = cloud.copy()
    new[:, [0, 2]] = cloud[:, [0, 2]] @ rot
    return new


def random_scale_translate_params(rng: np.random.Generator) -> tuple[npt.NDArray, npt.NDArray]:
    """Per-axis scale in [2/3, 3/2] and translation in [-0.2, 0.2]
    (augmentations.py:45-56)."""
    scale = (rng.random((1, 3)) * 5 / 6 + 2 / 3).astype(np.float32)
    translate = (rng.random((1, 3)) * 0.4 - 0.2).astype(np.float32)
    return scale, translate


class CloudAugmenter:
    """Shared random rotation/scale/translation applied to a cloud group
    (the input and reference clouds get the *same* transform,
    augmentations.py:59-76)."""

    def __init__(self, rotation: bool, translation_and_scale: bool):
        self.rotation = rotation
        self.translation_and_scale = translation_and_scale

    def __call__(
        self, rng: np.random.Generator, clouds: list[npt.NDArray[Any]]
    ) -> list[npt.NDArray[Any]]:
        if self.rotation:
            rot = random_rotation_matrix(rng)
            clouds = [apply_rotation(c, rot) for c in clouds]
        if self.translation_and_scale:
            scale, translate = random_scale_translate_params(rng)
            clouds = [(c * scale + translate).astype(np.float32) for c in clouds]
        return clouds


class CloudJitterer:
    """Optional jitter (augmentations.py:79-90)."""

    def __init__(self, jitter_sigma: float | None, jitter_clip: float | None):
        self.sigma = jitter_sigma
        self.clip = jitter_clip

    def __call__(self, rng: np.random.Generator, cloud: npt.NDArray[Any]) -> npt.NDArray[Any]:
        if self.sigma and self.clip:
            return jitter(rng, cloud, self.sigma, self.clip)
        return cloud


def augment_clouds(cfg_data) -> CloudAugmenter:
    return CloudAugmenter(rotation=cfg_data.rotate, translation_and_scale=cfg_data.translate)


def jitter_cloud(cfg_data) -> CloudJitterer:
    return CloudJitterer(jitter_sigma=cfg_data.jitter_sigma, jitter_clip=cfg_data.jitter_clip)
