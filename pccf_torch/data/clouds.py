"""A labelled set of point clouds held as tensors: the port's stand-in for the
JAX package's dataset classes (``pccf/data/modelnet.py``), which it does not
port yet.  The classifier's entry point trains on it and the evaluation
suites derive their datasets from it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pccf_torch.config import DataConfig
from pccf_torch.data import augmentations
from pccf_torch.data.structures import Inputs, Targets


class LabelledClouds:
    """Clouds ``(N, P, 3)`` with labels ``(N,)``; a batch is ``(Inputs(cloud),
    Targets(ref_cloud=cloud, label))`` on the clouds' device.

    In inference (``set_inference(True)``, how :class:`~pccf_torch.train.Loader`
    asks for evaluation batches) the clouds pass as they are.  In training,
    when ``data`` is given, each cloud is augmented on the host as
    ``pccf/data/modelnet.py:85-103`` does: ``data.n_input_points`` of its
    points drawn with replacement, normalised to the unit sphere, jittered,
    and rotated or scaled and translated as ``data`` says, with the numpy
    generator ``rng`` (which the loader seeds anew for every batch).
    ``seed`` is what derived datasets seed their noise from."""

    def __init__(self, clouds: torch.Tensor, labels: torch.Tensor, seed: int = 0,
                 data: DataConfig | None = None) -> None:
        if clouds.shape[0] != labels.shape[0]:
            raise ValueError(f'{clouds.shape[0]} clouds but {labels.shape[0]} labels')
        if data is not None and data.resample:
            raise ValueError('LabelledClouds: resampled reference clouds (data.resample) are not ported')
        self.clouds, self.labels, self.seed, self.data = clouds, labels.to(clouds.device).long(), seed, data
        self.inference = True
        self.rng = np.random.default_rng(seed)
        self._host = clouds.cpu().numpy() if data is not None else None

    def __len__(self) -> int:
        return self.clouds.shape[0]

    def set_inference(self, inference: bool) -> None:
        self.inference = inference

    def __getitems__(self, idx_list: Sequence[int]) -> tuple[Inputs, Targets]:
        idx = torch.as_tensor(idx_list, dtype=torch.long, device=self.clouds.device)
        if self.inference or self.data is None:
            cloud = self.clouds[idx]
        else:
            cloud = torch.from_numpy(np.stack([self._augmented(int(i)) for i in idx_list])).to(self.clouds.device)
        return Inputs(cloud), Targets(ref_cloud=cloud, label=self.labels[idx])

    def _augmented(self, i: int) -> np.ndarray:
        """``modelnet.py:89-101`` without ``resample``: the reference cloud
        is the input cloud."""
        pool = self._host[i]
        sampled = self.rng.choice(pool.shape[0], size=self.data.n_input_points, replace=True)
        cloud = augmentations.normalise(pool[sampled].copy())[0].astype(np.float32)
        cloud = augmentations.jitter_cloud(self.data)(self.rng, cloud)
        (cloud,) = augmentations.augment_clouds(self.data)(self.rng, [cloud])
        return cloud
