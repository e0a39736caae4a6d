"""The item path of ``pccf/data/modelnet.py`` ``ModelNet40Split``
(``modelnet.py:46-111``), which the synthetic dataset's splits inherit.

The ModelNet40 reader itself (the h5 archive) is not ported: it waits for the
files and ``h5py`` (``ROADMAP.md``).  A batch is a pair of stacked tensors on
the run's device.  Training batches come from the batch assembler
(:mod:`pccf_torch.data.sampler`: resample, normalise, jitter, the shared
rotation and scale and translation), seeded from the split's numpy
generator, which the loader seeds anew by ``(seed, epoch, batch)``;
inference items are the stored clouds with their precomputed neighbour
indices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pccf_torch.data import sampler
from pccf_torch.data.augmentations import augment_clouds, jitter_cloud
from pccf_torch.data.protocols import PointCloudDataset
from pccf_torch.data.structures import Inputs, Targets
from pccf_torch.kernels import api


def index_k_neighbours(pcs: np.ndarray, k: int, device: torch.device, chunk: int = 64) -> np.ndarray:
    """The ``k`` nearest neighbours (self first) of every point of every
    cloud ``(N, P, 3)``, in chunks of 64 clouds on ``device`` (the kNN kernel
    on the card), as ``(N, P, k)`` int32 (``modelnet.py:29-43``)."""
    out = [api.knn(torch.from_numpy(pcs[i: i + chunk]).to(device), k).cpu().numpy()
           for i in range(0, pcs.shape[0], chunk)]
    return np.concatenate(out).astype(np.int32)


class ModelNet40Split(PointCloudDataset):
    """One partition: clouds ``pcd (N, P, 3)``, neighbour ``indices`` (or
    None), ``labels (N,)``, on the run's ``device``."""

    def __init__(self, pcd, indices, labels, cfg_data, seed: int = 0, device: torch.device | str = 'cpu') -> None:
        self.pcd = np.ascontiguousarray(pcd, np.float32)
        self.indices = indices
        self.labels = np.asarray(labels, np.int64)
        self.input_points = cfg_data.n_input_points
        self.resample = cfg_data.resample
        self.augment = augment_clouds(cfg_data)
        self.jitter = jitter_cloud(cfg_data)
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.device = torch.device(device)

    def __len__(self) -> int:
        return self.pcd.shape[0]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the run's device; to the card from pinned memory
        without waiting for the work queued before it."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == 'cuda' else t

    def __getitems__(self, idx_list: Sequence[int]) -> tuple[Inputs, Targets]:
        """A batch: from the assembler in training, the stacked items in inference."""
        labels = self._to_device(self.labels[list(idx_list)])
        if not self.inference:
            cloud, ref = sampler.assemble_batch_aug(
                self.device, self.pcd, np.asarray(idx_list, np.int64), self.input_points,
                seed=int(self.rng.integers(2**62)), jitter_sigma=self.jitter.sigma or 0.0,
                jitter_clip=self.jitter.clip or 0.0, resample=self.resample, rotate=self.augment.rotation,
                translate=self.augment.translation_and_scale)
            cloud, ref = self._to_device(cloud), self._to_device(ref)
            return Inputs(cloud), Targets(ref_cloud=ref, label=labels)
        items = [self.item(int(i)) for i in idx_list]
        cloud = self._to_device(np.stack([c for c, _ in items]))
        idx = None if items[0][1] is None else self._to_device(np.stack([i for _, i in items]))
        return Inputs(cloud, indices=idx), Targets(ref_cloud=cloud, label=labels)

    def item(self, index: int) -> tuple[np.ndarray, np.ndarray | None]:
        """An inference item: the stored cloud and its neighbour indices."""
        return self.pcd[index], None if self.indices is None else self.indices[index].astype(np.int32)
