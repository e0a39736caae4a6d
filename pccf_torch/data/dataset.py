"""Dataset getters (``pccf/data/dataset.py``): the split creator that
``data.dataset_name`` names (the ModelNet40 and ShapeNet readers or the
synthetic dataset), built once a process on the run's device, and the
(train, eval) pair with the ``final`` switch."""

from __future__ import annotations

import torch

from pccf_torch.data.protocols import Partitions, PointCloudDataset


def get_dataset(cfg, partition: Partitions, device: torch.device | str = 'cpu') -> PointCloudDataset:
    from pccf_torch.config import paths
    from pccf_torch.data.modelnet import ModelNet40Dataset
    from pccf_torch.data.shapenet import ShapeNetDatasetFlow
    from pccf_torch.data.synthetic import SyntheticDataset

    registry = {'ModelNet': ModelNet40Dataset, 'ShapenetFlow': ShapeNetDatasetFlow, 'Synthetic': SyntheticDataset}
    name = cfg.data.dataset_name
    if name not in registry:
        raise ValueError(f'unknown dataset {name!r}; choose from {sorted(registry)}')
    paths().data_dir.mkdir(parents=True, exist_ok=True)
    return registry[name](cfg, device).split(partition)


def get_datasets(cfg, device: torch.device | str = 'cpu') -> tuple[PointCloudDataset, PointCloudDataset]:
    """``final`` trains on train + val and evaluates on test, else train and val."""
    train = get_dataset(cfg, Partitions.train_val if cfg.final else Partitions.train, device)
    test = get_dataset(cfg, Partitions.test if cfg.final else Partitions.val, device)
    return train, test
